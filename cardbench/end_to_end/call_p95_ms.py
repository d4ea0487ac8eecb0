"""``call_p95_ms``: the 95th percentile over every call of the window of
its latency from enqueue until the output is ready, read from CUDA events
on the card (a call is far shorter than the host clock resolves)."""

import numpy as np


def read(rec):
    lat = [j["latency_s"] for j in rec.jobs if j["clock"] == "device"]
    if not lat or len(lat) != len(rec.jobs):
        return None
    return float(np.percentile(lat, 95)) * 1e3

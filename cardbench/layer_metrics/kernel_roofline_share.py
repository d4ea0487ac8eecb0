"""``kernel.roofline_share``: the least time the card could take for the
filter work of the window (``cardbench/roofline.py``, at the
configuration's B and hop) over the device time of the kernels the
profiler places inside the harness's spans around the program's filter
entry. Attributed by span, not by kernel name."""

from .. import roofline
from ..trace import covered, union


def read(rec):
    if rec.trace is None:
        return None
    cfg = rec.cfg
    bound = ops = nbytes = device = 0.0
    for s in rec.spans_named("filter"):
        kernels = rec.trace.kernels_in(s["label"])
        if not kernels:
            continue
        merged = union(kernels)
        device += covered(merged, merged[0][0], merged[-1][1]) / 1e6
        r = roofline.bound(s["channels"], s["frames"], s["sample_bytes"],
                           cfg["block_size"], cfg["hop"], cfg["precision"])
        bound += r["bound_s"]
        ops += r["ops_s"]
        nbytes += r["bytes_s"]
    if device <= 0:
        return None
    by = "operations" if ops >= nbytes else "bytes"
    return {"value": 100.0 * bound / device,
            "note": f"bound by {by} ({ops:.6f} s of operations, {nbytes:.6f} s "
                    f"of bytes, kernels {device:.6f} s)"}

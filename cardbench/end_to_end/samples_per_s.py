"""``samples_per_s``: every audio sample (frames x channels) of every job
the window completed, over the window's host-clock seconds."""


def read(rec):
    if not rec.jobs or rec.window_s <= 0:
        return None
    return sum(j["samples"] for j in rec.jobs) / rec.window_s

"""``setup_s``: host-clock seconds from the process's start to the first
timed job: imports, the card, the inputs, kernel builds or loads, warm-up."""


def read(rec):
    return rec.setup_s

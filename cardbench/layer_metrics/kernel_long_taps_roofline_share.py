"""``kernel.long_taps_roofline_share``: the share of its roofline that the
segment kernel reaches in the cell of the long filter (76,801 taps,
``long96k.device``), computed as ``kernel.roofline_share`` computes it:
``cardbench/roofline.py`` at the configuration's B and hop over the
device time of the kernels launched inside the harness's spans around the
filter call. So it reads the same work whatever B or split the program
runs. It reads only where the program's launch spans say which split
they ran (``_segment_passes``), and its note gives that split, pass 1's
ring depth and each pass's device us a pair over the window."""

from . import _segment_passes as sp
from . import kernel_roofline_share


def read(rec):
    ls = sp.launches(rec)
    got = kernel_roofline_share.read(rec)
    if not ls or got is None:
        return None
    per = sp.us_per_pair(ls)
    passes = ", ".join(f"{p} {per[p]:.4f}" for p in sp.PASSES) if per else "no pairs"
    return {"value": got["value"],
            "note": f"split {sp.split_note(ls)}; us a pair: {passes}; {got['note']}"}

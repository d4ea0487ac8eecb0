"""``segment.cols_us_per_pair``: the device time of the segment kernel's
column passes (kernels named ``cols_forward*`` and ``cols_inverse*``)
launched inside each of the program's ``segment.launch`` spans, over the
pairs that span says it filtered (``pairs``), as the median over the
window's calls (``_segment_passes``). Read in every cell, so a change to
the 512-point columns shows beside what it does to the 1024-point ones.
The note names the split each call ran. Nothing to read (None) where the
launch spans carry no ``pairs``."""

from . import _program_spans as ps
from . import _segment_passes as sp


def read(rec):
    ls = [s for s in sp.launches(rec)
          if s["info"]["pairs"] and ("cols_forward" in s["passes"]
                                     or "cols_inverse" in s["passes"])]
    if not ls:
        return None
    each = [(s["passes"].get("cols_forward", 0.0) + s["passes"].get("cols_inverse", 0.0))
            / s["info"]["pairs"] for s in ls]
    per = sp.us_per_pair(ls)
    return {"value": ps.median(each),
            "note": f"split {sp.split_note(ls)}; {len(ls)} calls of "
                    f"{'/'.join(map(str, sorted({s['info']['pairs'] for s in ls})))} "
                    f"pairs; window's us a pair: cols_forward "
                    f"{per['cols_forward']:.4f}, cols_inverse {per['cols_inverse']:.4f}"}

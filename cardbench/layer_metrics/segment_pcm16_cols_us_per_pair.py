"""``segment.pcm16_cols_us_per_pair``: the device time of the segment
kernel's column passes in its i16 mode (kernels named ``cols_forward*``
and ``cols_inverse*``, the two passes that read and write int16 PCM)
launched inside each of the program's ``segment.launch`` spans whose
``mode`` is ``i16``, over the pairs that span says it filtered, as the
median over the window's calls (``_segment_passes``). Nothing to read
(None) where no launch span says it ran the i16 mode. The note gives the
split and the row pass's us a pair beside the columns'."""

from . import _program_spans as ps
from . import _segment_passes as sp


def read(rec):
    ls = [s for s in sp.launches(rec)
          if s["info"].get("mode") == "i16" and s["info"]["pairs"]
          and ("cols_forward" in s["passes"] or "cols_inverse" in s["passes"])]
    if not ls:
        return None
    each = [(s["passes"].get("cols_forward", 0.0) + s["passes"].get("cols_inverse", 0.0))
            / s["info"]["pairs"] for s in ls]
    per = sp.us_per_pair(ls)
    return {"value": ps.median(each),
            "note": f"split {sp.split_note(ls)}; {len(ls)} calls of "
                    f"{'/'.join(map(str, sorted({s['info']['pairs'] for s in ls})))} "
                    f"pairs; window's us a pair: cols_forward "
                    f"{per['cols_forward']:.4f}, cols_inverse {per['cols_inverse']:.4f}, "
                    f"rows_multiply {per['rows_multiply']:.4f}"}

"""``segment.rows_us_per_pair``: the device time of the segment kernel's
row pass (kernels whose name contains ``rows_multiply``: the one-CTA-an-item
pass and its persistent form with a load-ahead ring) launched inside each
of the program's ``segment.launch`` spans, over the pairs that span says it
filtered (``pairs``), as the median over the window's calls
(``_segment_passes``). Read in every cell. The note names the split and
the pass-2 ring depth each call ran (``pass2_ring``; "not reported" for a
program whose launch spans do not carry it). Nothing to read (None) where
the launch spans carry no ``pairs``."""

from . import _program_spans as ps
from . import _segment_passes as sp


def read(rec):
    ls = [s for s in sp.launches(rec)
          if s["info"]["pairs"] and "rows_multiply" in s["passes"]]
    if not ls:
        return None
    each = [s["passes"]["rows_multiply"] / s["info"]["pairs"] for s in ls]
    ran = sorted({(s["info"].get("log_n1"), s["info"].get("log_n2"),
                   s["info"].get("pass2_ring", "not reported")) for s in ls},
                 key=str)
    return {"value": ps.median(each),
            "note": "split " + ", ".join(f"{a}x{b} (pass 2 ring {r})" for a, b, r in ran)
                    + f"; {len(ls)} calls of "
                    f"{'/'.join(map(str, sorted({s['info']['pairs'] for s in ls})))} "
                    f"pairs; window's us a pair: rows_multiply "
                    f"{sp.us_per_pair(ls)['rows_multiply']:.4f}"}

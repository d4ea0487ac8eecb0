"""``kernel.pcm16_roofline_share``: the share of its roofline that the
segment kernel's i16 mode reaches in the cell of 16-bit PCM
(``cd44k.pcm16``), computed as ``kernel.roofline_share`` computes it:
``cardbench/roofline.py`` at the harness span's ``sample_bytes`` (2: int16
in and out) and the configuration's B and hop, over the device time of
the kernels launched inside the harness's spans around the filter call.
It reads only where the program's launch spans say they ran the i16 mode
(``mode``, ``_segment_passes``), so a program that converted the input to
float reads nothing; its note gives the split, the bound's kind and each
pass's device us a pair over the window."""

from . import _segment_passes as sp
from . import kernel_roofline_share


def read(rec):
    ls = [s for s in sp.launches(rec) if s["info"].get("mode") == "i16"]
    got = kernel_roofline_share.read(rec)
    if not ls or got is None:
        return None
    per = sp.us_per_pair(ls)
    passes = ", ".join(f"{p} {per[p]:.4f}" for p in sp.PASSES) if per else "no pairs"
    return {"value": got["value"],
            "note": f"split {sp.split_note(ls)}; us a pair: {passes}; {got['note']}"}

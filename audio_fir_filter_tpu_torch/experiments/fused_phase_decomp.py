"""The block kernel with its phases switched off, on the card.

Counterpart of ``experiments/fused_phase_decomp.py`` (``make_variant``, the
``pallas_call`` at :152), which timed the fused Pallas conv kernel with
phases disabled on 128 real blocks at B = 2^18 and 38,401 random taps.
Here ``csrc/probe_phases.cu`` launches the shipped passes
(``csrc/conv_blocks.cuh``, ``csrc/fourstep.cuh``) with their ablation
switches, on the same shape, in f32 and f64 (the TPU's df64 is not carried
over). TPU variant -> card variant, and its defined output:

- ``full`` -> passes 1, 2, 3 as shipped: the block convolution (plain:
  ``ops.conv_blocks.reference``);
- ``ac_only`` (phases A and C) -> passes 1 and 3 with their arithmetic and
  no pass 2: twiddle times conjugate twiddle is 1 and the inverse is
  unscaled by N1 but scaled by 1/B, so x / N2 (plain: ``x / N2``);
- ``b_only`` (phase B) -> pass 2 only, passes 1 and 3 a pure gather and
  scatter (no twiddle, no FFT, no 1/B): each length-N2 row of each pair's
  [N1, N2] view circularly convolved with its row of H, times N2 (plain:
  ``torch.fft`` along the rows, with H's bit-reversed columns undone);
- ``no_tr`` (the plane transposes removed) -> passes 1 and 3 store and
  load each column tile as one contiguous run instead of column-strided:
  the same operations, a defined permutation, not a convolution (plain:
  the same permutation as a ``reshape``/``permute`` between the passes'
  plain versions);
- ``copy`` (pack, store, load, unpack) -> passes 1 and 3 with no arithmetic
  and no pass 2: the identity (plain: ``x.clone()``).

The differences give: pass 2 = full - ac_only, passes 1 + 3 arithmetic =
ac_only - copy, the strided layout = full - no_tr, and the copy floor of
the passes' data movement = copy.
"""

from __future__ import annotations

import torch

from ..ops import roofline
from ..ops import segment_filter as sf
from . import _probe
from . import pallas_micro as pm

VARIANTS = ("full", "no_tr", "ac_only", "b_only", "copy")
BLOCK = 1 << 18
NBLOCKS = 128

launches = {"probe_phases_f32": 0, "probe_phases_f64": 0}


def phases(blocks: torch.Tensor, H: torch.Tensor, variant: str) -> torch.Tensor:
    """blocks [nb (even), B] float32 through ``variant`` with the kernel-
    layout spectrum H ([N1, N2] complex64 for f32, complex128 for f64) ->
    [nb, B] float32. CUDA tensors run the kernel, CPU tensors
    :func:`reference`."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    pm.check_blocks(blocks, H)
    if not _probe.on_card(blocks, H):
        return reference(blocks, H, variant)
    out = torch.empty_like(blocks)
    scratch = torch.empty((blocks.shape[0] // 2, *H.shape), dtype=H.dtype,
                          device=H.device)
    pm.launch_phases(variant, H, blocks=blocks, out=out, scratch=scratch)
    launches[f"probe_phases_{pm.mode_of(H)}"] += 1
    return out


def tile_columns(b: int) -> int:
    """tc, the columns per CTA of passes 1 and 3 (``fourstep.cuh``
    ``Split::kTc``: 8 up to N1 = 512, fewer above, at most N2)."""
    l1, l2 = sf.split(b)
    return min(1 << l2, max(1, min(8, 4096 >> l1)))


def _tiles_contiguous(s: torch.Tensor, tc: int) -> torch.Tensor:
    """The scratch as pass 1 leaves it with kStrided off: tile t (columns
    [t * tc, +tc)) as one contiguous run, row-major within the tile."""
    p, n1, n2 = s.shape
    return s.reshape(p, n1, n2 // tc, tc).permute(0, 2, 1, 3).reshape(p, n1, n2)


def _tiles_strided(s: torch.Tensor, tc: int) -> torch.Tensor:
    """The inverse of :func:`_tiles_contiguous`."""
    p, n1, n2 = s.shape
    return s.reshape(p, n2 // tc, n1, tc).permute(0, 2, 1, 3).reshape(p, n1, n2)


def reference(blocks: torch.Tensor, H: torch.Tensor, variant: str) -> torch.Tensor:
    """The plain version of each variant (module docstring), in the
    precision of H."""
    from ..ops import conv_blocks as cb

    b = blocks.shape[1]
    if variant == "full":
        return cb.reference(blocks, pm.conv_plan(H))
    if variant == "copy":
        return blocks.clone()
    if variant == "ac_only":
        rdt = torch.float64 if pm.mode_of(H) == "f64" else torch.float32
        return (blocks.to(rdt) / H.shape[1]).to(torch.float32)
    if variant == "b_only":
        return pm.blocks_of(pm.k2_reference(pm.pairs_of(blocks, H.dtype), H))
    tc = tile_columns(b)
    s = _tiles_contiguous(pm.k1_reference(blocks, H), tc)
    return pm.k3_reference(_tiles_strided(pm.k2_reference(s, H), tc), H)


def verify(device="cuda") -> dict:
    """Every variant against its plain version at 128 blocks, B = 2^18:
    bitwise for ``copy``, the stated tolerance otherwise."""
    dev = _probe.card(device)
    x = pm.blocks_input(NBLOCKS, BLOCK, dev)
    errs = {}
    for cdt in (torch.complex64, torch.complex128):
        H = pm.spectrum(BLOCK, cdt, dev)
        mode = pm.mode_of(H)
        rel = _probe.REL_F64 if mode == "f64" else _probe.REL_F32
        e = 0.0
        for v in VARIANTS:
            e = max(e, _probe.expect(f"phases {mode} {v}", phases(x, H, v),
                                     reference(x, H, v),
                                     None if v == "copy" else rel))
        errs[f"probe_phases_{mode}"] = e
    torch.cuda.synchronize(dev)
    return errs


def run(device="cuda", reps: int = 5) -> dict:
    from ..ops import conv_blocks as cb

    dev = _probe.card(device)
    x = pm.blocks_input(NBLOCKS, BLOCK, dev)
    rows, kernels, lines = [], {}, []
    for cdt in (torch.complex64, torch.complex128):
        H = pm.spectrum(BLOCK, cdt, dev)
        mode = pm.mode_of(H)
        t = {v: _probe.event_ms(lambda v=v: phases(x, H, v), reps)
             for v in VARIANTS}
        plain = _probe.event_ms(lambda: cb.reference(x, pm.conv_plan(H)), reps)
        for v in VARIANTS:
            rows.append([mode, v, t[v], NBLOCKS * BLOCK / (t[v] * 1e-3) / 1e9])
        rows.append([mode, "plain (cuFFT)", plain,
                     NBLOCKS * BLOCK / (plain * 1e-3) / 1e9])
        lines.append(
            f"{mode}: pass 2 (full - ac_only) {t['full'] - t['ac_only']:.4f} ms,"
            f" passes 1+3 arithmetic (ac_only - copy) "
            f"{t['ac_only'] - t['copy']:.4f} ms, strided layout (full - no_tr) "
            f"{t['full'] - t['no_tr']:.4f} ms, copy floor {t['copy']:.4f} ms")
        # No one PyTorch call convolves blocks circularly: library_ms null.
        kernels[f"probe_phases_{mode}"] = {
            "ms": t["full"], "plain_ms": plain, "library_ms": None,
            **roofline.bound(2 * x.numel() * 4,
                             roofline.fft_conv_flops(BLOCK, NBLOCKS), mode)}
    head = _probe.table(
        f"phase ablations, {NBLOCKS} real blocks at B = 2^18, 38,401 random "
        f"taps (CUDA events, median of {reps})",
        ["mode", "variant", "ms", "Gsamples/s"], rows)
    return {"lines": head + lines, "kernels": kernels}


def main() -> None:
    verify()
    print("\n".join(run(reps=10)["lines"]))


if __name__ == "__main__":
    main()

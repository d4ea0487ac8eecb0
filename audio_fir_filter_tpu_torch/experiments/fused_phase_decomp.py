"""The block convolution with its phases switched off, on the card.

Counterpart of ``experiments/fused_phase_decomp.py`` (``make_variant``, the
``pallas_call`` at :152), which timed the fused Pallas conv kernel with
phases disabled on 128 real blocks at B = 2^18 and 38,401 random taps: one
kernel that reads a pair of blocks into VMEM once, keeps it there through
both transposes and every FFT, and writes it once.

**The fused kernel** (:func:`fused`, ``csrc/probe_phases.cu``
``fused_block``, the rows ``probe_phases_{f32,f64}``) is that design on
the card: one thread-block cluster (8 CTAs in f32, 16 in f64) holds one
real block in its shared memory from its single read to its single write,
with no device-memory scratch; the block is the complex sequence
z[n] = x[2n] + i x[2n+1] of M = B/2 points, transformed four-step as [512,
256] with the real-input split step folded into the spectrum's product
(:func:`fused_plan`). Its five variants are the TPU's switches, each with
a defined output and a plain version (:func:`fused_reference`):

- ``full``: the block convolution (plain: ``ops.conv_blocks.reference``);
- ``no_tr`` (the transposes removed): no exchange through distributed
  shared memory, each CTA runs the row phase on its own band as if it were
  its slab: the same operations, a defined permutation, not a convolution
  (plain: the same band-to-slab reinterpretation between the phases'
  plain versions, :func:`band_as_slab`);
- ``ac_only`` (phases A and C): the column phase and its inverse, x / N2
  (N2 = 256 at 2^18);
- ``b_only`` (phase B): the row phase only, columns moved with no
  arithmetic, exchanges kept (plain: :func:`rows_phase` on the natural
  rows);
- ``copy``: load and store only, the identity (plain: ``x.clone()``).

**The three-pass baselines** (:func:`phases`, the same switches on the
shipped block kernel's passes ``csrc/conv_blocks.cuh``,
``csrc/fourstep.cuh``; printed as ``passes full`` etc.): TPU variant ->
card variant, and its defined output:

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

The differences give: row phase (pass 2) = full - ac_only, column
arithmetic = ac_only - copy, the exchanges (strided layout) = full - no_tr,
and the copy floor of the data movement = copy. The sweep times both
families at the TPU probe's 128 blocks and at the bench headline's 2016
(1008 pairs), beside the copy floor's ``cluster`` and ``tr``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import roofline
from ..ops import segment_filter as sf
from . import _probe
from . import pallas_micro as pm

VARIANTS = ("full", "no_tr", "ac_only", "b_only", "copy")
BLOCK = 1 << 18
NBLOCKS = 128
# The two shapes of the sweep: the TPU probe's and the bench headline's
# (1008 pairs, nothing in the 50 MB L2).
SHAPES = (NBLOCKS, 2016)
# Variant ids of the fused kernel in csrc/probe_phases.cu (0-8: the passes).
FUSED_IDS = {v: 9 + i for i, v in enumerate(VARIANTS)}
# The fused kernel's cluster by mode (csrc Fused<T>): CTAs a block and
# threads a CTA; a CTA holds kCols = 256 / CTAs columns of the band in
# batches of kW = threads / 64, or kRows = 512 / CTAs rows of the slab.
CLUSTER = {"f32": 8, "f64": 16}
THREADS = {"f32": 256, "f64": 256}

launches = {"probe_phases_f32": 0, "probe_phases_f64": 0,
            "probe_phases_passes_f32": 0, "probe_phases_passes_f64": 0}


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
    launches[f"probe_phases_passes_{pm.mode_of(H)}"] += 1
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


# ---------------------------------------------------------- the fused block

@dataclass(frozen=True)
class FusedPlan:
    """What the fused kernel reads besides x: the M = B/2 point four-step
    tables (``tw4`` [N1, N2], ``sf.full_twiddle(M)``, which the kernel
    reads whole; ``w1``, ``w2`` of ``sf.kernel_tables(M)``) and
    ``ab`` [N1, N2, 2], the split step's alpha and beta at each bin's
    place; ``H`` is the kernel-layout spectrum they come from. At B = 2^18,
    ``ab_lanes`` is ``ab`` in the kernel's thread order, [512, 8, 32, 2]:
    register m of lane t holds column q = 8 t + m."""

    H: torch.Tensor
    ab: torch.Tensor
    tw4: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor
    ab_lanes: torch.Tensor | None = None

    @property
    def mode(self) -> str:
        return pm.mode_of(self.H)

    @property
    def block(self) -> int:
        return self.H.numel()


def fused_plan(H: torch.Tensor) -> FusedPlan:
    """The fused kernel's tables for the kernel-layout spectrum H of B
    points (``pm.spectrum``), on H's device in H's precision: laid out once
    on the host in float64, like a twiddle table."""
    b = H.numel()
    pm.check_spectrum(H, b)
    if b < 8:
        raise ValueError(f"the fused block needs B >= 8, got {b}")
    m = b // 2
    tw4 = sf.full_twiddle(m, H.dtype, H.device)
    _, w1, w2 = sf.kernel_tables(m, H.dtype, H.device)
    hn = sf.natural_spectrum(H.detach().to("cpu", torch.complex128)).numpy()
    ab = split_coefficients(hn)[_bin_index(m)]
    lanes = None
    if b == BLOCK:
        lanes = ab.reshape(512, 32, 8, 2).transpose(0, 2, 1, 3)
        lanes = torch.from_numpy(np.ascontiguousarray(lanes)).to(H.device, H.dtype)
    return FusedPlan(H=H, ab=torch.from_numpy(ab).to(H.device, H.dtype),
                     tw4=tw4, w1=w1, w2=w2, ab_lanes=lanes)


def split_coefficients(hn: np.ndarray) -> np.ndarray:
    """[M, 2] complex: (alpha_k, beta_k) of the widely linear step that
    takes Z = FFT_M(z) of z[n] = x[2n] + i x[2n+1] to Zy = FFT_M(zy) of
    y = irfft(rfft(x) * hn): Zy[k] = alpha_k Z[k] + beta_k conj(Z[M - k]).
    With S = (hn[k] + conj hn[M-k]) / 2, D = (hn[k] - conj hn[M-k]) / 2 and
    theta = 2 pi k / B: alpha = S - D sin(theta), beta = i D cos(theta)
    (the split step, the product and the inverse split composed;
    :func:`split_forward`, :func:`split_inverse`)."""
    m = len(hn) - 1
    k = np.arange(m)
    hk, hmk = hn[k], np.conj(hn[m - k])
    s_, d_ = (hk + hmk) / 2, (hk - hmk) / 2
    th = np.pi * k / m
    return np.stack([s_ - d_ * np.sin(th), 1j * d_ * np.cos(th)], axis=-1)


def split_forward(Z: torch.Tensor) -> torch.Tensor:
    """[..., M] FFT of z[n] = x[2n] + i x[2n+1] -> rfft(x) [..., M + 1]:
    X[k] = (Z[k] + conj Z[M-k]) / 2 - i W^k (Z[k] - conj Z[M-k]) / 2,
    W = exp(-2 pi i / 2M), Z[M] = Z[0]."""
    m = Z.shape[-1]
    k = torch.arange(m + 1, device=Z.device)
    zk = Z[..., k % m]
    zc = Z[..., (m - k) % m].conj()
    w = torch.exp(-1j * torch.pi * k.to(torch.float64) / m).to(Z.dtype)
    return (zk + zc) / 2 - 1j * w * (zk - zc) / 2


def split_inverse(Y: torch.Tensor) -> torch.Tensor:
    """rfft-order [..., M + 1] -> [..., M], whose inverse FFT is
    y[2n] + i y[2n+1] of y = irfft(Y): Zy[k] = (Y[k] + conj Y[M-k]) / 2 +
    i W^-k (Y[k] - conj Y[M-k]) / 2."""
    m = Y.shape[-1] - 1
    k = torch.arange(m, device=Y.device)
    yk, yc = Y[..., k], Y[..., m - k].conj()
    w = torch.exp(1j * torch.pi * k.to(torch.float64) / m).to(Y.dtype)
    return (yk + yc) / 2 + 1j * w * (yk - yc) / 2


@functools.lru_cache(maxsize=8)
def _bin_index(m: int) -> np.ndarray:
    """[N1, N2]: the bin k = k1 + N1 k2 that place (p, q) of the M-point
    four-step holds (k1 = bitrev(p), k2 = bitrev(q))."""
    l1, l2 = sf.split(m)
    return sf._bitrev(l1)[:, None] + (1 << l1) * sf._bitrev(l2)[None, :]


@functools.lru_cache(maxsize=8)
def _partner_np(m: int) -> np.ndarray:
    """Flat place of bin M - k (mod M) for each flat place (p, q) of bin k."""
    l1, l2 = sf.split(m)
    k = _bin_index(m)
    kp = (m - k) % m
    n1 = 1 << l1
    return (sf._bitrev(l1)[kp % n1] * (m // n1) + sf._bitrev(l2)[kp // n1]).ravel()


def _z(blocks: torch.Tensor, rdt: torch.dtype) -> torch.Tensor:
    """[nb, B] real -> [nb, N1, N2] complex z[n] = x[2n] + i x[2n+1]."""
    nb, b = blocks.shape
    return torch.view_as_complex(
        blocks.to(rdt).reshape(nb, *sf.split_shape(b // 2), 2).contiguous())


def _real(z: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(z).reshape(z.shape[0], -1).to(torch.float32)


def cols_forward(z: torch.Tensor, plan: FusedPlan) -> torch.Tensor:
    """Phase A: the length-N1 column FFTs (rows left bit-reversed) times
    the four-step twiddle."""
    l1 = sf.split(plan.block // 2)[0]
    return torch.fft.fft(z, dim=1)[:, pm._bitrev(l1, z.device), :] * plan.tw4


def cols_inverse(z: torch.Tensor, plan: FusedPlan) -> torch.Tensor:
    """Phase C: times the conjugate twiddle, the inverse column FFTs
    (bit-reversed rows in, natural out), scaled by 1/M."""
    m = plan.block // 2
    l1 = sf.split(m)[0]
    n1 = 1 << l1
    y = (z * plan.tw4.conj())[:, pm._bitrev(l1, z.device), :]
    return torch.fft.ifft(y, dim=1) * (n1 / m)


def rows_phase(z: torch.Tensor, plan: FusedPlan) -> torch.Tensor:
    """Phase B on [nb, N1, N2] whose row p is the four-step's row p: the
    row FFTs (columns bit-reversed), Zy = alpha Z + beta conj(Z at M - k)
    from ``plan.ab``, the unscaled inverse row FFTs (natural order)."""
    nb, n1, n2 = z.shape
    l2 = sf.split(plan.block // 2)[1]
    br2 = pm._bitrev(l2, z.device)
    zf = torch.fft.fft(z, dim=2)[:, :, br2].reshape(nb, -1)
    partner = torch.from_numpy(_partner_np(n1 * n2)).to(z.device)
    ab = plan.ab.reshape(-1, 2)
    zy = ab[:, 0] * zf + ab[:, 1] * zf[:, partner].conj()
    return torch.fft.ifft(zy.reshape(nb, n1, n2)[:, :, br2], dim=2) * n2


def prow(mode: str, r: int, j: int) -> int:
    """Row of the 512 that slab row j of CTA r holds (csrc ``prow``)."""
    rows = 512 // CLUSTER[mode]
    if r == 0:
        return j
    h = 1 << (r.bit_length() - 1)
    g, cl = rows * h, r - h
    return g + cl * (rows // 2) + j if j < rows // 2 else (
        2 * g - rows - cl * (rows // 2) + j)


@functools.lru_cache(maxsize=4)
def _slab_rows(mode: str) -> np.ndarray:
    """[512]: the row prow(r, j) of slab row r * kRows + j."""
    c = CLUSTER[mode]
    return np.array([prow(mode, r, j) for r in range(c) for j in range(512 // c)])


def band_as_slab(z: torch.Tensor, mode: str, inverse: bool = False) -> torch.Tensor:
    """``no_tr``'s permutation at B = 2^18: CTA r's band (columns [kCols r,
    +kCols) of z [nb, 512, 256], held as kCols / kW batch regions
    [512][kW]) read as its slab [kRows][256], each slab row placed at the
    row prow(r, j) whose tables the row phase gives it. ``inverse``: the
    other way."""
    c, w = CLUSTER[mode], THREADS[mode] // 64
    nbat = 256 // c // w
    nb = z.shape[0]
    rows = torch.from_numpy(_slab_rows(mode)).to(z.device)
    if not inverse:
        bands = z.reshape(nb, 512, c, nbat, w).permute(0, 2, 3, 1, 4)
        out = torch.empty_like(z)
        out[:, rows] = bands.reshape(nb, 512, 256)
        return out
    bands = z[:, rows].reshape(nb, c, nbat, 512, w).permute(0, 3, 1, 2, 4)
    return bands.reshape(nb, 512, 256)


def fused_reference(blocks: torch.Tensor, plan: FusedPlan,
                    variant: str) -> torch.Tensor:
    """The plain version of each fused variant (module docstring), in the
    plan's precision; ``no_tr`` at B = 2^18 only (the kernel's layout)."""
    from ..ops import conv_blocks as cb

    if variant not in FUSED_IDS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if variant == "full":
        return cb.reference(blocks, pm.conv_plan(plan.H))
    if variant == "copy":
        return blocks.clone()
    rdt = torch.float64 if plan.mode == "f64" else torch.float32
    n2 = sf.split_shape(plan.block // 2)[1]
    if variant == "ac_only":
        return (blocks.to(rdt) / n2).to(torch.float32)
    z = _z(blocks, rdt)
    if variant == "b_only":
        return _real(rows_phase(z, plan))
    if plan.block != BLOCK:
        raise ValueError(f"no_tr's layout is the kernel's, B = 2^18; got "
                         f"B = {plan.block}")
    s = band_as_slab(cols_forward(z, plan), plan.mode)
    s = band_as_slab(rows_phase(s, plan), plan.mode, inverse=True)
    return _real(cols_inverse(s, plan))


def check_fused(blocks: torch.Tensor, plan: FusedPlan) -> None:
    if (blocks.dtype != torch.float32 or blocks.dim() != 2
            or blocks.shape[0] < 1 or not blocks.is_contiguous()
            or blocks.shape[1] != plan.block):
        raise ValueError(f"blocks must be contiguous [nb >= 1, {plan.block}] "
                         f"float32, got {tuple(blocks.shape)} {blocks.dtype}")


def fused(blocks: torch.Tensor, plan: FusedPlan, variant: str) -> torch.Tensor:
    """blocks [nb, B] float32 through the fused kernel's ``variant`` ->
    [nb, B] float32. CUDA tensors launch ``fused_block`` (B = 2^18 only; no
    scratch is allocated), CPU tensors take :func:`fused_reference`."""
    if variant not in FUSED_IDS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    check_fused(blocks, plan)
    if not _probe.on_card(blocks, plan.H):
        return fused_reference(blocks, plan, variant)
    if plan.block != BLOCK:
        raise ValueError(f"the fused kernel takes B = 2^18, got {plan.block}")
    out = torch.empty_like(blocks)
    l1, l2 = sf.split(BLOCK // 2)
    _probe.launch("probe_phases", f"lowcut_probe_phases_{plan.mode}",
                  blocks.device, blocks.data_ptr(), out.data_ptr(),
                  plan.ab_lanes.data_ptr(), plan.tw4.data_ptr(), plan.w1.data_ptr(),
                  plan.w2.data_ptr(), None, blocks.shape[0], l1, l2,
                  FUSED_IDS[variant])
    launches[f"probe_phases_{plan.mode}"] += 1
    return out


def fused_occupancy(device="cuda") -> dict:
    """Per mode, ``cudaOccupancyMaxActiveClusters`` of the fused kernel
    and its registers and local-memory bytes a thread."""
    from ..ops import _build

    dev = _probe.card(device)
    out = (ctypes.c_int * 6)()
    fn = _build.library("probe_phases").lowcut_probe_fused_occupancy
    with torch.cuda.device(dev):
        rc = fn(None, ctypes.addressof(out), None, None, None, None, None, 0,
                0, 0, 0, None)
    if rc != 0:
        raise RuntimeError(f"lowcut_probe_fused_occupancy failed: CUDA error {rc}")
    return {mode: {"clusters": out[3 * i], "ctas": CLUSTER[mode] * out[3 * i],
                   "registers": out[3 * i + 1], "local_bytes": out[3 * i + 2]}
            for i, mode in enumerate(("f32", "f64"))}


def occupancy_line(occ: dict) -> str:
    return ("fused block occupancy (cudaOccupancyMaxActiveClusters): "
            + ", ".join(f"{m} {o['clusters']} clusters of {CLUSTER[m]} CTAs "
                        f"({o['ctas']} SMs), {o['registers']} registers, "
                        f"{o['local_bytes']} local bytes"
                        for m, o in occ.items()))


def _rel(mode: str) -> float:
    return _probe.REL_F64 if mode == "f64" else _probe.REL_F32


def verify(device="cuda") -> dict:
    """Every fused variant against its plain version at 128 and 2016
    blocks (bitwise for ``copy``), then every three-pass variant at 128;
    raises if a mode cannot keep one cluster resident."""
    dev = _probe.card(device)
    occ = fused_occupancy(dev)
    for mode, o in occ.items():
        if o["clusters"] < 1:
            raise RuntimeError(f"fused block {mode}: no cluster of "
                               f"{CLUSTER[mode]} CTAs can be resident")
    errs = {}
    for cdt in (torch.complex64, torch.complex128):
        plan = fused_plan(pm.spectrum(BLOCK, cdt, dev))
        mode = plan.mode
        e = 0.0
        for nb in SHAPES:
            x = pm.blocks_input(nb, BLOCK, dev)
            for v in VARIANTS:
                e = max(e, _probe.expect(
                    f"fused {mode} {v} nb={nb}", fused(x, plan, v),
                    fused_reference(x, plan, v),
                    None if v == "copy" else _rel(mode)))
            del x
        x = pm.blocks_input(NBLOCKS, BLOCK, dev)
        for v in VARIANTS:
            _probe.expect(f"passes {mode} {v}", phases(x, plan.H, v),
                          reference(x, plan.H, v),
                          None if v == "copy" else _rel(mode))
        errs[f"probe_phases_{mode}"] = e
        del x
    torch.cuda.synchronize(dev)
    return errs


def run(device="cuda", reps: int = 5) -> dict:
    """Times, at 128 and 2016 blocks, every fused variant, the three-pass
    ``full`` (all five at 128), the plain block convolution and, at 2016,
    the copy floor's ``cluster`` and ``tr`` on the same bytes. The rows
    ``probe_phases_*`` time the fused ``full`` at 128 blocks."""
    from ..ops import conv_blocks as cb
    from . import copy_floor_probe as cfp

    dev = _probe.card(device)
    occ = fused_occupancy(dev)
    rows, kernels, lines, times = [], {}, [], {}
    for nb in SHAPES:
        x = pm.blocks_input(nb, BLOCK, dev)
        nbytes = 2 * x.numel() * 4
        for cdt in (torch.complex64, torch.complex128):
            plan = fused_plan(pm.spectrum(BLOCK, cdt, dev))
            mode = plan.mode
            t = {f"fused {v}": _probe.event_ms(lambda v=v: fused(x, plan, v),
                                               reps) for v in VARIANTS}
            passes = VARIANTS if nb == NBLOCKS else ("full",)
            t.update({f"passes {v}": _probe.event_ms(
                lambda v=v: phases(x, plan.H, v), reps) for v in passes})
            t["plain (cuFFT)"] = _probe.event_ms(
                lambda: cb.reference(x, pm.conv_plan(plan.H)), reps)
            bound = roofline.bound(nbytes, roofline.fft_conv_flops(BLOCK, nb),
                                   mode)
            for name, ms in t.items():
                times[(mode, nb, name)] = ms
                rows.append([f"{mode} nb={nb}", name, ms,
                             _probe.gbps(nbytes, ms),
                             f"{bound['bound_ms'] / ms:.1%}"])
            lines.append(
                f"{mode} nb={nb}: row phase (full - ac_only) "
                f"{t['fused full'] - t['fused ac_only']:.4f} ms, column "
                f"arithmetic (ac_only - copy) "
                f"{t['fused ac_only'] - t['fused copy']:.4f} ms, exchanges "
                f"(full - no_tr) {t['fused full'] - t['fused no_tr']:.4f} ms, "
                f"copy floor {t['fused copy']:.4f} ms; three-pass full "
                f"{t['passes full']:.4f} ms")
            if nb == NBLOCKS:
                # No one PyTorch call convolves blocks circularly:
                # library_ms null.
                kernels[f"probe_phases_{mode}"] = {
                    "ms": t["fused full"], "plain_ms": t["plain (cuFFT)"],
                    "library_ms": None, **bound}
        if nb != NBLOCKS:
            xp = x.view(nb // 2, 2, 512, 512)
            for v in ("cluster", "tr"):
                ms = _probe.event_ms(lambda v=v: cfp.copy_floor(xp, v), reps)
                times[("f32", nb, f"copy floor {v}")] = ms
                rows.append([f"f32 nb={nb}", f"copy floor {v}", ms,
                             _probe.gbps(nbytes, ms), "-"])
        del x
    head = _probe.table(
        f"fused block and three-pass phase ablations, real blocks at B = "
        f"2^18, 38,401 random taps (CUDA events, median of {reps}); GB/s of "
        f"x and y; share of the bound",
        ["mode, shape", "variant", "ms", "GB/s", "share"], rows)
    return {"lines": head + lines + [occupancy_line(occ)], "kernels": kernels,
            "times": times, "occupancy": occ}


def main() -> None:
    verify()
    print("\n".join(run(reps=10)["lines"]))


if __name__ == "__main__":
    main()

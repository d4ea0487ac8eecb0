"""Each pass of the shipped four-step kernels alone, on the card.

Counterpart of ``experiments/pallas_micro.py`` (``tiled_call``, the
``pallas_call`` at :73), which timed the Pallas conv path pass by pass at
B = 2^19 with 4 complex rows (8 real blocks). Here the passes are the
block kernel's own (``csrc/conv_blocks.cuh`` ``pairs_forward`` /
``pairs_inverse``, ``csrc/fourstep.cuh`` ``rows_multiply``), launched one
at a time through ``csrc/probe_phases.cu``, in f32 and f64 (the TPU's
double-float arithmetic is not carried over; the port ships native f64):

- ``K1`` (pass-1 forward * T): :func:`k1`, blocks [2p, B] -> scratch
  [p, N1, N2]: column FFTs (rows left bit-reversed) * the four-step
  twiddle;
- ``K2`` (pass-2 forward * H * inverse): :func:`k2`, in place on the
  scratch; the inverse is unscaled;
- ``K2a`` (pass-2 forward only): :func:`k2a`, in place;
- ``K3`` (* conj T, pass-1 inverse): :func:`k3`, scratch -> blocks, with the
  1/B scale.

Each has a plain version written with ``torch.fft`` on the [N1, N2] view
in the kernel's bit-reversed order; the plain K3(K2(K1(x))) is
``ops.conv_blocks.reference``. The TPU's XLA transpose and XLA pass rows
have no counterpart: nothing on the card transposes. On the card the
probe's library instantiates B = 2^16 .. 2^20 only (the sweep's shapes; a
short build); another B raises, the plain versions take any.

The segment kernel's passes (``cols_forward`` and ``cols_inverse`` in
``csrc/segment_filter.cuh``, ``rows_multiply`` in ``csrc/fourstep.cuh``)
are timed from ``torch.profiler`` over the shipped launch at the main
path's shape (2 x 30 s at 96 kHz, B = 2^18, M = 38,400), f32 and f64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import roofline
from ..ops import segment_filter as sf
from . import _probe

PASSES = ("k1", "k2", "k2a", "k3")
# Variant ids of csrc/probe_phases.cu (fused_phase_decomp uses 0-4).
VARIANT_IDS = {"full": 0, "ac_only": 1, "b_only": 2, "no_tr": 3, "copy": 4,
               "k1": 5, "k2": 6, "k2a": 7, "k3": 8}
# Shapes of the sweep: (B, real blocks).
SHAPES = ((1 << 19, 8), (1 << 18, 128))
TAPS = 38401

launches = {"probe_passes_f32": 0, "probe_passes_f64": 0}


def mode_of(H: torch.Tensor) -> str:
    if H.dtype == torch.complex64:
        return "f32"
    if H.dtype == torch.complex128:
        return "f64"
    raise ValueError(f"H must be complex64 or complex128, got {H.dtype}")


def check_spectrum(H: torch.Tensor, b: int) -> None:
    mode_of(H)
    if b < 4 or b & (b - 1) or sf.split(b)[0] > sf._MAX_LOG_SIDE:
        raise ValueError(f"B must be a power of two in [4, 2^26], got {b}")
    if tuple(H.shape) != sf.split_shape(b) or not H.is_contiguous():
        raise ValueError(f"H must be contiguous {sf.split_shape(b)}, got "
                         f"{tuple(H.shape)}")


def check_blocks(blocks: torch.Tensor, H: torch.Tensor) -> None:
    if (blocks.dtype != torch.float32 or blocks.dim() != 2
            or blocks.shape[0] % 2 or not blocks.is_contiguous()):
        raise ValueError(f"blocks must be contiguous [nb (even), B] float32, "
                         f"got {tuple(blocks.shape)} {blocks.dtype}")
    if not 0 < blocks.shape[0] // 2 <= sf._MAX_GRID_Y:
        raise ValueError(f"1 to {sf._MAX_GRID_Y} block pairs, got "
                         f"{blocks.shape[0] // 2}")
    check_spectrum(H, blocks.shape[1])


def check_scratch(scratch: torch.Tensor, H: torch.Tensor) -> None:
    if (scratch.dtype != H.dtype or scratch.dim() != 3
            or tuple(scratch.shape[1:]) != tuple(H.shape)
            or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be contiguous [pairs, *{tuple(H.shape)}]"
                         f" {H.dtype}, got {tuple(scratch.shape)} "
                         f"{scratch.dtype}")
    check_spectrum(H, H.numel())


def launch_phases(variant: str, H: torch.Tensor, blocks=None, out=None,
                  scratch=None) -> None:
    """Launch one probe_phases variant (no counting; the callers count)."""
    b = H.numel()
    tw4, w1, w2 = sf.kernel_tables(b, H.dtype, H.device)
    l1, l2 = sf.split(b)
    _probe.launch("probe_phases", f"lowcut_probe_phases_{mode_of(H)}",
                  H.device, _probe.ptr(blocks), _probe.ptr(out), H.data_ptr(),
                  tw4.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                  scratch.data_ptr(), scratch.shape[0], l1, l2,
                  VARIANT_IDS[variant])


def _scratch(pairs: int, H: torch.Tensor) -> torch.Tensor:
    return torch.empty((pairs, *H.shape), dtype=H.dtype, device=H.device)


def k1(blocks: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Pass 1: blocks [2p, B] float32 -> scratch [p, N1, N2]."""
    check_blocks(blocks, H)
    if not _probe.on_card(blocks, H):
        return k1_reference(blocks, H)
    scratch = _scratch(blocks.shape[0] // 2, H)
    launch_phases("k1", H, blocks=blocks, scratch=scratch)
    launches[f"probe_passes_{mode_of(H)}"] += 1
    return scratch


def _in_place(name: str, scratch: torch.Tensor, H: torch.Tensor, ref):
    check_scratch(scratch, H)
    if not _probe.on_card(scratch, H):
        return scratch.copy_(ref(scratch, H))
    launch_phases(name, H, scratch=scratch)
    launches[f"probe_passes_{mode_of(H)}"] += 1
    return scratch


def k2(scratch: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Pass 2 in place: row FFTs * H, unscaled inverse row FFTs."""
    return _in_place("k2", scratch, H, k2_reference)


def k2a(scratch: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Pass 2's forward row FFTs alone, in place (rows bit-reversed)."""
    return _in_place("k2a", scratch, H, lambda s, _h: k2a_reference(s))


def k3(scratch: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Pass 3: scratch [p, N1, N2] -> blocks [2p, B] float32."""
    check_scratch(scratch, H)
    if not _probe.on_card(scratch, H):
        return k3_reference(scratch, H)
    out = torch.empty((2 * scratch.shape[0], H.numel()), dtype=torch.float32,
                      device=H.device)
    launch_phases("k3", H, out=out, scratch=scratch)
    launches[f"probe_passes_{mode_of(H)}"] += 1
    return out


# ------------------------------------------------------ plain versions

@functools.lru_cache(maxsize=32)
def _bitrev(log_n: int, device) -> torch.Tensor:
    return torch.from_numpy(sf._bitrev(log_n)).to(device)


def pairs_of(blocks: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """[2p, B] float32 -> [p, N1, N2] complex: blocks 2k + i * blocks 2k+1."""
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    n1, n2 = sf.split_shape(blocks.shape[1])
    z = torch.complex(blocks[0::2].to(rdt), blocks[1::2].to(rdt))
    return z.reshape(-1, n1, n2)


def blocks_of(z: torch.Tensor) -> torch.Tensor:
    """[p, N1, N2] complex -> [2p, B] float32: real parts to blocks 2k,
    imaginary parts to 2k + 1."""
    p = z.shape[0]
    return torch.stack([z.real, z.imag], dim=1).reshape(2 * p, -1).to(
        torch.float32)


def k1_reference(blocks: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    b = blocks.shape[1]
    l1, _ = sf.split(b)
    tw4 = sf.full_twiddle(b, H.dtype, blocks.device)
    z = torch.fft.fft(pairs_of(blocks, H.dtype), dim=1)
    return z[:, _bitrev(l1, blocks.device), :] * tw4


def k2a_reference(scratch: torch.Tensor) -> torch.Tensor:
    l2 = sf.split(scratch.shape[1] * scratch.shape[2])[1]
    return torch.fft.fft(scratch, dim=2)[:, :, _bitrev(l2, scratch.device)]


def k2_reference(scratch: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    n2 = H.shape[1]
    br2 = _bitrev(sf.split(H.numel())[1], scratch.device)
    y = (k2a_reference(scratch) * H)[:, :, br2]
    return torch.fft.ifft(y, dim=2) * n2


def k3_reference(scratch: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    b = H.numel()
    n1 = H.shape[0]
    tw4 = sf.full_twiddle(b, H.dtype, scratch.device)
    br1 = _bitrev(sf.split(b)[0], scratch.device)
    z = torch.fft.ifft((scratch * tw4.conj())[:, br1, :], dim=1) * (n1 / b)
    return blocks_of(z)


# -------------------------------------------------------- inputs, sweep

def spectrum(b: int, cdt: torch.dtype, device) -> torch.Tensor:
    """The kernel-layout spectrum of 38,401 seeded random taps, as
    ``experiments/fused_phase_decomp.py`` draws them (B taps where B is
    smaller)."""
    taps = np.random.default_rng(0).standard_normal(min(TAPS, b)) / 196.0
    return torch.from_numpy(sf.spectrum_layout(taps, b)).to(
        device=device, dtype=cdt)


def blocks_input(nb: int, b: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(nb * 7 + b)
    return torch.rand((nb, b), generator=g, device=device) * 2.0 - 1.0


def _rel(mode: str) -> float:
    return _probe.REL_F64 if mode == "f64" else _probe.REL_F32


def verify(device="cuda") -> dict:
    """Each pass against its plain version on the same input, at B = 2^19
    with 8 blocks, f32 and f64; then K3(K2(K1)) against the plain block
    convolution."""
    from ..ops import conv_blocks as cb

    dev = _probe.card(device)
    errs = {}
    b, nb = SHAPES[0]
    x = blocks_input(nb, b, dev)
    for cdt in (torch.complex64, torch.complex128):
        H = spectrum(b, cdt, dev)
        mode = mode_of(H)
        tag = f"passes {mode} B=2^19"
        s1 = k1(x, H)
        e = _probe.expect(f"{tag} k1", s1, k1_reference(x, H), _rel(mode))
        want = k2a_reference(s1)
        e = max(e, _probe.expect(f"{tag} k2a", k2a(s1.clone(), H), want,
                                 _rel(mode)))
        want = k2_reference(s1, H)
        s2 = k2(s1.clone(), H)
        e = max(e, _probe.expect(f"{tag} k2", s2, want, _rel(mode)))
        e = max(e, _probe.expect(f"{tag} k3", k3(s2, H), k3_reference(s2, H),
                                 _rel(mode)))
        y = k3(k2(k1(x, H), H), H)
        e = max(e, _probe.expect(f"{tag} k3(k2(k1))", y,
                                 cb.reference(x, conv_plan(H)), _rel(mode)))
        errs[f"probe_passes_{mode}"] = e
    torch.cuda.synchronize(dev)
    return errs


def conv_plan(H: torch.Tensor):
    """The fields of a plan ``ops.conv_blocks.reference`` reads."""
    from types import SimpleNamespace

    return SimpleNamespace(H=H, block_size=H.numel(),
                           precision=sf.HIGH if mode_of(H) == "f64" else sf.FAST)


def pass_bytes(name: str, b: int, pairs: int, cx: int) -> int:
    """Device-memory bytes a pass needs: its data per pair, its tables
    once."""
    data = {"k1": 8 * b + cx * b, "k2": 2 * cx * b, "k2a": 2 * cx * b,
            "k3": cx * b + 8 * b}[name]
    tables = {"k1": cx * b, "k2": cx * b, "k2a": 0, "k3": cx * b}[name]
    return data * pairs + tables


def segment_passes(device, precision: str, reps: int = 5,
                   frames: int = 30 * 96000) -> dict:
    """Device microseconds per launch of the segment kernel's three passes
    (torch.profiler over ``reps`` shipped calls) on 2 channels of
    ``frames`` at 96 kHz (2 x 30 s by default), B = 2^18, M = 38,400.
    Empty if the profiler saw no device time."""
    from ..models import LowCut

    plan = LowCut(freq=15.0, slope=10.0).plan(96000.0, precision=precision,
                                              device=device)
    n = frames
    g = torch.Generator(device=device).manual_seed(n)
    x = torch.rand((2, n), generator=g, device=device) - 0.5
    sf.segment_filter(x, plan, plan.mo2, n)
    torch.cuda.synchronize(device)
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            sf.segment_filter(x, plan, plan.mo2, n)
        torch.cuda.synchronize(device)
    out = {}
    for ev in prof.key_averages():
        for name in ("cols_forward", "rows_multiply", "cols_inverse"):
            if name in ev.key and ev.count:
                total = (getattr(ev, "device_time_total", 0)
                         or getattr(ev, "cuda_time_total", 0))
                if total:
                    out[name] = total / ev.count
    return out


def run(device="cuda", reps: int = 5) -> dict:

    dev = _probe.card(device)
    rows, kernels = [], {}
    for b, nb in SHAPES:
        x = blocks_input(nb, b, dev)
        pairs = nb // 2
        for cdt in (torch.complex64, torch.complex128):
            H = spectrum(b, cdt, dev)
            mode = mode_of(H)
            cx = 16 if mode == "f64" else 8
            s = k1(x, H)
            fns = {"k1": lambda: k1(x, H), "k2": lambda: k2(s, H),
                   "k2a": lambda: k2a(s, H), "k3": lambda: k3(s, H)}
            total = 0.0
            for name in PASSES:
                ms = _probe.event_ms(fns[name], reps)
                if name != "k2a":
                    total += ms
                rows.append([f"block {mode} B=2^{b.bit_length() - 1} "
                             f"nb={nb}", name.upper(), ms,
                             _probe.gbps(pass_bytes(name, b, pairs, cx), ms)])
            plain = _probe.event_ms(
                lambda: k3_reference(k2_reference(k1_reference(x, H), H), H),
                reps)
            rows.append([f"block {mode} B=2^{b.bit_length() - 1} nb={nb}",
                         "K1+K2+K3", total, f"plain {plain:.4f} ms"])
            if b == SHAPES[0][0]:
                # K3(K2(K1)) is the block convolution; no one PyTorch call
                # convolves blocks circularly: library_ms null.
                kernels[f"probe_passes_{mode}"] = {
                    "ms": total, "plain_ms": plain, "library_ms": None,
                    **roofline.bound(2 * x.numel() * 4,
                                     roofline.fft_conv_flops(b, nb), mode)}
    seg = []
    for precision, mode in (("fast", "f32"), ("high", "f64")):
        us = segment_passes(dev, precision, reps)
        for name in ("cols_forward", "rows_multiply", "cols_inverse"):
            seg.append([f"segment {mode} 2 x 30 s", name,
                        us[name] / 1e3 if name in us else "not measured", "-"])
    lines = _probe.table(
        f"per pass (block kernel: CUDA events, median of {reps}; segment "
        f"kernel: torch.profiler, mean of {reps} calls)",
        ["kernel, shape", "pass", "ms", "GB/s"], rows + seg)
    return {"lines": lines, "kernels": kernels}


def main() -> None:
    verify()
    print("\n".join(run(reps=10)["lines"]))


if __name__ == "__main__":
    main()

"""FFT-stage primitives on resident [512, 512] blocks, on the card.

Counterpart of ``experiments/mosaic_stages.py`` (``pallas_block_op``, the
``pallas_call`` at :92): single FFT stages and 512-point chains over
[8, 512, 512] complex blocks, the transform along axis 1 (the TPU's
sublane axis) and axis 2 the batch of transforms. ``csrc/probe_stages.cu``
runs them in f32 (complex64) and f64 (complex128; the TPU's df64 is not
carried over); a CTA holds 16 of a block's 512 transforms in shared memory
(a block's 4 MB in f64 is far above the 227 KB a CTA may use). Cases, each
with a plain PyTorch version of the same stage in the same order (natural
in, digit-reversed out for DIF):

- ``noop``: load and store the tile (the floor of every tile case);
- ``r2 d=..``, ``r4 d=..``: one radix-2 / radix-4 DIF stage at block
  length d = 128, 16, 4, 1 (``fft_core.dif_stage``);
- ``fwd r2``: the 512-point chain the kernels shipped before their
  register redesign (``probe_stages.cu`` ``fft_dif``, nine radix-2 sweeps),
  the baseline; ``fwd r4``: ``fft_core.dif_plan(512)``; ``fwd r8``:
  ``fft_core.dif_plan_r8(512)``; ``inv ..``: their DIT inverses, * 1/512;
  ``fwd+inv``: the radix-2 forward then inverse sweeps;
- ``fwd reg``: the shipped forward FFT (``fourstep.cuh`` ``Fft<T, 9>``:
  8 registers per thread, 3 radix-8 stages, 2 exchanges), whose output
  order is the radix-2 chain's (plain version: ``fwd r2``'s);
- ``fwd ring``, ``fwd ring r8``: the chain's function done the Hopper way
  (``probe_stages.cu`` ``ring_chain``): a persistent grid that runs
  ``Fft<T, 9>`` on [512, kW] column slabs fed by TMA tensor-map copies
  through a ring of shared-memory stages, storing in ``fwd r2``'s /
  ``fwd r8``'s order (plain versions: theirs); the kernels line's
  ``probe_stages`` and ``probe_stages2`` rows time them;
- ``shuffle e=..``: the roll stages ``subroll r2`` / ``laneroll r2``
  (``roll_r2_stage``): y = x[i] + x[i + e] where (i // e) is even, else
  (x[i - e] - x[i]) * w[v] with w[v] = exp(-2 pi i v / 64) for column v,
  along the transform axis. On the card the exchange is a warp shuffle
  (``__shfl_xor_sync``) for e < 32; the TPU's two roll axes have one
  counterpart, since a warp has no sublane/lane split;
- ``transpose 32``, ``transpose 64``: z[b] -> z[b]^T through shared tiles
  (``jnp.swapaxes``);
- ``cmul``: times a resident [512, 512] table, the four-step twiddle of
  the kernels at B = 2^18 (``cmul(T)``).

The sweep also times the chains and ``noop`` at [256, 512, 512], 1.07 /
2.15 GB moved (f32 / f64), far above the 50 MB L2, and at both batches
``z.clone()`` (the same bytes) and ``torch.fft.fft(z, dim=1)`` (natural
order, so not the rows' function) as context.
The XLA calibration rows of the TPU probe have no counterpart here.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops import roofline
from ..ops import segment_filter as sf
from . import _probe

N = 512
BATCH = 8
BATCH_LARGE = 256
_RADIX = {"r2": 2, "r4": 4, "r8": 8}

# name -> (case id of csrc/probe_stages.cu, param)
CASES = {
    "noop": (0, 0),
    **{f"r2 d={d}": (1, d) for d in (128, 16, 4, 1)},
    **{f"r4 d={d}": (2, d) for d in (128, 16, 4, 1)},
    "fwd r2": (3, 0), "fwd r4": (4, 0), "fwd r8": (5, 0),
    "inv r2": (6, 0), "inv r4": (7, 0), "inv r8": (8, 0),
    "fwd+inv": (9, 0), "fwd reg": (13, 0),
    "fwd ring": (14, 0), "fwd ring r8": (15, 0),
    "shuffle e=8": (10, 8), "shuffle e=1": (10, 1),
    "transpose 32": (11, 32), "transpose 64": (11, 64),
    "cmul": (12, 0),
}

launches = {"probe_stages_f32": 0, "probe_stages_f64": 0}


def mode_of(z: torch.Tensor) -> str:
    if z.dtype == torch.complex64:
        return "f32"
    if z.dtype == torch.complex128:
        return "f64"
    raise ValueError(f"stages take complex64 or complex128, got {z.dtype}")


MAX_BATCH = 65535  # the sweeps' grid (csrc/probe_stages.cu)


def _check(z: torch.Tensor, name: str) -> None:
    if name not in CASES:
        raise ValueError(f"unknown case {name!r}; one of {sorted(CASES)}")
    mode_of(z)
    if z.dim() != 3 or tuple(z.shape[1:]) != (N, N) or not z.is_contiguous():
        raise ValueError(f"stages take contiguous [batch, {N}, {N}], got "
                         f"{tuple(z.shape)}")
    if not 1 <= z.shape[0] <= MAX_BATCH:
        raise ValueError(f"stages take a batch of 1 .. {MAX_BATCH}, got "
                         f"{z.shape[0]}")


def launch_case(z: torch.Tensor, name: str) -> torch.Tensor:
    """Launch one case on a CUDA tensor (no counting; the callers count)."""
    kcase, param = CASES[name]
    out = torch.empty_like(z)
    tab = cmul_table(z.dtype, z.device) if name == "cmul" else roots(
        N, z.dtype, z.device)
    _probe.launch("probe_stages", f"lowcut_probe_stages_{mode_of(z)}",
                  z.device, z.data_ptr(), out.data_ptr(), tab.data_ptr(),
                  z.shape[0], kcase, param)
    return out


def stage(z: torch.Tensor, name: str) -> torch.Tensor:
    """z [batch, 512, 512] complex -> the case's output. CUDA tensors run
    the kernel, CPU tensors :func:`reference`."""
    _check(z, name)
    if not _probe.on_card(z):
        return reference(z, name)
    out = launch_case(z, name)
    launches[f"probe_stages_{mode_of(z)}"] += 1
    return out


# ------------------------------------------------------ plain versions

@functools.lru_cache(maxsize=16)
def roots(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """exp(-2 pi i k / n), k < n, from float64."""
    r = np.exp(-2j * np.pi * np.arange(n) / n)
    return torch.from_numpy(r).to(device=device, dtype=dtype)


def cmul_table(dtype: torch.dtype, device) -> torch.Tensor:
    return sf.full_twiddle(N * N, dtype, torch.device(device))


def dif_plan(n: int) -> tuple:
    """``fft_core.dif_plan``: a leading radix 2 if log2 n is odd, then
    radix 4, outermost first, as (kind, d)."""
    stages = []
    if (n.bit_length() - 1) % 2:
        stages.append(("r2", n // 2))
        n //= 2
    while n > 1:
        stages.append(("r4", n // 4))
        n //= 4
    return tuple(stages)


def dif_plan_r8(n: int) -> tuple:
    """``fft_core.dif_plan_r8``: radix 8 greedy, radix 4 (or 2) for the
    rest."""
    lg = n.bit_length() - 1
    n8, n4, n2 = 0, 0, 0
    if lg % 3 == 0:
        n8 = lg // 3
    elif lg % 3 == 2:
        n8, n4 = lg // 3, 1
    elif lg >= 4:
        n8, n4 = (lg - 4) // 3, 2
    elif lg == 1:
        n2 = 1
    stages = []
    for kind, sh, cnt in (("r8", 3, n8), ("r4", 2, n4), ("r2", 1, n2)):
        for _ in range(cnt):
            stages.append((kind, n >> sh))
            n >>= sh
    return tuple(stages)


def r2_plan(n: int) -> tuple:
    """The shipped sweep: radix 2 at d = n/2, ..., 1."""
    return tuple(("r2", n >> k) for k in range(1, n.bit_length()))


@functools.lru_cache(maxsize=64)
def _twiddles(kind: str, d: int, dtype, device):
    """w_r[j] = exp(-2 pi i r j / (radix d)), r = 1..radix-1, [d, 1]."""
    radix = _RADIX[kind]
    j = np.arange(d)[:, None]
    return tuple(torch.from_numpy(np.exp(-2j * np.pi * r * j / (radix * d))).to(
        device=device, dtype=dtype) for r in range(1, radix))


def _neg_i(a):
    return torch.complex(a.imag, -a.real)


def _pos_i(a):
    return torch.complex(-a.imag, a.real)


def _split(z, radix, d):
    v = z.reshape(*z.shape[:-2], -1, radix, d, z.shape[-1])
    return [v[..., q, :, :] for q in range(radix)]


def _join(parts, shape):
    return torch.stack(parts, dim=-3).reshape(shape)


def dif_stage(z: torch.Tensor, kind: str, d: int) -> torch.Tensor:
    """One DIF stage along dim -2 (``fft_core.dif_stage``)."""
    radix = _RADIX[kind]
    p = _split(z, radix, d)
    w = _twiddles(kind, d, z.dtype, z.device)
    if kind == "r2":
        y = [p[0] + p[1], p[0] - p[1]]
    elif kind == "r4":
        t0, t1, t2 = p[0] + p[2], p[0] - p[2], p[1] + p[3]
        t3 = _neg_i(p[1] - p[3])
        y = [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    else:
        r = 1.0 / np.sqrt(2.0)
        b0 = [p[q] + p[q + 4] for q in range(4)]
        b1 = [p[q] - p[q + 4] for q in range(4)]
        c0, c1 = b0[0] + b0[2], b0[0] - b0[2]
        c2, c3 = b0[1] + b0[3], _neg_i(b0[1] - b0[3])
        d0, d2 = b1[0], _neg_i(b1[2])
        d1 = (b1[1] + _neg_i(b1[1])) * r
        d3 = (_neg_i(b1[3]) - b1[3]) * r
        e0, e1, e2 = d0 + d2, d0 - d2, d1 + d3
        e3 = _neg_i(d1 - d3)
        y = [c0 + c2, e0 + e2, c1 + c3, e1 + e3,
             c0 - c2, e0 - e2, c1 - c3, e1 - e3]
    return _join([y[0]] + [y[q] * w[q - 1] for q in range(1, radix)], z.shape)


def _idft4(v0, v1, v2, v3):
    s0, d0, s1 = v0 + v2, v0 - v2, v1 + v3
    id1 = _pos_i(v1 - v3)
    return [s0 + s1, d0 + id1, s0 - s1, d0 - id1]


def dit_stage(z: torch.Tensor, kind: str, d: int) -> torch.Tensor:
    """One DIT (inverse, unscaled) stage along dim -2
    (``fft_core.dit_stage``)."""
    radix = _RADIX[kind]
    u = _split(z, radix, d)
    w = _twiddles(kind, d, z.dtype, z.device)
    u = [u[0]] + [u[q] * w[q - 1].conj() for q in range(1, radix)]
    if kind == "r2":
        y = [u[0] + u[1], u[0] - u[1]]
    elif kind == "r4":
        y = _idft4(u[0], u[1], u[2], u[3])
    else:
        r = 1.0 / np.sqrt(2.0)
        p = _idft4(u[0], u[2], u[4], u[6])
        q = _idft4(u[1], u[3], u[5], u[7])
        t = [q[0], (q[1] - _neg_i(q[1])) * r, _pos_i(q[2]),
             (q[3] + _neg_i(q[3])) * -r]
        y = [p[m] + t[m] for m in range(4)] + [p[m] - t[m] for m in range(4)]
    return _join(y, z.shape)


def fft_dif_rows(z: torch.Tensor, plan) -> torch.Tensor:
    for kind, d in plan:
        z = dif_stage(z, kind, d)
    return z


def ifft_dit_rows(z: torch.Tensor, plan) -> torch.Tensor:
    """The inverse of :func:`fft_dif_rows`, 1/n scaling included."""
    for kind, d in reversed(plan):
        z = dit_stage(z, kind, d)
    return z / z.shape[-2]


def roll_stage(z: torch.Tensor, e: int) -> torch.Tensor:
    """``roll_r2_stage`` along dim -2 with w[v] = exp(-2 pi i v / 64)."""
    n = z.shape[-2]
    u = torch.roll(z, -e, dims=-2)
    v = torch.roll(z, e, dims=-2)
    w = roots(64, z.dtype, z.device)[torch.arange(z.shape[-1],
                                                  device=z.device) % 64]
    lower = ((torch.arange(n, device=z.device) // e) % 2 == 0)[:, None]
    return torch.where(lower, z + u, (v - z) * w)


def reference(z: torch.Tensor, name: str) -> torch.Tensor:
    """The plain version of each case (module docstring)."""
    kcase, param = CASES[name]
    plans = {"r2": r2_plan(N), "r4": dif_plan(N), "r8": dif_plan_r8(N)}
    if name == "noop":
        return z.clone()
    if kcase in (1, 2):
        return dif_stage(z, name[:2], param)
    if name in ("fwd reg", "fwd ring"):
        return fft_dif_rows(z, plans["r2"])
    if name == "fwd ring r8":
        return fft_dif_rows(z, plans["r8"])
    if name.startswith("fwd "):
        return fft_dif_rows(z, plans[name[4:]])
    if name.startswith("inv "):
        return ifft_dit_rows(z, plans[name[4:]])
    if name == "fwd+inv":
        return ifft_dit_rows(fft_dif_rows(z, plans["r2"]), plans["r2"])
    if name.startswith("shuffle"):
        return roll_stage(z, param)
    if name.startswith("transpose"):
        return z.transpose(-1, -2).contiguous()
    return z * cmul_table(z.dtype, z.device)


# -------------------------------------------------------- inputs, sweep

def blocks_input(dtype: torch.dtype, device, batch: int = BATCH) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(batch)
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    re = torch.randn((batch, N, N), generator=g, device=device, dtype=rdt)
    im = torch.randn((batch, N, N), generator=g, device=device, dtype=rdt)
    return torch.complex(re, im)


def _bitwise(name: str) -> bool:
    return name == "noop" or name.startswith("transpose")


def verify_cases(names, stage_fn, device, row: str, large=()) -> dict:
    """Each case against its plain version at [8, 512, 512], and the cases
    ``large`` at [256, 512, 512] too, in f32 and f64; the row's error is
    the largest."""
    dev = _probe.card(device)
    errs = {}
    for dtype in (torch.complex64, torch.complex128):
        e = 0.0
        for batch, which in ((BATCH, names), (BATCH_LARGE, large)):
            if not which:
                continue
            z = blocks_input(dtype, dev, batch)
            mode = mode_of(z)
            rel = _probe.REL_F64 if mode == "f64" else _probe.REL_F32
            for name in which:
                e = max(e, _probe.expect(
                    f"stage {mode} {name} batch {batch}", stage_fn(z, name),
                    reference(z, name), None if _bitwise(name) else rel))
            del z
        errs[f"{row}_{mode}"] = e
    torch.cuda.synchronize(dev)
    return errs


def run_cases(names, stage_fn, device, reps: int, row: str, key_case: str,
              title: str, large=()) -> dict:
    """Times ``names`` at [8, 512, 512] and ``large`` at [256, 512, 512],
    each batch with the key case's plain version and, as context,
    ``z.clone()`` (the same bytes) and ``torch.fft.fft`` along the
    transform axis (natural order, so not a chain's function and never a
    row's library call); the row is the key case at batch 8."""
    dev = _probe.card(device)
    lines, kernels = [], {}
    for batch, which in ((BATCH, names), (BATCH_LARGE, large)):
        if not which:
            continue
        rows = []
        for dtype in (torch.complex64, torch.complex128):
            z = blocks_input(dtype, dev, batch)
            mode = mode_of(z)
            nbytes = 2 * z.numel() * z.element_size()
            # A complex FFT of N points along each row, 5 N log2 N flops.
            flops = 5.0 * N * math.log2(N) * (z.numel() // N)
            bound = roofline.bound(nbytes, flops, mode)
            for name in which:
                ms = _probe.event_ms(lambda n=name: stage_fn(z, n), reps)
                rows.append([mode, name, ms, _probe.gbps(nbytes, ms),
                             bound["bound_ms"] / ms])
            ms = _probe.event_ms(lambda: stage_fn(z, key_case), reps)
            plain = _probe.event_ms(lambda: reference(z, key_case), reps)
            clone = _probe.event_ms(z.clone, reps)
            lib = _probe.event_ms(lambda: torch.fft.fft(z, dim=1), reps)
            for label, t in ((f"plain {key_case}", plain),
                             ("z.clone() (the same bytes; context)", clone),
                             ("torch.fft.fft (natural order; context)", lib)):
                rows.append([mode, label, t, _probe.gbps(nbytes, t),
                             bound["bound_ms"] / t])
            if batch == BATCH:
                # The key case's output is in a digit-reversed order, which
                # no one PyTorch call gives (library_ms null).
                kernels[f"{row}_{mode}"] = {"ms": ms, "plain_ms": plain,
                                            "library_ms": None, **bound}
            del z
        lines += _probe.table(
            title + f" on [{batch}, 512, 512] complex (CUDA events, median "
            f"of {reps}; GB/s counts one read and one write of the blocks; "
            "share = bound / ms)", ["mode", "case", "ms", "GB/s", "share"], rows)
    return {"lines": lines, "kernels": kernels}


# The chains timed at [256, 512, 512] beside the row's kernel.
LARGE = ("noop", "fwd r2", "fwd reg", "fwd ring")


def verify(device="cuda") -> dict:
    """Every case against its plain version, f32 and f64: bitwise for
    noop and the transposes, the stated tolerance otherwise; the ring
    chains at batch 256 too (many slabs a CTA: every stage refilled)."""
    return verify_cases(tuple(CASES), stage, device, "probe_stages",
                        large=("fwd ring",))


def run(device="cuda", reps: int = 5) -> dict:
    return run_cases(tuple(CASES), stage, device, reps, "probe_stages",
                     "fwd ring", "FFT stages", large=LARGE)


def main() -> None:
    verify()
    print("\n".join(run(reps=10)["lines"]))


if __name__ == "__main__":
    main()

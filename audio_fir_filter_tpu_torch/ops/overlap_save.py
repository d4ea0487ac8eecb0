"""Overlap-save FFT convolution: plan and filters.

Counterpart of ``audio_fir_filter_tpu/ops/overlap_save.py``. Semantics are
the zero-padded "same" convolution of the float64 oracle:

    out[i] = sum_{k=0}^{M} h[k] * x[i - Mo2 + k],   x == 0 outside [0, N)

With FFT size B and hop L = B - M, block j reads the padded input
xp[j*L : j*L + B] (xp = [Mo2 zeros | x | zeros]); the circular convolution
of the block with the reversed kernel is alias-free at positions [M, B),
which are exactly out[j*L : (j+1)*L].

Two precisions: ``fast`` computes in float32 (within 1 LSB @ 16-bit of the
oracle) and ``high`` in native float64 (within 1 LSB @ 24-bit). An int16
input is PCM and takes the 16-bit route (:func:`takes_i16`): int16 in and
out of the segment kernel, float32 arithmetic.

Two engines, chosen by the plan (:func:`resolve_engine`):

- ``pallas`` (what ``auto`` resolves to): the whole-segment kernel,
  :func:`.segment_filter.segment_filter`, which frames the windows itself
  and writes only valid hops;
- the generic block path, for ``fourstep``, ``pease`` and ``stockham``:
  overlapped blocks materialized on the device (``F.pad`` + ``unfold``),
  convolved ``conv_chunk`` blocks at a time by
  :func:`.conv_blocks.conv_real_blocks`, positions [M, B) kept. The three
  names are XLA FFT variants of one block convolution in the JAX package;
  the port has one block kernel for all three.

Each kernel runs for tensors on the card; its plain PyTorch version runs
for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import spans
from ..utils.device import resolve_device
from . import conv_blocks as cb
from . import segment_filter as sf

FAST = sf.FAST
HIGH = sf.HIGH

_SPECTRUM_DTYPE = {FAST: torch.complex64, HIGH: torch.complex128}

PALLAS = "pallas"
BLOCK_ENGINES = ("fourstep", "pease", "stockham")
# Blocks per block-kernel call on the block path (the JAX package's
# default conv_chunk).
CONV_CHUNK = 16


def resolve_engine(engine: str) -> str:
    """``auto`` -> ``pallas`` (the segment kernel); ``pallas`` and the block
    engines stay as named. Raises ValueError for any other name."""
    if engine == "auto":
        return PALLAS
    if engine != PALLAS and engine not in BLOCK_ENGINES:
        raise ValueError(f"unknown engine {engine!r} (use 'auto', 'pallas', "
                         f"{', '.join(repr(e) for e in BLOCK_ENGINES)})")
    return engine


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def choose_block_size(num_taps: int, requested: int = 0,
                      min_size: int = 1 << 13, max_size: int = 1 << 21) -> int:
    """FFT size B for kernel length T, with the JAX package's contract and
    choices (so both packages plan alike): ``requested`` rounds up to a
    power of two and must exceed M; otherwise the smallest power of two
    >= 4*M within [min_size, max_size] (kept above 2*M), with a 2^18 floor
    for M >= 2^13 — 2^18 at M = 17,640 and at M = 38,400. Retuning B for
    the card is open work (ROADMAP)."""
    m = num_taps - 1
    if requested:
        b = _next_pow2(requested)
        if b <= m:
            raise ValueError(f"block size {requested} must exceed kernel order {m}")
        return b
    b = max(min_size, _next_pow2(4 * max(m, 1)))
    if m >= (1 << 13):
        b = max(b, 1 << 18)
    while b > max_size and b >= 4 * _next_pow2(m + 1):
        b >>= 1
    return b


@dataclasses.dataclass(frozen=True)
class OverlapSavePlan:
    """Convolution plan: sizes plus the device spectrum.

    ``H`` is the spectrum of the reversed, zero-padded taps, computed on the
    host in float64 and stored in the kernel's own layout
    (:func:`.segment_filter.spectrum_layout`, [N1, N2]): complex64 for
    ``fast``, complex128 for ``high``.
    """

    num_taps: int          # T = M + 1
    block_size: int        # B (power of two)
    precision: str
    device: torch.device
    H: torch.Tensor = dataclasses.field(compare=False, repr=False)
    # Resolved engine: "pallas" (segment kernel) or a block engine.
    engine: str = PALLAS
    # Blocks per block-kernel call on the block path.
    conv_chunk: int = CONV_CHUNK

    @property
    def m(self) -> int:
        return self.num_taps - 1

    @property
    def mo2(self) -> int:
        return self.m // 2

    @property
    def hop(self) -> int:
        return self.block_size - self.m


def _plan(taps: np.ndarray, precision: str, b: int, device, engine: str,
          conv_chunk: int) -> OverlapSavePlan:
    dtype = _SPECTRUM_DTYPE.get(precision)
    if dtype is None:
        raise ValueError(f"unknown precision {precision!r} (use 'fast' or 'high')")
    engine = resolve_engine(engine)
    if conv_chunk < 2 or conv_chunk % 2:
        raise ValueError(f"conv_chunk must be even and >= 2, got {conv_chunk}")
    dev = resolve_device(device)
    # Both kernels take the same shapes: odd taps, B a power of two > M
    # with each four-step side within the shared-memory tile.
    if not sf.qualifies(len(taps), b):
        raise ValueError(f"no kernel for {len(taps)} taps at B={b}")
    H = torch.from_numpy(sf.spectrum_layout(taps, b)).to(device=dev, dtype=dtype)
    return OverlapSavePlan(len(taps), b, precision, dev, H, engine, conv_chunk)


def make_plan(taps: np.ndarray, precision: str = HIGH, block_size: int = 0,
              device="cuda", engine: str = "auto",
              conv_chunk: int = CONV_CHUNK) -> OverlapSavePlan:
    """Plan for odd-length float64 ``taps`` on ``device`` (raises if a CUDA
    device is asked for and there is no card) with ``engine`` resolved by
    :func:`resolve_engine` and ``conv_chunk`` blocks per block-kernel call
    on the block path."""
    taps = np.asarray(taps, dtype=np.float64)
    if len(taps) % 2 != 1:
        raise ValueError("taps must have odd length (type-I linear phase)")
    return _plan(taps, precision, choose_block_size(len(taps), block_size),
                 device, engine, conv_chunk)


def plan_from_jax(jax_plan, taps: np.ndarray, device) -> OverlapSavePlan:
    """The port's plan for the configuration of a JAX package plan: the same
    float64 taps with its ``num_taps``, ``block_size``, ``precision``,
    ``engine`` and ``conv_chunk``. Used to run both packages on one
    configuration."""
    taps = np.asarray(taps, dtype=np.float64)
    if len(taps) != jax_plan.num_taps:
        raise ValueError(f"{len(taps)} taps for a JAX plan of "
                         f"{jax_plan.num_taps}")
    return _plan(taps, jax_plan.precision, jax_plan.block_size, device,
                 jax_plan.engine, jax_plan.conv_chunk)


def plan_for_device(plan: OverlapSavePlan, device) -> OverlapSavePlan:
    """``plan`` with its spectrum on ``device`` (a device with its index
    spelled out): ``plan`` itself when it lives there, else a copy made
    once per device and kept with the plan. A mesh cell on another card
    needs its plan there: :func:`_as_input` moves the input to the plan's
    device, so the first card's plan would pull every shard to that card."""
    device = torch.device(device)
    if plan.H.device == device:
        return plan
    cache = object.__getattribute__(plan, "__dict__").setdefault("_on_device", {})
    if device not in cache:
        cache[device] = dataclasses.replace(plan, device=device,
                                            H=plan.H.to(device))
    return cache[device]


# ------------------------------------------------ launches and device bytes

def block_count(plan: OverlapSavePlan, out_len: int) -> int:
    """Blocks per channel on the block path for ``out_len`` output frames:
    one per hop, rounded up to even so pairs never straddle a channel."""
    nb = -(-out_len // plan.hop)
    return nb + (nb & 1)


def launches_per_call(plan: OverlapSavePlan, channels: int, out_len: int) -> int:
    """Launches (calls of a kernel's C entry point, as the wrappers'
    ``launches`` count them) of one filter call of ``channels`` x
    ``out_len``: one on the segment path (the entry point walks its scratch
    chunks itself), one per ``conv_chunk`` blocks on the block path."""
    if channels == 0 or out_len == 0:
        return 0
    if plan.engine == PALLAS:
        return 1
    return -(-channels * block_count(plan, out_len) // plan.conv_chunk)


def chunk_hops(plan: OverlapSavePlan) -> int:
    """Hops of output that one scratch chunk (segment path) or one launch
    (block path) covers, channel-major from the first hop of channel 0:
    the first seam between two chunks, if the call has more than one."""
    elt = plan.H.element_size()
    if plan.engine == PALLAS:
        return 2 * sf.scratch_pairs(sf._MAX_GRID_Y, plan.block_size, elt)
    return plan.conv_chunk


def call_bytes(plan: OverlapSavePlan, channels: int, out_len: int) -> int:
    """Device bytes one :func:`extended_filter` call of ``out_len`` frames
    per channel holds at its peak: the float32 input with its halo, the
    scratch of one launch, and the output (segment path) or, on the block
    path, the overlapped blocks, the kernel's outputs until they are
    joined, and the joined hops (the output)."""
    b, elt = plan.block_size, plan.H.element_size()
    x = 4 * channels * (out_len + plan.m)
    if plan.engine == PALLAS:
        pairs = sf.call_pairs(channels, out_len, plan.hop)
        return x + 4 * channels * out_len + sf.scratch_pairs(pairs, b, elt) * b * elt
    nb = block_count(plan, out_len)
    blocks = 4 * channels * nb * b
    scratch = sf.scratch_pairs(plan.conv_chunk // 2, b, elt) * b * elt
    return x + 2 * blocks + 4 * channels * nb * plan.hop + scratch


# ------------------------------------------------------------------ filters

def takes_i16(plan: OverlapSavePlan) -> bool:
    """Whether ``plan`` takes the 16-bit route (the segment kernel's int16
    mode, float32 arithmetic): a ``fast`` plan of the ``pallas`` engine."""
    return plan.engine == PALLAS and plan.precision == FAST


def _as_input(x, plan: OverlapSavePlan) -> tuple[torch.Tensor, bool]:
    """``(x as [C, N], whether it was [N])``, float32 (int16 stays int16),
    contiguous, on the plan's device. A tensor that already is all three
    passes through untouched: the same tensor, no copy and no wait for the
    card (the streamed routes upload their segments themselves, without
    blocking). Anything else is copied there; from pageable host memory
    that copy blocks the host."""
    x = torch.as_tensor(x)
    dtype = torch.int16 if x.dtype == torch.int16 else torch.float32
    x = x.to(device=plan.device, dtype=dtype).contiguous()
    squeeze = x.dim() == 1
    return (x[None, :] if squeeze else x), squeeze


def _same_filter_reference(x: torch.Tensor, plan: OverlapSavePlan) -> torch.Tensor:
    """The plain PyTorch version of :func:`same_filter` on [C, N] float32:
    ``F.pad`` + ``unfold`` blocks, ``rfft`` * H * ``irfft`` (float64 for
    ``high``, float32 for ``fast``), positions [M, B) kept. Tests and
    chip_smoke.py hold the kernel against it; the filters reach it only for
    CPU tensors."""
    return sf.reference(x, plan, plan.mo2, x.shape[1])[0]


def _block_filter_peak(x: torch.Tensor, plan: OverlapSavePlan, left: int,
                       out_len: int):
    """The generic block path: y[i] = sum_k h[k] x[i - left + k] for i in
    [0, out_len) through the block kernel, ``conv_chunk`` blocks per call,
    and the peak over those ``out_len`` samples only, as a 0-d tensor.

    Free of host syncs: the window copy, the launches, the join and the
    peak are all queued on the device; only sizes computed on the host
    steer them, so a caller may queue the next segment before reading
    this one."""
    c = x.shape[0]
    b, m, hop = plan.block_size, plan.m, plan.hop
    nb = block_count(plan, out_len)
    if c == 0 or nb == 0:
        y = x.new_empty((c, out_len))
        return y, x.new_zeros(())
    # Channels fold into the block axis (channel-major): one contiguous copy.
    blocks = sf.windows(x, b, hop, left, nb).contiguous().view(c * nb, b)
    step = plan.conv_chunk
    yb = torch.cat([cb.conv_real_blocks(blocks[i : i + step], plan)[:, m:]
                    for i in range(0, blocks.shape[0], step)])
    y = yb.view(c, nb * hop)[:, :out_len].contiguous()
    return y, y.abs().amax()


def _filter_peak(x: torch.Tensor, plan: OverlapSavePlan, left: int,
                 out_len: int):
    i16 = x.dtype == torch.int16
    if i16 and not takes_i16(plan):
        raise ValueError("int16 input needs a 'fast' plan of the 'pallas' "
                         f"engine, got {plan.engine!r}, {plan.precision!r}")
    if plan.engine == PALLAS:
        return sf.segment_filter(x, plan, left, out_len, i16_io=i16)
    return _block_filter_peak(x, plan, left, out_len)


def _filter(x, plan: OverlapSavePlan, left: int, out_len: int | None):
    """One call of the filters, in the ``filter`` span: ``x`` as [C, N]
    on the plan's device, filtered from ``left`` for ``out_len`` frames
    (N when None)."""
    with spans.span("filter") as s:
        x, squeeze = _as_input(x, plan)
        n = x.shape[1] if out_len is None else out_len
        if s:
            s.set(engine=plan.engine, precision=plan.precision,
                  channels=x.shape[0], frames=n, sample_bytes=x.element_size())
        y, peak = _filter_peak(x, plan, left, n)
    return (y[0] if squeeze else y), peak


def same_filter_peak(x, plan: OverlapSavePlan):
    """Filter [N] or [C, N] with 'same' semantics; returns (y float32 on the
    plan's device, peak max|y| as a 0-d tensor). An int16 ``x`` takes the
    16-bit route (:func:`takes_i16`): y int16 PCM, the peak in PCM codes."""
    return _filter(x, plan, plan.mo2, None)


def extended_filter_peak(xe, plan: OverlapSavePlan, out_len: int):
    """Filter with explicit halos: ``xe`` is [C, S + M] = [left Mo2 | body S
    | right Mo2]; returns (out[0:out_len] of the body, its peak). The
    primitive of host-side segmentation: halos replace the zero padding
    except at the true signal edges. The peak covers only the ``out_len``
    returned samples, so a short last segment needs no host re-scan. An
    int16 ``xe`` takes the 16-bit route, as in :func:`same_filter_peak`."""
    return _filter(xe, plan, 0, out_len)


def same_filter(x, plan: OverlapSavePlan) -> torch.Tensor:
    """Filter [N] or [C, N] float32 with reference 'same' semantics."""
    return same_filter_peak(x, plan)[0]


def extended_filter(xe, plan: OverlapSavePlan, out_len: int) -> torch.Tensor:
    """:func:`extended_filter_peak` without the peak."""
    return extended_filter_peak(xe, plan, out_len)[0]

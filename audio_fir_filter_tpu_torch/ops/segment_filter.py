"""Whole-segment overlap-save filtering: the CUDA kernel's wrapper, its
host tables, and its plain PyTorch version.

Counterpart of the segment path of ``audio_fir_filter_tpu/ops/pallas_fft.py``
(``pallas_segment_filter`` and its framing/qualifier helpers). The kernel
(``csrc/segment_filter.cu``) computes, for i in [0, out_len),

    y[i] = sum_{k=0}^{M} h[k] * x[i - left + k],   x == 0 outside [0, n_in)

in three modes: ``f32`` (float32 in/out and arithmetic), ``f64`` (float32
in/out, float64 arithmetic) and ``i16`` (int16 PCM in/out, float32
arithmetic, the codec's quantization on write). It also returns the
output's peak max|y| over [0, out_len).

The wrapper's rule: a CUDA tensor launches the kernel (and raises if the
launch fails); a CPU tensor takes the plain version (:func:`reference`).
There is no fallback between the two.

Framing is plain: hop = B - M and left pad = Mo2. The 8/16-row quanta and
the ``c >= 128`` floor of the TPU framing are Mosaic tiling rules and have
no counterpart here, so one qualifier serves every mode.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import spans

FAST = "fast"
HIGH = "high"

# Per mode, counted by :func:`segment_filter` where it calls the C entry
# point and nowhere else (chip_smoke.py reads them to show the main path
# went through the kernel, bench.py to gate its launches): ``launches``,
# the calls of the C entry point (one a call on the card), and
# ``kernels``, the kernels those calls issued, KERNELS_PER_CHUNK for each
# scratch chunk of the entry's loop (``run_split`` in
# ``csrc/segment_filter.cuh``), reckoned on the host from the same
# chunking (:func:`entry_chunks` of :func:`scratch_pairs`).
launches = {"f32": 0, "f64": 0, "i16": 0}
kernels = {"f32": 0, "f64": 0, "i16": 0}

# Kernels the C entry point issues per scratch chunk: its three passes.
KERNELS_PER_CHUNK = 3

# 32-bit words of the C entry point's ``peak`` argument, all zeroed by the
# caller: the output peak (a float), then pass 3's item counter and count
# of finished CTAs (``Pass3`` in ``csrc/segment_filter.cuh``).
PEAK_WORDS = 3

# One FFT side is at most 2^13 points (the kernel's shared-memory tile).
_MAX_LOG_SIDE = 13
# Scratch for one launch chunk of pairs ([pairs, B] complex): 64 float64
# pairs at B = 2^18, so a stereo 2^24-frame segment runs in two chunks.
_SCRATCH_BYTES = 256 << 20
_MAX_GRID_Y = 65535


def split(b: int) -> tuple[int, int]:
    """(log2 N1, log2 N2) of the four-step split B = N1 * N2, N1 >= N2."""
    lb = b.bit_length() - 1
    return (lb + 1) // 2, lb // 2


def split_shape(b: int) -> tuple[int, int]:
    """(N1, N2): the shape of the kernel-layout spectrum."""
    l1, l2 = split(b)
    return 1 << l1, 1 << l2


def scratch_pairs(pairs: int, b: int, element_size: int) -> int:
    """Pairs of B-point blocks one launch's scratch holds for ``pairs``
    pairs of complex ``element_size``-byte values: all of them, at most the
    grid's y limit and :data:`_SCRATCH_BYTES`. The kernel walks the pairs
    in chunks of this many."""
    return max(1, min(pairs, _MAX_GRID_Y, _SCRATCH_BYTES // (b * element_size)))


def call_pairs(channels: int, out_len: int, hop: int) -> int:
    """Pairs of B-point blocks one call filters: each channel's hops, in
    pairs (one complex FFT a pair), rounded up."""
    return channels * ((-(-out_len // hop) + 1) // 2)


_OCCUPANCY_KEYS = ("ctas_per_sm", "threads", "smem_bytes", "registers",
                   "local_bytes", "ring_depth", "tiles", "resident_ctas")
# The C entry points' mode ids.
_MODE_IDS = {"f32": 0, "f64": 1, "i16": 2}


def _occupancy(query: str, mode: str, b: int, device_index: int) -> dict:
    import ctypes

    from . import _build

    fn = getattr(_build.library("segment_filter"), query)
    out = (ctypes.c_int * len(_OCCUPANCY_KEYS))()
    with torch.cuda.device(device_index):
        rc = fn(_MODE_IDS[mode], *split(b), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{query} failed: CUDA error {rc}")
    return dict(zip(_OCCUPANCY_KEYS, out))


@functools.lru_cache(maxsize=None)
def pass1_occupancy(mode: str, b: int, device_index: int = 0) -> dict:
    """Pass 1 (``cols_forward``) of ``mode`` at block size ``b`` on card
    ``device_index``: CTAs an SM holds, threads per CTA, dynamic shared
    bytes, registers and local-memory (stack and spill) bytes per thread,
    its ring's depth (0: no ring, one CTA an item), the column tiles a
    pair and the CTAs the card holds at once (with a ring, the grid of a
    chunk with at least as many items). Asked of the built kernel once
    per (mode, B, card); needs a card."""
    return _occupancy("lowcut_segment_pass1_occupancy", mode, b, device_index)


@functools.lru_cache(maxsize=None)
def pass2_occupancy(mode: str, b: int, device_index: int = 0) -> dict:
    """Pass 2 of ``mode`` at block size ``b`` on card ``device_index``, in
    :func:`pass1_occupancy`'s keys: the kernel that runs
    (``rows_multiply_ring`` with a ring, ``rows_multiply`` without), its
    ring's depth (0: no ring, one CTA an item), the row tiles a pair and
    the CTAs the card holds at once (0 without a ring). Asked of the built
    kernel once per (mode, B, card); needs a card."""
    return _occupancy("lowcut_segment_pass2_occupancy", mode, b, device_index)


@functools.lru_cache(maxsize=None)
def pass3_occupancy(mode: str, b: int, device_index: int = 0) -> dict:
    """Pass 3 of ``mode`` at block size ``b`` on card ``device_index``, in
    :func:`pass1_occupancy`'s keys: the kernel that runs
    (``cols_inverse_ring`` with a ring, ``cols_inverse`` without), its
    ring's depth (0: no ring, one CTA an item), the column tiles a pair
    and the CTAs the card holds at once (0 without a ring). Asked of the
    built kernel once per (mode, B, card); needs a card."""
    return _occupancy("lowcut_segment_pass3_occupancy", mode, b, device_index)


def entry_chunks(pairs: int, chunk: int) -> int:
    """Scratch chunks the C entry point's loop walks for ``pairs`` pairs,
    ``chunk`` (:func:`scratch_pairs`) at a time."""
    return -(-pairs // chunk)


def segment_framing(m: int, b: int) -> tuple[int, int]:
    """(hop, left pad) for kernel order M at block size B: hop = B - M,
    left = Mo2. Block j's window starts at j * hop of the padded signal and
    its alias-free positions [M, B) are outputs [j*hop, (j+1)*hop)."""
    return b - m, m // 2


def qualifies(num_taps: int, b: int) -> bool:
    """Whether the kernel takes this (taps, block) shape: an odd tap count
    (type-I: 2*Mo2 == M), B a power of two of at least 4 points with each
    four-step side within the kernel's tile, and B > M (hop > 0)."""
    m = num_taps - 1
    if num_taps < 1 or m % 2:
        return False
    if b < 4 or b & (b - 1):
        return False
    if split(b)[0] > _MAX_LOG_SIDE:
        return False
    return segment_framing(m, b)[0] > 0


@functools.lru_cache(maxsize=16)
def _bitrev(log_n: int) -> np.ndarray:
    n = 1 << log_n
    i = np.arange(n, dtype=np.int64)
    r = np.zeros(n, dtype=np.int64)
    for bit in range(log_n):
        r |= ((i >> bit) & 1) << (log_n - 1 - bit)
    return r


def spectrum_layout(taps: np.ndarray, b: int) -> np.ndarray:
    """Float64 spectrum of the reversed, zero-padded taps in the kernel's
    order, [N1, N2] complex128: entry (pos, q) holds H[k1 + N1*k2] with
    k1 = bitrev(pos), k2 = bitrev(q) — where the kernel's forward column
    and row FFTs (decimation in frequency) leave each frequency."""
    taps = np.asarray(taps, dtype=np.float64)
    hr = np.zeros(b, dtype=np.float64)
    hr[: len(taps)] = taps[::-1]
    l1, l2 = split(b)
    full = np.fft.fft(hr)
    return full[_bitrev(l1)[:, None] + (1 << l1) * _bitrev(l2)[None, :]]


@functools.lru_cache(maxsize=16)
def _natural_index(b: int) -> np.ndarray:
    """Flat positions in the kernel layout of frequencies 0..B/2."""
    l1, l2 = split(b)
    k = np.arange(b // 2 + 1, dtype=np.int64)
    return _bitrev(l1)[k & ((1 << l1) - 1)] * (1 << l2) + _bitrev(l2)[k >> l1]


@functools.lru_cache(maxsize=16)
def _natural_index_on(b: int, device: torch.device) -> torch.Tensor:
    """:func:`_natural_index` on ``device``, uploaded once per (B, device)."""
    return torch.from_numpy(_natural_index(b)).to(device)


def natural_spectrum(H: torch.Tensor) -> torch.Tensor:
    """rfft-order half spectrum [B/2 + 1] from the kernel-layout ``H``. The
    gather index stays on H's device, so a call copies nothing from the
    host (the plain versions' times hold no 1 MB upload at B = 2^18)."""
    return H.reshape(-1)[_natural_index_on(H.numel(), H.device)]


# The largest four-step twiddle table the column passes read whole; above
# it they take two factor tables (``fourstep.cuh`` ``Twiddle``).
TWIDDLE_TABLE_MAX = 4 << 20


def twiddle_layout(b: int, dtype: torch.dtype) -> dict:
    """The four-step twiddle table the column passes read at block size
    ``b`` in ``dtype`` (complex64 / complex128): ``factored``, two factor
    tables where the full [N1, N2] table would exceed
    :data:`TWIDDLE_TABLE_MAX` (f64 from B = 2^19, f32 from 2^20); its
    ``bytes``; and the factor tables' ``lo_rows`` and ``hi_rows``
    (:func:`twiddle_rows`; 0 where it is not factored). The kernels decide
    the same at compile time (``fourstep.cuh`` ``Twiddle``), which
    :func:`library_twiddle_layout` reports."""
    n1, n2 = split_shape(b)
    factored = b * dtype.itemsize > TWIDDLE_TABLE_MAX
    lo, hi = twiddle_rows(b) if factored else (0, 0)
    rows = lo + hi if factored else n1
    return {"factored": factored, "bytes": rows * n2 * dtype.itemsize,
            "lo_rows": lo, "hi_rows": hi}


_TWIDDLE_KEYS = ("factored", "bytes", "lo_rows", "hi_rows")


def library_twiddle_layout(mode: str, b: int) -> dict:
    """:func:`twiddle_layout` as the built segment kernel of ``mode`` has
    it at block size ``b`` (``lowcut_segment_twiddle_layout``). Builds the
    library; needs no card."""
    import ctypes

    from . import _build

    fn = _build.library("segment_filter").lowcut_segment_twiddle_layout
    out = (ctypes.c_longlong * len(_TWIDDLE_KEYS))()
    rc = fn(_MODE_IDS[mode], *split(b), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"twiddle layout query failed: CUDA error {rc}")
    got = dict(zip(_TWIDDLE_KEYS, out))
    got["factored"] = bool(got["factored"])
    return got


def twiddle_rows(b: int) -> tuple[int, int]:
    """(lo rows, hi rows) of the factored twiddle at block size ``b``:
    2^h and 8, h = L1 - 3 (L1 = log2 N1 >= 3): the column passes' thread
    t holds rows 8 t + m, whose k1 = bitrev(8 t + m) is bitrev(m) * 2^h
    + bitrev(t) (``fourstep.cuh`` ``ColTwiddle``)."""
    l1 = split(b)[0]
    if l1 < 3:
        raise ValueError(f"the factored twiddle needs N1 >= 8, got B = {b}")
    return 1 << (l1 - 3), 8


def four_step_twiddle(b: int) -> np.ndarray:
    """Float64 four-step twiddle [N1, N2]: entry (pos, n2) is
    exp(-2*pi*i * n2 * bitrev(pos) / B), what the column passes multiply
    scratch row pos by."""
    l1, l2 = split(b)
    k = (np.arange(1 << l2, dtype=np.int64)[None, :] * _bitrev(l1)[:, None]) % b
    return np.exp(-2j * np.pi * k / b)


def unit_roots(k: np.ndarray, b: int) -> np.ndarray:
    """exp(-2*pi*i * k / b) in float64 for integer ``k`` and ``b`` a power
    of two of at least 8, each part within about an ulp: k reduced to the
    first octant (an angle of at most pi/4, where the angle's own rounding
    is smallest), one cos and sin there, then the octant's and the quarter
    turns' symmetries, which are exact."""
    q, r = np.divmod(np.asarray(k, dtype=np.int64) % b, b // 4)
    swap = r > b // 8
    theta = 2 * np.pi * (np.where(swap, b // 4 - r, r) / b)
    c, s = np.cos(theta), np.sin(theta)
    # w^r = (c, -s); past the octant w^r = -i * conj(w^(b/4 - r)) = (s, -c).
    re, im = np.where(swap, s, c), -np.where(swap, c, s)
    # Times (-i)^q: (re, im) -> (im, -re) per quarter turn.
    out = np.empty(re.shape, dtype=np.complex128)
    for turns, (a, bb) in enumerate(((re, im), (im, -re), (-re, -im), (-im, re))):
        sel = q == turns
        out.real[sel], out.imag[sel] = a[sel], bb[sel]
    return out


def twiddle_factors(b: int) -> np.ndarray:
    """Float64 factored twiddle, [lo rows + hi rows, N2] (:func:`twiddle_rows`):
    lo[k_lo, c] = exp(-2*pi*i * k_lo * c / B), then hi[k_hi, c] =
    exp(-2*pi*i * k_hi * 2^h * c / B) (:func:`unit_roots`), so that
    four_step_twiddle(b)[pos, c] = hi[k1 >> h, c] * lo[k1 & (2^h - 1), c]
    with k1 = bitrev(pos)."""
    lo_rows, hi_rows = twiddle_rows(b)
    c = np.arange(split_shape(b)[1], dtype=np.int64)[None, :]
    k = np.concatenate([np.arange(lo_rows, dtype=np.int64),
                        np.arange(hi_rows, dtype=np.int64) * lo_rows])
    return unit_roots(k[:, None] * c, b)


def _on(t: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(t)).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=8)
def full_twiddle(b: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`four_step_twiddle` rounded to ``dtype`` on ``device``, for the
    plain versions (and the probe kernels that read it whole)."""
    return _on(four_step_twiddle(b), dtype, device)


@functools.lru_cache(maxsize=8)
def kernel_tables(b: int, dtype: torch.dtype, device: torch.device):
    """The kernel's constant tables, computed in float64 on the host and
    rounded to ``dtype`` (complex64 / complex128) on ``device``:

    - ``tw4``: the four-step twiddle as the column passes read it
      (:func:`twiddle_layout`): where factored, the two factor tables of
      :func:`twiddle_factors`, else the full [N1, N2]
      :func:`four_step_twiddle`;
    - ``w1`` [N1/2], ``w2`` [N2/2]: exp(-2*pi*i * k / N) of each side's FFT.
    """
    n1, n2 = split_shape(b)

    def roots(n):
        return np.exp(-2j * np.pi * np.arange(n // 2) / n)

    factored = twiddle_layout(b, dtype)["factored"]
    tw4 = twiddle_factors(b) if factored else four_step_twiddle(b)
    return tuple(_on(t, dtype, device) for t in (tw4, roots(n1), roots(n2)))


def windows(x: torch.Tensor, b: int, hop: int, left: int, nb: int) -> torch.Tensor:
    """[C, nb, B] view of the overlapped windows of [C, n_in]: window j of
    channel c is xp[c, j*hop : j*hop + B] of xp = [left zeros | x | zeros]."""
    need = (nb - 1) * hop + b
    xp = F.pad(x, (left, max(0, need - left - x.shape[1])))[:, :need]
    return xp.unfold(1, b, hop)


def _check(x: torch.Tensor, plan, left: int, out_len: int, i16_io: bool):
    if not qualifies(plan.num_taps, plan.block_size):
        raise ValueError(
            f"segment filter does not take num_taps={plan.num_taps}, "
            f"B={plan.block_size} (needs odd taps, B a power of two > M)")
    if i16_io and plan.precision != FAST:
        raise ValueError("16-bit I/O runs float32 arithmetic: it needs a "
                         f"'fast' plan, got {plan.precision!r}")
    want = torch.int16 if i16_io else torch.float32
    if x.dtype != want:
        raise TypeError(f"segment filter input must be {want}, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"segment filter input must be [C, N], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("segment filter input must be contiguous")
    if x.device != plan.H.device:
        raise ValueError(f"input on {x.device} but the plan's spectrum is on "
                         f"{plan.H.device}")
    if left < 0 or out_len < 0:
        raise ValueError(f"left ({left}) and out_len ({out_len}) must be >= 0")


def segment_filter(x: torch.Tensor, plan, left: int, out_len: int,
                   i16_io: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Filter [C, n_in] into (y [C, out_len], peak) — see the module
    docstring for the formula. ``y`` has ``x``'s dtype (float32, or int16
    with ``i16_io``); ``peak`` is a 0-d float32 tensor on ``x``'s device
    (for int16 the peak of |PCM code|). CUDA tensors run the kernel, CPU
    tensors :func:`reference`."""
    if x.device.type == "cuda":
        return _launch(x, plan, left, out_len, i16_io)
    _check(x, plan, left, out_len, i16_io)
    if x.device.type != "cpu":
        raise ValueError(f"segment filter runs on 'cuda' or 'cpu', not {x.device}")
    return reference(x, plan, left, out_len, i16_io)


def mode_of(plan, i16_io: bool = False) -> str:
    """The kernel mode of a call: ``i16``, ``f64`` (a ``high`` plan) or
    ``f32``."""
    if i16_io:
        return "i16"
    return "f64" if plan.precision == HIGH else "f32"


def _launch(x, plan, left, out_len, i16_io):
    with spans.span("segment.prepare") as prep:
        _check(x, plan, left, out_len, i16_io)
        mode = mode_of(plan, i16_io)
        c = x.shape[0]
        y = torch.empty((c, out_len), dtype=x.dtype, device=x.device)
        words = peak_words(x.device)
        if c == 0 or out_len == 0:
            return y, words[0]
        kernels[mode] += run_entry("segment_filter", f"lowcut_segment_filter_{mode}",
                                   x, y, words, plan, left, out_len, prep=prep)
    launches[mode] += 1
    return y, words[0]


def peak_words(device) -> torch.Tensor:
    """The zeroed :data:`PEAK_WORDS` float32 words a call's entry point
    takes as ``peak``; element 0 holds the peak once the call ran."""
    return torch.zeros(PEAK_WORDS, dtype=torch.float32, device=device)


def run_entry(lib: str, entry: str, x, y, peak, plan, left: int, out_len: int,
              *extra, prep=spans.NULL) -> int:
    """Launch ``entry`` of ``csrc/<lib>.cu`` on x's device with the segment
    filter's arguments (``peak`` the words of :func:`peak_words`, its
    tables, a scratch chunk, the split) and
    ``extra`` before the stream: the shipped kernel, or the ablation probe
    (``csrc/probe_segment.cu``, which adds a variant id). ``prep``, the
    caller's open ``segment.prepare`` span, gets the scratch bytes and ends
    here; the entry point is called in the span ``segment.launch``, which
    gets what the host decided: the kernel mode (``mode``: ``f32``,
    ``f64`` or ``i16``, the entry's suffix), the chunks, the kernels, the
    split (``log_n1``, ``log_n2``), the pairs the call filters (``pairs``)
    and a chunk holds (``chunk_pairs``); and what the library reports: the
    ring depths of passes 1, 2 and 3 (``pass1_ring``, ``pass2_ring``,
    ``pass3_ring``, 0 without a ring; :func:`pass1_occupancy`,
    :func:`pass2_occupancy`, :func:`pass3_occupancy`).
    Returns the kernels it launched; raises if the launch failed."""
    from . import _build

    dev = x.device
    c, n_in = x.shape
    b, m = plan.block_size, plan.m
    H = plan.H
    if H.shape != split_shape(b) or not H.is_contiguous():
        raise ValueError(f"plan spectrum must be contiguous {split_shape(b)}")
    tw4, w1, w2 = kernel_tables(b, H.dtype, dev)
    pairs = call_pairs(c, out_len, b - m)
    chunk = scratch_pairs(pairs, b, H.element_size())
    scratch = torch.empty((chunk, b), dtype=H.dtype, device=dev)
    l1, l2 = split(b)
    fn = getattr(_build.library(lib), entry)
    chunks = entry_chunks(pairs, chunk)
    if prep:
        prep.set(scratch_bytes=scratch.nbytes)
    prep.end()
    with spans.span("segment.launch") as s, torch.cuda.device(dev):
        if s:
            mode, card = entry.rsplit("_", 1)[1], dev.index or 0
            s.set(mode=mode, chunks=chunks, kernels=KERNELS_PER_CHUNK * chunks,
                  log_n1=l1, log_n2=l2, pairs=pairs, chunk_pairs=chunk,
                  pass1_ring=pass1_occupancy(mode, b, card)["ring_depth"],
                  pass2_ring=pass2_occupancy(mode, b, card)["ring_depth"],
                  pass3_ring=pass3_occupancy(mode, b, card)["ring_depth"])
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), peak.data_ptr(), H.data_ptr(),
                tw4.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                scratch.data_ptr(), c, n_in, out_len, left, m, l1, l2,
                chunk, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"segment filter kernel {entry} failed: "
                           f"CUDA error {rc}")
    return KERNELS_PER_CHUNK * chunks


def reference(x: torch.Tensor, plan, left: int, out_len: int,
              i16_io: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, same contract: overlapped
    blocks by ``F.pad`` + ``Tensor.unfold``, ``rfft`` * H * ``irfft``,
    positions [M, B) kept. Float64 arithmetic for a ``high`` plan, float32
    otherwise (and for 16-bit I/O). Runs on any device."""
    b, m = plan.block_size, plan.m
    hop = b - m
    c = x.shape[0]
    high = plan.precision == HIGH and not i16_io
    rdt = torch.float64 if high else torch.float32
    xf = x.to(rdt) / 32768.0 if i16_io else x.to(rdt)
    nb = -(-out_len // hop)
    if nb == 0 or c == 0:
        y = torch.empty((c, out_len), dtype=x.dtype, device=x.device)
        return y, torch.zeros((), dtype=torch.float32, device=x.device)
    spec = torch.fft.rfft(windows(xf, b, hop, left, nb)) * natural_spectrum(plan.H)
    yb = torch.fft.irfft(spec, n=b)[..., m:]           # [C, nb, hop]
    y = yb.reshape(c, nb * hop)[:, :out_len].to(torch.float32)
    if i16_io:
        q = torch.clamp(torch.round(y * 32768.0), -32768.0, 32767.0)
        return q.to(torch.int16), q.abs().max().to(torch.float32)
    return y.contiguous(), y.abs().max()

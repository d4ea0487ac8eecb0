"""Circular convolution of real blocks: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``pallas_conv_real_blocks`` and its XLA mirror
``_conv_xla_mirror`` in ``audio_fir_filter_tpu/ops/pallas_fft.py``: the
generic block path of overlap-save. For blocks [nb, B] float32 (nb even)
and a plan whose ``H`` is the spectrum of the reversed, zero-padded taps in
the kernel's layout (:func:`.segment_filter.spectrum_layout`), it returns
[nb, B] float32: each block's circular convolution with the taps at every
position [0, B) — the aliased head [0, M) included, which the caller drops.

The kernel (``csrc/conv_blocks.cu``) packs blocks 2k and 2k + 1 into one
complex FFT and shares its four-step passes and host tables
(:func:`.segment_filter.kernel_tables`) with the segment filter. Modes:
``f32`` for a ``fast`` plan, ``f64`` (float64 arithmetic) for ``high``.

The wrapper's rule: a CUDA tensor launches the kernel (and raises if the
launch fails); a CPU tensor takes the plain version (:func:`reference`).
"""

from __future__ import annotations

import torch

from . import segment_filter as sf

# Per mode, counted by :func:`conv_real_blocks` where it calls the C entry
# point and nowhere else: ``launches``, the calls of the C entry point,
# and ``kernels``, the kernels those calls issued (three passes for each
# scratch chunk of the entry's loop, ``csrc/conv_blocks.cu``), reckoned on
# the host from the same chunking.
launches = {"f32": 0, "f64": 0}
kernels = {"f32": 0, "f64": 0}


def _check(blocks: torch.Tensor, plan) -> None:
    b = plan.block_size
    if blocks.dtype != torch.float32:
        raise ValueError(f"blocks must be float32, got {blocks.dtype}")
    if blocks.dim() != 2 or blocks.shape[1] != b:
        raise ValueError(f"blocks must be [nb, {b}], got {tuple(blocks.shape)}")
    if blocks.shape[0] % 2:
        raise ValueError(f"the block count must be even (two real blocks per "
                         f"complex FFT), got {blocks.shape[0]}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    if blocks.device != plan.H.device:
        raise ValueError(f"blocks on {blocks.device} but the plan's spectrum "
                         f"is on {plan.H.device}")


def conv_real_blocks(blocks: torch.Tensor, plan) -> torch.Tensor:
    """[nb (even), B] float32 -> [nb, B] float32 circular convolutions with
    the plan's taps. CUDA tensors run the kernel, CPU tensors
    :func:`reference`."""
    _check(blocks, plan)
    if blocks.shape[0] == 0:
        return torch.empty_like(blocks)
    if blocks.device.type == "cpu":
        return reference(blocks, plan)
    if blocks.device.type != "cuda":
        raise ValueError(f"block convolution runs on 'cuda' or 'cpu', not "
                         f"{blocks.device}")
    return _launch(blocks, plan)


def _launch(blocks: torch.Tensor, plan) -> torch.Tensor:
    from . import _build

    mode = "f64" if plan.precision == sf.HIGH else "f32"
    dev = blocks.device
    nb, b = blocks.shape
    out = torch.empty_like(blocks)
    H = plan.H
    if H.shape != sf.split_shape(b) or not H.is_contiguous():
        raise ValueError(f"plan spectrum must be contiguous {sf.split_shape(b)}")
    tw4, w1, w2 = sf.kernel_tables(b, H.dtype, dev)
    pairs = nb // 2
    chunk = sf.scratch_pairs(pairs, b, H.element_size())
    scratch = torch.empty((chunk, b), dtype=H.dtype, device=dev)
    l1, l2 = sf.split(b)
    fn = getattr(_build.library("conv_blocks"), f"lowcut_conv_blocks_{mode}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(blocks.data_ptr(), out.data_ptr(), H.data_ptr(),
                tw4.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                scratch.data_ptr(), nb, l1, l2, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"block convolution kernel ({mode}) failed: "
                           f"CUDA error {rc}")
    launches[mode] += 1
    kernels[mode] += sf.KERNELS_PER_CHUNK * sf.entry_chunks(pairs, chunk)
    return out


_PASSES = ("pass 1", "pass 2", "pass 3")
_OCC_KEYS = ("ctas_per_sm", "threads", "smem_bytes", "registers", "local_bytes")


def occupancy(b: int, precision: str) -> dict:
    """The kernel's three passes at block size ``b`` on the current card:
    per pass the CTAs an SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    threads per CTA, dynamic shared bytes, registers and local-memory
    (stack and spill) bytes per thread. Builds the kernel; needs a card."""
    import ctypes

    from . import _build

    fn = _build.library("conv_blocks").lowcut_conv_blocks_occupancy
    out = (ctypes.c_int * 15)()
    l1, l2 = sf.split(b)
    rc = fn(l1, l2, int(precision == sf.HIGH), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return {p: dict(zip(_OCC_KEYS, out[5 * i : 5 * i + 5]))
            for i, p in enumerate(_PASSES)}


def reference(blocks: torch.Tensor, plan) -> torch.Tensor:
    """The plain PyTorch version, same contract: ``rfft(blocks) *
    natural_spectrum(H)`` then ``irfft(n=B)``, in float64 for a ``high``
    plan and float32 for ``fast``. Runs on any device."""
    rdt = torch.float64 if plan.precision == sf.HIGH else torch.float32
    spec = torch.fft.rfft(blocks.to(rdt)) * sf.natural_spectrum(plan.H)
    return torch.fft.irfft(spec, n=plan.block_size).to(torch.float32)

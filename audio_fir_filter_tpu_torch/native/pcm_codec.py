"""ctypes loader for the native PCM codec (pcm_codec.cpp).

The port's copy of ``audio_fir_filter_tpu/native/pcm_codec.py``. Builds the
shared library on first use with g++ (plain C ABI + ctypes), into
``build/lowcut_torch/_pcm_codec.so`` beside the package (a directory git
ignores, next to the CUDA libraries), never next to the source. The build
targets the architecture's baseline (no ``-march=native``), so a library
carried to another host of the same architecture still runs there; it is
rebuilt when the source or this file (its flags) is newer. If the build or
the load fails, the codec falls back to NumPy (audio/codec.py checks for
None); :func:`native_loaded` says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "pcm_codec.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "lowcut_torch")
_SO = os.path.join(_BUILD_DIR, "_pcm_codec.so")


def _build() -> str | None:
    newest = max(os.path.getmtime(_SRC), os.path.getmtime(__file__))
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= newest:
        return _SO
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # Build to a temporary name, then rename: concurrent first uses
        # never load a half-written library.
        tmp = f"{_SO}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO)
        return _SO
    except (OSError, subprocess.SubprocessError):
        return None


class _NativeCodec:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        for name, args in [
            ("decode_pcm16", (u8p, ctypes.c_int64, ctypes.c_int, f32p)),
            ("decode_pcm24", (u8p, ctypes.c_int64, ctypes.c_int, f32p)),
            ("encode_pcm16", (f32p, ctypes.c_int64, ctypes.c_int, u8p)),
            ("encode_pcm24", (f32p, ctypes.c_int64, ctypes.c_int, u8p)),
            ("decode_pcm_planar",
             (u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, f32p)),
            ("encode_pcm_planar",
             (f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, u8p)),
        ]:
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = None
        lib.peak_abs_f32.argtypes = [f32p, ctypes.c_int64]
        lib.peak_abs_f32.restype = ctypes.c_float

    def decode(self, raw: np.ndarray, bits: int, big_endian: bool) -> np.ndarray:
        bps = bits // 8
        n = raw.size // bps
        out = np.empty(n, dtype=np.float32)
        fn = self._lib.decode_pcm16 if bits == 16 else self._lib.decode_pcm24
        fn(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
           int(big_endian), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def encode(self, samples: np.ndarray, bits: int, big_endian: bool) -> bytes:
        bps = bits // 8
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        out = np.empty(samples.size * bps, dtype=np.uint8)
        fn = self._lib.encode_pcm16 if bits == 16 else self._lib.encode_pcm24
        fn(samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), samples.size,
           int(big_endian), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.tobytes()

    def peak(self, samples: np.ndarray) -> float:
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        return float(self._lib.peak_abs_f32(
            samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), samples.size))

    def decode_planar(self, raw: np.ndarray, channels: int, bits: int,
                      big_endian: bool, threads: int = 0) -> np.ndarray:
        """Interleaved PCM bytes -> planar float32 [channels, frames] in one
        fused pass (codec + deinterleave), fanned across C++ threads.
        threads <= 0 uses the reference's 0.7 x cores default."""
        bps = bits // 8
        frames = raw.size // (bps * channels)
        out = np.empty((channels, frames), dtype=np.float32)
        self._lib.decode_pcm_planar(
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), frames,
            channels, bits, int(big_endian), int(threads),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def encode_planar(self, samples: np.ndarray, bits: int,
                      big_endian: bool, threads: int = 0) -> bytes:
        """Planar float32 [channels, frames] -> interleaved PCM bytes in one
        fused pass (interleave + quantize)."""
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        channels, frames = samples.shape
        out = np.empty(frames * channels * (bits // 8), dtype=np.uint8)
        self._lib.encode_pcm_planar(
            samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frames,
            channels, bits, int(big_endian), int(threads),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        # Zero-copy bytes-like (the payload of a 1-h recording is ~GB scale;
        # tobytes() would be a full extra pass). Read-only view keeps the
        # Chunk payload immutable like bytes.
        mv = out.data
        mv = mv.toreadonly() if hasattr(mv, "toreadonly") else mv
        return mv


def load() -> _NativeCodec | None:
    if os.environ.get("LOWCUT_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    try:
        return _NativeCodec(ctypes.CDLL(so))
    except OSError:
        return None


def native_loaded() -> bool:
    """Whether the codec in use is the native one (False: the NumPy
    fallback, because the build or load failed or ``LOWCUT_NO_NATIVE`` is
    set)."""
    from ..audio import codec

    return codec._get_native() is not None

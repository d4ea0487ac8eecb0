"""Build WAVE/AIFF files from scratch (test fixtures, synthesis, bench).

The reference never creates containers from nothing (it always copies input
chunks, ProcessFile.cp:107-110), but its tests would need fixtures — and so
do ours (SURVEY.md §4: synthesized WAV/AIFF fixtures).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from . import codec
from .chunks import AIFF, WAVE, Chunk, Container, write_container
from .format import AudioFormat, Encoding, _encode_ext80
from ..utils.errors import AudioFormatError

_WAVE_TAG = {
    Encoding.PCM_U8: 1, Encoding.PCM_16: 1, Encoding.PCM_24: 1,
    Encoding.PCM_32: 1, Encoding.FLOAT_32: 3, Encoding.FLOAT_64: 3,
}


def make_format(kind: str, channels: int, sample_rate: float,
                encoding: Encoding, num_frames: int | None = None) -> AudioFormat:
    fmt = AudioFormat(channels=channels, sample_rate=float(sample_rate),
                      encoding=encoding, num_frames=num_frames)
    fmt._kind = kind
    return fmt


def build_container(samples: np.ndarray, sample_rate: float, kind: str,
                    encoding: Encoding,
                    extra_chunks: list[Chunk] | None = None) -> Container:
    """Serialize planar float32 [ch, frames] into a fresh container."""
    channels, frames = samples.shape
    fmt = make_format(kind, channels, sample_rate, encoding, frames)
    payload = codec.encode(samples.astype(np.float32), fmt)
    bps = encoding.bytes_per_sample

    if kind == WAVE:
        if encoding == Encoding.PCM_S8:
            raise AudioFormatError("WAVE 8-bit is unsigned (use PCM_U8)")
        tag = _WAVE_TAG[encoding]
        block_align = channels * bps
        fmt_data = struct.pack(
            "<HHIIHH", tag, channels, int(sample_rate),
            int(sample_rate) * block_align, block_align, bps * 8,
        )
        chunks = [Chunk(b"fmt ", fmt_data)]
        chunks += list(extra_chunks or [])
        chunks.append(Chunk(b"data", payload))
        return Container(kind=WAVE, form_type=b"WAVE", chunks=chunks)

    if kind == AIFF:
        if encoding in (Encoding.PCM_U8, Encoding.FLOAT_32, Encoding.FLOAT_64):
            raise AudioFormatError(f"AIFF does not support {encoding}")
        comm = struct.pack(">hIh", channels, frames, bps * 8) + _encode_ext80(sample_rate)
        ssnd = struct.pack(">II", 0, 0) + payload
        chunks = [Chunk(b"COMM", comm)]
        chunks += list(extra_chunks or [])
        chunks.append(Chunk(b"SSND", ssnd))
        return Container(kind=AIFF, form_type=b"AIFF", chunks=chunks)

    raise AudioFormatError(f"Unknown container kind: {kind}")


def create_audio_file(path, samples: np.ndarray, sample_rate: float,
                      kind: str | None = None,
                      encoding: Encoding = Encoding.PCM_16,
                      extra_chunks: list[Chunk] | None = None) -> None:
    """Write planar float32 samples to a new WAVE/AIFF file.

    ``kind`` defaults from the path extension (.wav -> WAVE, .aif/.aiff -> AIFF),
    matching the CLI's extension-driven behavior.
    """
    p = Path(path)
    if kind is None:
        ext = p.suffix.lower()
        if ext == ".wav":
            kind = WAVE
        elif ext in (".aif", ".aiff"):
            kind = AIFF
        else:
            raise AudioFormatError(f"Cannot infer container kind from {ext!r}")
    container = build_container(samples, sample_rate, kind, encoding, extra_chunks)
    with open(p, "wb") as f:
        write_container(f, container)

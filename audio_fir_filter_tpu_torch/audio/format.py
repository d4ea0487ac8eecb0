"""Audio format decoding (WAVE ``fmt `` / AIFF ``COMM`` chunks).

Host-side equivalent of the reference's c_lib ``AudioFormat`` (interface
reconstructed in SURVEY.md §2.2: ``channels()`` at ProcessFile.cp:43,
``sampleRate()`` at ProcessFile.cp:49, plus the bit depth / encoding the
codec needs).
"""

from __future__ import annotations

import dataclasses
import enum
import struct

from .chunks import AIFF, WAVE, Container
from ..utils.errors import AudioFormatError


class Encoding(enum.Enum):
    PCM_U8 = "pcm_u8"      # WAVE 8-bit (unsigned)
    PCM_S8 = "pcm_s8"      # AIFF 8-bit (signed)
    PCM_16 = "pcm_16"
    PCM_24 = "pcm_24"
    PCM_32 = "pcm_32"
    FLOAT_32 = "float_32"
    FLOAT_64 = "float_64"

    @property
    def bytes_per_sample(self) -> int:
        return {
            Encoding.PCM_U8: 1, Encoding.PCM_S8: 1, Encoding.PCM_16: 2,
            Encoding.PCM_24: 3, Encoding.PCM_32: 4, Encoding.FLOAT_32: 4,
            Encoding.FLOAT_64: 8,
        }[self]

    @property
    def bits(self) -> int:
        return self.bytes_per_sample * 8


_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE
# First 2 bytes of the EXTENSIBLE SubFormat GUID carry the base format tag.


@dataclasses.dataclass
class AudioFormat:
    channels: int
    sample_rate: float
    encoding: Encoding
    num_frames: int | None = None   # AIFF COMM carries this; WAVE derives from data size
    # AIFC compression type (b"NONE" / b"sowt"); None for WAVE / plain AIFF.
    aifc_compression: bytes | None = None

    @property
    def bits_per_sample(self) -> int:
        return self.encoding.bits

    @property
    def bytes_per_frame(self) -> int:
        return self.channels * self.encoding.bytes_per_sample

    @property
    def big_endian_samples(self) -> bool:
        # AIFF PCM is big-endian except AIFC 'sowt' (byte-swapped PCM16).
        return self.aifc_compression != b"sowt" and self._kind == AIFF

    _kind: str = WAVE  # set by from_container


def _decode_ext80(b: bytes) -> float:
    """Decode an 80-bit IEEE 754 extended float (AIFF sample rate)."""
    if len(b) != 10:
        raise AudioFormatError("extended float must be 10 bytes")
    (se,) = struct.unpack(">H", b[0:2])
    (mant,) = struct.unpack(">Q", b[2:10])
    sign = -1.0 if (se & 0x8000) else 1.0
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    if exp == 0x7FFF:
        raise AudioFormatError("non-finite extended-float sample rate")
    return sign * mant * 2.0 ** (exp - 16383 - 63)


def _encode_ext80(x: float) -> bytes:
    """Encode a float as an 80-bit IEEE 754 extended float."""
    if x == 0.0:
        return b"\x00" * 10
    sign = 0x8000 if x < 0 else 0
    x = abs(x)
    import math

    mant, e = math.frexp(x)  # x = mant * 2**e, mant in [0.5, 1)
    exp = e - 1 + 16383
    mant_bits = int(mant * (1 << 64))  # top bit set since mant >= 0.5
    return struct.pack(">HQ", sign | exp, mant_bits)


def _parse_wave_fmt(data: bytes) -> AudioFormat:
    if len(data) < 16:
        raise AudioFormatError("fmt chunk too small")
    tag, channels, rate, _byte_rate, _block_align, bits = struct.unpack(
        "<HHIIHH", data[:16]
    )
    if tag == _WAVE_FORMAT_EXTENSIBLE:
        if len(data) < 26:
            raise AudioFormatError("WAVE_FORMAT_EXTENSIBLE fmt chunk too small")
        (tag,) = struct.unpack("<H", data[24:26])  # SubFormat GUID leading tag

    if tag == _WAVE_FORMAT_PCM:
        enc = {8: Encoding.PCM_U8, 16: Encoding.PCM_16,
               24: Encoding.PCM_24, 32: Encoding.PCM_32}.get(bits)
        if enc is None:
            raise AudioFormatError(f"Unsupported WAVE PCM bit depth: {bits}")
    elif tag == _WAVE_FORMAT_IEEE_FLOAT:
        enc = {32: Encoding.FLOAT_32, 64: Encoding.FLOAT_64}.get(bits)
        if enc is None:
            raise AudioFormatError(f"Unsupported WAVE float bit depth: {bits}")
    else:
        raise AudioFormatError(f"Unsupported WAVE format tag: 0x{tag:04x}")
    fmt = AudioFormat(channels=channels, sample_rate=float(rate), encoding=enc)
    fmt._kind = WAVE
    return fmt


def _parse_aiff_comm(data: bytes, form_type: bytes) -> AudioFormat:
    if len(data) < 18:
        raise AudioFormatError("COMM chunk too small")
    channels, num_frames, bits = struct.unpack(">hIh", data[:8])
    rate = _decode_ext80(data[8:18])
    compression = None
    if form_type == b"AIFC":
        if len(data) < 22:
            raise AudioFormatError("AIFC COMM chunk missing compression type")
        compression = data[18:22]
        if compression not in (b"NONE", b"sowt"):
            raise AudioFormatError(
                f"Unsupported AIFC compression: {compression!r}"
            )
    enc = {8: Encoding.PCM_S8, 16: Encoding.PCM_16,
           24: Encoding.PCM_24, 32: Encoding.PCM_32}.get(bits)
    if enc is None:
        raise AudioFormatError(f"Unsupported AIFF bit depth: {bits}")
    fmt = AudioFormat(
        channels=channels, sample_rate=rate, encoding=enc,
        num_frames=num_frames, aifc_compression=compression,
    )
    fmt._kind = AIFF
    return fmt


def format_from_container(container: Container) -> AudioFormat:
    if container.kind == WAVE:
        fmt_chunk = container.find(b"fmt ")
        if fmt_chunk is None:
            raise AudioFormatError("WAVE file has no fmt chunk")
        return _parse_wave_fmt(fmt_chunk.data)
    comm = container.find(b"COMM")
    if comm is None:
        raise AudioFormatError("AIFF file has no COMM chunk")
    return _parse_aiff_comm(comm.data, container.form_type)

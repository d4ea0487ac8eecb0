"""Container (RIFF/WAVE and IFF/AIFF) chunk model.

Host-side equivalent of the reference's c_lib ``AudioFile`` (interface
reconstructed in SURVEY.md §2.2 from the reference's ProcessFile.cp:34,105-112):
a parser/writer that exposes the container as an *ordered list of raw
chunks* so that every non-audio chunk can be copied to the output verbatim
("Metadata Preservation", the reference's README.md:9).

WAVE is a RIFF form (little-endian sizes); AIFF/AIFC is an EA-IFF-85 FORM
(big-endian sizes). In both, chunks are ``<4-byte id><u32 size><payload>``
padded to even length; the pad byte is not counted in ``size``. We preserve
odd-sized chunks and their pad bytes byte-exactly on round-trip.
"""

from __future__ import annotations

import dataclasses
import struct

from ..utils.errors import AudioFormatError

WAVE = "wave"
AIFF = "aiff"

# File kind <-> (container magic, form type candidates, endianness)
_KIND_INFO = {
    WAVE: (b"RIFF", (b"WAVE",), "<"),
    AIFF: (b"FORM", (b"AIFF", b"AIFC"), ">"),
}


@dataclasses.dataclass
class Chunk:
    """One raw container chunk: 4-byte id + payload (without pad byte)."""

    ckid: bytes
    data: bytes

    def __post_init__(self):
        if len(self.ckid) != 4:
            raise AudioFormatError(f"Chunk id must be 4 bytes, got {self.ckid!r}")

    @property
    def size(self) -> int:
        return len(self.data)


@dataclasses.dataclass
class StreamedChunk:
    """A chunk whose payload is produced by ``writer(f)`` at serialization
    time; ``size`` must be known upfront (it goes in the chunk header before
    the payload exists). Used to stream GB-scale sample payloads to disk
    overlapped with their encoding instead of materializing them
    (:func:`..file.write_audio`)."""

    ckid: bytes
    size: int
    writer: object  # Callable[[BinaryIO], None]

    def __post_init__(self):
        if len(self.ckid) != 4:
            raise AudioFormatError(f"Chunk id must be 4 bytes, got {self.ckid!r}")


@dataclasses.dataclass
class Container:
    """Parsed container: kind ('wave' | 'aiff'), form type, ordered chunks."""

    kind: str
    form_type: bytes  # b"WAVE", b"AIFF", or b"AIFC"
    chunks: list[Chunk]

    @property
    def endian(self) -> str:
        return _KIND_INFO[self.kind][2]

    def find(self, ckid: bytes) -> Chunk | None:
        for c in self.chunks:
            if c.ckid == ckid:
                return c
        return None

    def find_index(self, ckid: bytes) -> int:
        for i, c in enumerate(self.chunks):
            if c.ckid == ckid:
                return i
        raise AudioFormatError(f"Required chunk {ckid!r} not found")


def parse_container(raw: bytes) -> Container:
    """Parse a WAVE or AIFF file image into an ordered chunk list."""
    if len(raw) < 12:
        raise AudioFormatError("File too small to be a WAVE or AIFF file")
    magic = raw[0:4]
    if magic == b"RIFF":
        kind = WAVE
    elif magic == b"FORM":
        kind = AIFF
    else:
        raise AudioFormatError(
            f"Not a WAVE or AIFF file (container magic {magic!r})"
        )
    _, form_types, endian = _KIND_INFO[kind]
    form_type = raw[8:12]
    if form_type not in form_types:
        raise AudioFormatError(
            f"Unsupported form type {form_type!r} for {kind.upper()} container"
        )

    chunks: list[Chunk] = []
    pos = 12
    end = len(raw)
    # Be lenient about the outer RIFF/FORM size (files in the wild often get
    # it wrong); walk chunks to EOF instead.
    while pos + 8 <= end:
        ckid = raw[pos : pos + 4]
        (size,) = struct.unpack(endian + "I", raw[pos + 4 : pos + 8])
        payload_start = pos + 8
        payload_end = payload_start + size
        if payload_end > end:
            # Truncated final chunk: clamp (matches common tolerant readers).
            payload_end = end
        chunks.append(Chunk(ckid, raw[payload_start:payload_end]))
        pos = payload_end + (size & 1)  # skip pad byte after odd-sized chunk
    return Container(kind=kind, form_type=form_type, chunks=chunks)


def write_container(f, container: Container) -> None:
    """Stream-serialize to a binary file object, preserving chunk order and
    pad bytes. No intermediate blob: the data chunk of a long recording is
    hundreds of MB, and building a bytes image first costs two extra full
    copies (measured dominating write_audio at 1-hour scale). ``c.data``
    may be any buffer (bytes, memoryview, ndarray); a :class:`StreamedChunk`
    writes its payload through ``writer(f)`` in place."""
    endian = container.endian
    magic = _KIND_INFO[container.kind][0]
    total = 4 + sum(8 + c.size + (c.size & 1) for c in container.chunks)
    # Both RIFF and IFF carry u32 sizes; a 2-h 96 kHz 24-bit stereo file
    # already exceeds them. Fail typed and EARLY — before any payload is
    # serialized — rather than letting struct.pack raise mid-write
    # (RF64/W64 are deliberate non-goals: the reference supports neither).
    limit = 0xFFFFFFFF
    oversized = [c for c in container.chunks if c.size > limit]
    if total > limit or oversized:
        detail = (f"chunk {oversized[0].ckid!r} payload {oversized[0].size}"
                  if oversized else f"container payload {total}")
        raise AudioFormatError(
            f"output exceeds the 4 GB {magic.decode()} u32 size limit "
            f"({detail} bytes > {limit}); split the recording or use a "
            "smaller bit depth")
    f.write(magic + struct.pack(endian + "I", total) + container.form_type)
    for c in container.chunks:
        f.write(c.ckid)
        f.write(struct.pack(endian + "I", c.size))
        if isinstance(c, StreamedChunk):
            c.writer(f)
        else:
            f.write(c.data)
        if c.size & 1:
            f.write(b"\x00")


def scan_container(f) -> tuple[str, bytes, list[tuple[bytes, int, int]]]:
    """Chunk table of an open seekable binary file WITHOUT reading payloads.

    Returns ``(kind, form_type, entries)`` with ``entries`` =
    ``[(ckid, payload_offset, size), ...]`` in file order. Sizes follow the
    same tolerance rules as :func:`parse_container`: the outer RIFF/FORM size
    is ignored (chunks walked to EOF) and a final chunk whose declared size
    runs past EOF is clamped. The seek-based walk lets GB-scale sample
    payloads be streamed/decoded incrementally instead of read whole
    (:func:`..file.read_audio`)."""
    f.seek(0, 2)
    end = f.tell()
    f.seek(0)
    header = f.read(12)
    if len(header) < 12:
        raise AudioFormatError("File too small to be a WAVE or AIFF file")
    magic = header[0:4]
    if magic == b"RIFF":
        kind = WAVE
    elif magic == b"FORM":
        kind = AIFF
    else:
        raise AudioFormatError(
            f"Not a WAVE or AIFF file (container magic {magic!r})"
        )
    _, form_types, endian = _KIND_INFO[kind]
    form_type = header[8:12]
    if form_type not in form_types:
        raise AudioFormatError(
            f"Unsupported form type {form_type!r} for {kind.upper()} container"
        )
    entries: list[tuple[bytes, int, int]] = []
    pos = 12
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(8)
        ckid = head[0:4]
        (size,) = struct.unpack(endian + "I", head[4:8])
        payload_start = pos + 8
        size = min(size, end - payload_start)  # truncated-final-chunk clamp
        entries.append((ckid, payload_start, size))
        pos = payload_start + size + (size & 1)
    return kind, form_type, entries


def serialize_container(container: Container) -> bytes:
    """Serialize back to bytes (in-memory form of :func:`write_container`)."""
    import io

    buf = io.BytesIO()
    write_container(buf, container)
    return buf.getvalue()

"""High-level audio file read/write with byte-exact metadata preservation.

Combines the chunk walker, format decoder, and PCM codec into the equivalent
of the reference flow at ProcessFile.cp:34-44 (read) and
:105-117 (write): the output file contains *every* input chunk in the
original order — unknown chunks copied verbatim — with only the sample
payload (WAVE ``data`` / AIFF ``SSND``) replaced by the re-encoded samples.

Writes are atomic (temp file + rename), an improvement over the reference
which can leave partially-written outputs on failure (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import struct
import tempfile
import threading
from pathlib import Path

import numpy as np

from . import codec
from .chunks import (AIFF, WAVE, Chunk, Container, StreamedChunk,
                     parse_container, scan_container, write_container)
from .format import AudioFormat, format_from_container
from ..utils.errors import AudioFormatError, FileNotFound

_DATA_CHUNK_ID = {WAVE: b"data", AIFF: b"SSND"}

# Sample payloads above this stream through slab-sized buffers with disk I/O
# overlapped against the (threaded, GIL-releasing) codec, instead of holding
# the raw payload AND the decoded floats in memory at once. At 1-hour
# 96 kHz stereo 24-bit scale this removes a 2 GB resident payload and cuts
# the read stage from disk+codec serialized toward max(disk, codec)
# (measured e2e decomposition, bench_artifacts/e2e_r02.txt).
_STREAM_MIN_BYTES = 64 << 20
_SLAB_BYTES = 32 << 20


@dataclasses.dataclass
class AudioData:
    """A fully-read audio file: container (all chunks), format, samples.

    ``samples`` is planar float32 [channels, frames], full scale ±1.0 —
    the analog of the reference's deinterleaved ``AudioBuffer``
    (ProcessFile.cp:41-44).
    """

    container: Container
    fmt: AudioFormat
    samples: np.ndarray

    @property
    def num_channels(self) -> int:
        return self.samples.shape[0]

    @property
    def num_frames(self) -> int:
        return self.samples.shape[1]

    @property
    def kind(self) -> str:
        return self.container.kind


def _extract_sample_bytes(container: Container) -> bytes:
    ckid = _DATA_CHUNK_ID[container.kind]
    chunk = container.find(ckid)
    if chunk is None:
        raise AudioFormatError(f"No {ckid.decode()} chunk found")
    if container.kind == AIFF:
        if len(chunk.data) < 8:
            raise AudioFormatError("SSND chunk too small")
        offset, _block_size = struct.unpack(">II", chunk.data[:8])
        return chunk.data[8 + offset :]
    return chunk.data


def _replace_sample_bytes(container: Container, payload: bytes) -> Container:
    """New container with the sample payload replaced, everything else kept."""
    ckid = _DATA_CHUNK_ID[container.kind]
    idx = container.find_index(ckid)
    old = container.chunks[idx]
    if container.kind == AIFF:
        offset, _bs = struct.unpack(">II", old.data[:8])
        head = old.data[: 8 + offset]  # keep original offset/blockSize/lead-in
        # join() accepts any buffer (payload may be a zero-copy memoryview).
        new_chunk = Chunk(ckid, b"".join((head, payload)))
    else:
        new_chunk = Chunk(ckid, payload)
    chunks = list(container.chunks)
    chunks[idx] = new_chunk
    return Container(kind=container.kind, form_type=container.form_type, chunks=chunks)


def _replace_sample_bytes_streamed(container: Container, fmt: AudioFormat,
                                   out_samples: np.ndarray,
                                   payload_len: int) -> Container:
    """Like :func:`_replace_sample_bytes`, but the new data chunk is a
    :class:`StreamedChunk`: at serialization time an encoder thread
    quantizes slab k+1 while the main thread's ``f.write`` of slab k is on
    disk — GB-scale payloads are never materialized whole."""
    ckid = _DATA_CHUNK_ID[container.kind]
    idx = container.find_index(ckid)
    old = container.chunks[idx]
    if container.kind == AIFF:
        offset, _bs = struct.unpack(">II", old.data[:8])
        head = bytes(old.data[: 8 + offset])
    else:
        head = b""

    frames = out_samples.shape[1]
    slab_frames = max(1, _SLAB_BYTES // max(1, fmt.bytes_per_frame))

    def writer(f) -> None:
        q: queue.Queue = queue.Queue(maxsize=2)

        def encoder():
            try:
                for f0 in range(0, frames, slab_frames):
                    slab = np.ascontiguousarray(
                        out_samples[:, f0 : f0 + slab_frames])
                    q.put(codec.encode(slab, fmt))
                q.put(None)
            except Exception as e:  # pragma: no cover - raised in writer
                q.put(e)

        t = threading.Thread(target=encoder, daemon=True)
        t.start()
        f.write(head)
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            f.write(item)
        t.join()

    chunks = list(container.chunks)
    chunks[idx] = StreamedChunk(ckid, len(head) + payload_len, writer)
    return Container(kind=container.kind, form_type=container.form_type,
                     chunks=chunks)


def _update_aiff_num_frames(container: Container, num_frames: int) -> Container:
    """Patch COMM numSampleFrames (kept consistent if frame count changed)."""
    idx = container.find_index(b"COMM")
    old = container.chunks[idx]
    data = bytearray(old.data)
    data[2:6] = struct.pack(">I", num_frames)
    chunks = list(container.chunks)
    chunks[idx] = Chunk(b"COMM", bytes(data))
    return Container(kind=container.kind, form_type=container.form_type, chunks=chunks)


def read_audio(path: str | os.PathLike,
               stream_threshold: int = _STREAM_MIN_BYTES) -> AudioData:
    """Read a WAVE or AIFF file fully: all chunks + decoded planar samples.

    Files above ``stream_threshold`` bytes take the streamed path: the
    chunk table is walked by seeking, metadata chunks are read whole, and
    the sample payload is decoded slab-by-slab with the next disk read
    overlapped against the codec (the raw payload is never resident; the
    returned container carries an empty-payload data chunk, which is
    exactly what :func:`write_audio` needs — it replaces the payload
    anyway)."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFound(str(p))
    if p.stat().st_size > stream_threshold:
        return _read_audio_streamed(p)
    raw = p.read_bytes()
    container = parse_container(raw)
    fmt = format_from_container(container)
    if fmt.channels <= 0:
        raise AudioFormatError(f"Invalid channel count: {fmt.channels}")
    payload = _extract_sample_bytes(container)
    samples = codec.decode(payload, fmt)
    if fmt.num_frames is not None and samples.shape[1] > fmt.num_frames:
        # AIFF: COMM numSampleFrames is authoritative; SSND may be padded.
        samples = samples[:, : fmt.num_frames]
    return AudioData(container=container, fmt=fmt, samples=samples)


def _read_audio_streamed(p: Path) -> AudioData:
    """Seek-walked, slab-decoded read (contract of :func:`read_audio`)."""
    with p.open("rb") as f:
        kind, form_type, entries = scan_container(f)
        data_id = _DATA_CHUNK_ID[kind]
        chunks: list[Chunk] = []
        data_entry = None
        for ckid, off, sz in entries:
            if ckid == data_id and data_entry is None:
                data_entry = (len(chunks), off, sz)
                chunks.append(Chunk(ckid, b""))  # head patched below
            else:
                f.seek(off)
                chunks.append(Chunk(ckid, f.read(sz)))
        if data_entry is None:
            raise AudioFormatError(f"No {data_id.decode()} chunk found")
        idx, off, sz = data_entry
        if kind == AIFF:
            f.seek(off)
            head8 = f.read(min(8, sz))
            if len(head8) < 8:
                raise AudioFormatError("SSND chunk too small")
            ssnd_off, _bs = struct.unpack(">II", head8)
            f.seek(off)
            head = f.read(min(8 + ssnd_off, sz))
            payload_off, payload_len = off + len(head), sz - len(head)
        else:
            head = b""
            payload_off, payload_len = off, sz
        # The placeholder keeps only the SSND head: write_audio re-reads the
        # offset from it and replaces the payload; nothing else touches it.
        chunks[idx] = Chunk(data_id, head)
        container = Container(kind=kind, form_type=form_type, chunks=chunks)
        fmt = format_from_container(container)
        if fmt.channels <= 0:
            raise AudioFormatError(f"Invalid channel count: {fmt.channels}")
        samples = _decode_streamed(f, fmt, payload_off, payload_len)
    if fmt.num_frames is not None and samples.shape[1] > fmt.num_frames:
        samples = samples[:, : fmt.num_frames]
    return AudioData(container=container, fmt=fmt, samples=samples)


def _decode_streamed(f, fmt: AudioFormat, off: int, nbytes: int) -> np.ndarray:
    """Decode ``nbytes`` of interleaved samples at file offset ``off`` in
    frame-aligned slabs: a reader thread keeps the next slab's disk read in
    flight while the codec (C++/NumPy, GIL released in the hot paths)
    converts the current one straight into the preallocated planar array."""
    fb = fmt.bytes_per_frame
    total_frames = nbytes // fb
    out = np.empty((fmt.channels, total_frames), dtype=np.float32)
    slab_frames = max(1, _SLAB_BYTES // fb)
    q: queue.Queue = queue.Queue(maxsize=2)

    def reader():
        try:
            f.seek(off)
            done = 0
            while done < total_frames:
                k = min(slab_frames, total_frames - done)
                buf = f.read(k * fb)
                q.put((done, buf))
                done += k
                if len(buf) < k * fb:  # truncated file: stop at what exists
                    break
            q.put(None)
        except Exception as e:  # pragma: no cover - surfaced in main thread
            q.put(e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    filled = 0
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, Exception):
            raise item
        f0, buf = item
        dec = codec.decode(buf, fmt)
        out[:, f0 : f0 + dec.shape[1]] = dec
        filled = f0 + dec.shape[1]
    t.join()
    return out if filled == total_frames else out[:, :filled]


def write_audio(path: str | os.PathLike, data: AudioData,
                samples: np.ndarray | None = None) -> None:
    """Write an audio file: all input chunks verbatim, samples re-encoded.

    Equivalent to the reference's chunk-copy + writeAll sequence
    (ProcessFile.cp:105-117). Atomic: written to a temp file in the target
    directory, then renamed into place.
    """
    p = Path(path)
    out_samples = data.samples if samples is None else samples
    payload_len = out_samples.shape[1] * data.fmt.bytes_per_frame
    if payload_len > _STREAM_MIN_BYTES:
        container = _replace_sample_bytes_streamed(
            data.container, data.fmt, out_samples, payload_len)
    else:
        payload = codec.encode(out_samples, data.fmt)
        container = _replace_sample_bytes(data.container, payload)
    if container.kind == AIFF:
        container = _update_aiff_num_frames(container, out_samples.shape[1])

    fd, tmp_name = tempfile.mkstemp(
        dir=str(p.parent) if str(p.parent) else ".", prefix=".lowcut_tmp_"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            # Streamed: no serialized blob (two full-payload copies saved).
            write_container(f, container)
        os.replace(tmp_name, p)
    except BaseException:
        try:
            os.unlink(tmp_name)
        except OSError:
            pass
        raise


def normalize(samples: np.ndarray) -> np.ndarray:
    """Scale ALL channels by one common factor so the global peak is ±1.0.

    Equivalent of the reference's static ``AudioSamples::normalize(buf)``
    (ProcessFile.cp:100): per-channel maxes reduced to one global max first
    (ProcessFile.cp:92-97), then a single scale applied everywhere.
    """
    peak = float(np.max(np.abs(samples))) if samples.size else 0.0
    if peak == 0.0:
        return samples
    # Copy first: normalize never mutates its input (_scale_common does).
    return _scale_common(np.array(samples, np.float32), peak)


def _scale_common(samples: np.ndarray, peak: float) -> np.ndarray:
    """Known-peak form of :func:`normalize`: apply the one common factor
    1/peak, IN PLACE when the array is writable — the pipeline callers own
    the array (their peak comes back from the device fused into the filter
    program, so no max pass runs here). Module-private because of that
    in-place mutation: external callers should use :func:`normalize`.
    peak <= 0 is a no-op (silence)."""
    if peak <= 0.0:
        return np.asarray(samples, np.float32)
    samples = np.asarray(samples, np.float32)
    if not samples.flags.writeable:  # e.g. a device-backed view
        samples = samples.copy()
    samples *= np.float32(1.0 / peak)
    return samples

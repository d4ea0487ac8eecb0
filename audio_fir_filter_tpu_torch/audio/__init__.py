from .chunks import (Chunk, Container, parse_container,
                     serialize_container, write_container)
from .format import AudioFormat, Encoding
from .file import AudioData, read_audio, write_audio, normalize

__all__ = [
    "Chunk",
    "Container",
    "parse_container",
    "serialize_container",
    "write_container",
    "AudioFormat",
    "Encoding",
    "AudioData",
    "read_audio",
    "write_audio",
    "normalize",
]

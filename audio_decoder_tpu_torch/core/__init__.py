from .batch import AudioBatch, AudioFileView, concat_batches
from .errors import (
    DecodeError,
    InvalidDataError,
    IoError,
    UnexpectedEofError,
    UnsupportedFormatError,
)

__all__ = [
    "AudioBatch",
    "AudioFileView",
    "concat_batches",
    "DecodeError",
    "InvalidDataError",
    "IoError",
    "UnexpectedEofError",
    "UnsupportedFormatError",
]

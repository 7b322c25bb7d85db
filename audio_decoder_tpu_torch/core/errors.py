# Verbatim copy of audio_decoder_tpu/core/errors.py (that package imports jax on import).
"""Error taxonomy for the decode layer.

Mirrors the reference's ``DecodeError`` enum (reference:
blast/src/file_parsing/decode_helpers.rs:1-15) but in two forms suited to a
batched TPU pipeline:

* **Host exceptions** (``DecodeError`` and subclasses) for host-side IO and
  per-file dispatch errors, matching the reference's per-file catch-and-skip
  behaviour (blast/src/main.rs:55-77).
* **Vectorized error codes** (``ERR_*`` int32 codes) carried per-file through
  jitted device code, since device code cannot raise.  A batch decode returns
  an ``err`` array; hosts translate nonzero codes back into exceptions or
  skip the file, preserving reference semantics.
"""

from __future__ import annotations

# Vectorized per-file error codes (int32, 0 == success).
ERR_OK = 0
ERR_EOF = 1          # DecodeError::UnexpectedEof
ERR_UNSUPPORTED = 2  # DecodeError::UnsupportedFormat
ERR_INVALID = 3      # DecodeError::InvalidData
ERR_IO = 4           # DecodeError::Io (host-side only)

_CODE_NAMES = {
    ERR_OK: "Ok",
    ERR_EOF: "UnexpectedEof",
    ERR_UNSUPPORTED: "UnsupportedFormat",
    ERR_INVALID: "InvalidData",
    ERR_IO: "Io",
}


class DecodeError(Exception):
    """Base decode error (mirrors decode_helpers.rs:1-7)."""

    code = ERR_INVALID


class IoError(DecodeError):
    code = ERR_IO


class UnsupportedFormatError(DecodeError):
    code = ERR_UNSUPPORTED


class UnexpectedEofError(DecodeError):
    code = ERR_EOF


class InvalidDataError(DecodeError):
    code = ERR_INVALID


_CODE_TO_EXC = {
    ERR_EOF: UnexpectedEofError,
    ERR_UNSUPPORTED: UnsupportedFormatError,
    ERR_INVALID: InvalidDataError,
    ERR_IO: IoError,
}


def code_name(code: int) -> str:
    return _CODE_NAMES.get(int(code), f"Unknown({code})")


def raise_for_code(code: int, context: str = "") -> None:
    """Raise the host exception matching a device-side error code."""
    code = int(code)
    if code == ERR_OK:
        return
    exc = _CODE_TO_EXC.get(code, InvalidDataError)
    raise exc(f"{code_name(code)}: {context}" if context else code_name(code))

"""Vectorized byte readers over uint8 tensors.

Each reader takes a packed batch ``buf: u8 [B, N]`` and per-file byte
offsets ``off: [B]`` and returns the value at each file's offset as int64
``[B]``.  A read fetches 4 consecutive bytes starting at ``off`` clamped
into ``[0, N-4]``, the edge behaviour of the JAX package's
``dynamic_slice`` reads, so a read near or past the end of a row returns
the same bytes there as here.

Words are assembled in int64: torch has no uint32 shift on the CPU, and
an int32 ``>>`` is arithmetic, so a 32-bit word with its top bit set
would come out negative.  Callers that want the JAX package's int32 view
of a u32 field cast with ``.to(torch.int32)``, which wraps the same way.

``peek32`` reads bit windows (the MP3 and FLAC entropy scans' plain forms).
"""

from __future__ import annotations

import torch


def fourcc(tag: str) -> int:
    """Pack a 4-char chunk id into a big-endian u32 for comparisons
    (e.g. ``fourcc('RIFF')``).  Host-side constant helper."""
    if len(tag) != 4:
        raise ValueError(f"fourcc needs 4 characters, got {tag!r}")
    v = 0
    for ch in tag:
        v = (v << 8) | ord(ch)
    return v


def _gather4(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Fetch 4 consecutive bytes per row at ``off`` (clamped at the edge)
    → int64 ``[B, 4]``."""
    n = buf.shape[1]
    start = torch.clamp(off.to(torch.int64), 0, max(n - 4, 0))
    idx = start[:, None] + torch.arange(4, device=buf.device)
    return torch.gather(buf, 1, idx.clamp(max=n - 1)).to(torch.int64)


def read_tag(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Read a 4-byte chunk id as a big-endian u32 (compare with fourcc)."""
    b = _gather4(buf, off)
    return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]


def read_u32le(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    b = _gather4(buf, off)
    return (b[:, 3] << 24) | (b[:, 2] << 16) | (b[:, 1] << 8) | b[:, 0]


def read_u32be(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    return read_tag(buf, off)


def read_u16le(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    b = _gather4(buf, off)
    return (b[:, 1] << 8) | b[:, 0]


def read_u16be(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    b = _gather4(buf, off)
    return (b[:, 0] << 8) | b[:, 1]


def peek32(rows: torch.Tensor, row, pos: torch.Tensor) -> torch.Tensor:
    """The 32 bits at bit offset ``pos`` of row ``row`` of ``rows`` (u8
    ``[R, M]``; ``row`` an index tensor shaped like ``pos``, or an int), as
    int64 in [0, 2^32).  Bytes at or past the row's end read as 0."""
    M = rows.shape[1]
    byte = pos >> 3
    win = torch.zeros_like(pos)
    for k in range(5):
        b = byte + k
        inside = (b >= 0) & (b < M)
        v = rows[row, b.clamp(0, M - 1)].to(torch.int64)
        win = (win << 8) | torch.where(inside, v, torch.zeros_like(v))
    return (win >> (8 - (pos & 7))) & 0xFFFFFFFF

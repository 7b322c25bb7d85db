"""Vectorized byte readers over uint8 tensors.

Each reader takes a packed batch ``buf: u8 [B, N]`` and per-file byte
offsets ``off: [B]`` and returns the value at each file's offset as int64
``[B]``.  A read fetches 4 consecutive bytes starting at ``off`` (a
negative ``off`` counts from the row's end) clamped into ``[0, N-4]``, the
edge behaviour of the JAX package's ``dynamic_slice`` reads, so a read
near or past either end of a row returns the same bytes there as here.

Words are assembled in int64: torch has no uint32 shift on the CPU, and
an int32 ``>>`` is arithmetic, so a 32-bit word with its top bit set
would come out negative.  Callers that want the JAX package's int32 view
of a u32 field cast with ``.to(torch.int32)``, which wraps the same way.

``read_ieee_extended`` decodes AIFF's 80-bit sample rate; ``peek32`` reads
bit windows (the MP3 and FLAC entropy scans' plain forms).
"""

from __future__ import annotations

import numpy as np
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


def _gather(buf: torch.Tensor, off: torch.Tensor, width: int) -> torch.Tensor:
    """Fetch ``width`` consecutive bytes per row at ``off`` (clamped at the
    edge) → int64 ``[B, width]``."""
    n = buf.shape[1]
    off = off.to(torch.int64)
    # dynamic_slice's rule: a negative start counts from the row's end
    start = torch.clamp(torch.where(off < 0, off + n, off), 0, max(n - width, 0))
    idx = start[:, None] + torch.arange(width, device=buf.device)
    return torch.gather(buf, 1, idx.clamp(max=n - 1)).to(torch.int64)


def read_tag(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Read a 4-byte chunk id as a big-endian u32 (compare with fourcc)."""
    b = _gather(buf, off, 4)
    return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]


def read_u32le(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    b = _gather(buf, off, 4)
    return (b[:, 3] << 24) | (b[:, 2] << 16) | (b[:, 1] << 8) | b[:, 0]


def read_u32be(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    return read_tag(buf, off)


def read_u16le(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    b = _gather(buf, off, 4)
    return (b[:, 1] << 8) | b[:, 0]


def read_u16be(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    b = _gather(buf, off, 4)
    return (b[:, 0] << 8) | b[:, 1]


def _exp2_xla(x: torch.Tensor) -> torch.Tensor:
    """f32 2^x as the JAX package's ``jnp.exp2`` computes it: ``exp(f32(ln
    2) * x)``, which is off by a few ulps for larger |x|, with subnormal
    results flushed to zero as XLA does.  For integer ``x`` this equals
    XLA's value on the CPU except at x = 32 (a rate near 2^63)."""
    v = torch.exp(x * np.float32(np.log(2.0)))
    return torch.where(v < np.float32(2.0 ** -126), torch.zeros_like(v), v)


def read_ieee_extended(buf: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Decode the IEEE 754 80-bit extended float at ``off`` → f32 ``[B]``.

    The JAX package's arithmetic step for step: ``mant_hi * 2^(e+32) +
    mant_lo * 2^e`` in f32 with its ``exp2`` (``_exp2_xla``), so an odd
    rate rounds to the same f32 as there; zero and inf/NaN encodings give
    0 (the caller flags the invalid rate)."""
    b = _gather(buf, off, 10)
    sign = (b[:, 0] >> 7) & 1
    exp = ((b[:, 0] & 0x7F) << 8) | b[:, 1]
    mant_hi = (b[:, 2] << 24) | (b[:, 3] << 16) | (b[:, 4] << 8) | b[:, 5]
    mant_lo = (b[:, 6] << 24) | (b[:, 7] << 16) | (b[:, 8] << 8) | b[:, 9]
    e = (exp - 16383 - 63).to(torch.float32)
    val = (mant_hi.to(torch.float32) * _exp2_xla(e + 32.0)
           + mant_lo.to(torch.float32) * _exp2_xla(e))
    zero = (exp == 0) & (mant_hi == 0) & (mant_lo == 0)
    bad = exp == 0x7FFF  # inf/NaN
    val = torch.where(zero | bad, torch.zeros_like(val), val)
    return torch.where(sign == 1, -val, val)


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 → int32 as XLA converts: saturating at the int32 range, NaN to 0
    (torch's own cast leaves out-of-range values undefined)."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return x.clamp(-2147483648.0, 2147483647.0).to(torch.int32)


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

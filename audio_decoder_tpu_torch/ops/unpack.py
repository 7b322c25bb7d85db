"""Batched PCM sample unpacking: uint8 byte tensors → flat f32 PCM.

One gather + integer assemble + scale over the whole batch, for 8/16/24/
32-bit integer PCM (unsigned 8-bit for WAV, signed for other
containers), both endiannesses, IEEE float32/float64 and G.711 A-law and
µ-law.  The ADPCM unpackers of the JAX package (IMA, ima4, MS) are not
ported yet.

Conversion convention (the framework-wide PCM contract):
  int N-bit  →  f32 = signed_int / 2^(N-1)      (bit-exact for N <= 24)
  float32    →  passthrough;  float64 → nearest float32
"""

from __future__ import annotations

import numpy as np
import torch


def _g711_tables():
    """G.711 companding decode tables, byte → int16 (ITU-T G.711)."""
    alaw = np.zeros(256, np.float32)
    ulaw = np.zeros(256, np.float32)
    for b in range(256):
        a = b ^ 0x55
        t = (a & 0xF) << 4
        seg = (a >> 4) & 7
        t = ((t + 0x108) << (seg - 1)) if seg else (t + 8)
        alaw[b] = t if (a & 0x80) else -t
        u = ~b & 0xFF
        m = (((u & 0xF) << 3) + 0x84) << ((u >> 4) & 7)
        ulaw[b] = (0x84 - m) if (u & 0x80) else (m - 0x84)
    return alaw / 32768.0, ulaw / 32768.0


_ALAW_F32, _ULAW_F32 = _g711_tables()


def unpack_pcm(
    bufs: torch.Tensor,      # u8 [B, N] raw file bytes
    data_off: torch.Tensor,  # i32 [B] byte offset of first sample
    n_frames: torch.Tensor,  # i32 [B] valid frame count per file
    *,
    bits: int,
    channels: int,
    big_endian: bool = False,
    unsigned8: bool = False,
    is_float: bool = False,
    companded: str | None = None,
    max_frames: int,
) -> torch.Tensor:
    """Unpack interleaved PCM to flat f32 ``[B, max_frames*channels]``.

    Frames beyond ``n_frames[b]`` are zero.  Each file's sample region is
    read from ``data_off`` clamped into ``[0, N]`` over the buffer padded
    by one full span, the JAX package's ``dynamic_slice`` edge rule, so a
    region starting near the end reads zero padding, never shifted bytes.
    """
    dev = bufs.device
    bps = bits // 8
    nvals = max_frames * channels
    B, N = bufs.shape
    span = nvals * bps
    pad = torch.nn.functional.pad(bufs, (0, span))
    start = torch.clamp(data_off.to(torch.int64), 0, N)[:, None]
    pos = start + torch.arange(nvals, device=dev, dtype=torch.int64)[None] * bps

    def byte(k: int) -> torch.Tensor:
        return torch.gather(pad, 1, pos + k).to(torch.int64)

    if companded is not None:
        if bits != 8:
            raise ValueError("companded PCM must be 8-bit")
        lut = torch.as_tensor(_ALAW_F32 if companded == "alaw" else _ULAW_F32,
                              device=dev)
        val = lut[byte(0)]
    elif is_float:
        if bits not in (32, 64):
            raise ValueError("float PCM must be 32- or 64-bit")
        order = range(bps) if big_endian else range(bps - 1, -1, -1)
        word = torch.zeros((B, nvals), dtype=torch.int64, device=dev)
        for k in order:
            word = (word << 8) | byte(k)
        if bits == 32:
            val = _wrap32(word).view(torch.float32)
        else:
            # IEEE round-to-nearest-even demotion, subnormals included: the
            # value the JAX package's integer demotion computes
            val = word.view(torch.float64).to(torch.float32)
    else:
        if bits == 8:
            ival = byte(0)
            if unsigned8:
                ival = ival - 128
            else:
                ival = torch.where(ival >= 128, ival - 256, ival)
        elif bits in (16, 24, 32):
            order = range(bps) if big_endian else range(bps - 1, -1, -1)
            ival = torch.zeros((B, nvals), dtype=torch.int64, device=dev)
            for k in order:
                ival = (ival << 8) | byte(k)
            top = 1 << (bits - 1)
            ival = torch.where(ival >= top, ival - 2 * top, ival)
        else:
            raise ValueError(f"unsupported bit depth {bits}")
        # int32 → f32 then one f32 multiply, as the JAX package rounds
        val = ival.to(torch.int32).to(torch.float32) * np.float32(
            1.0 / (1 << (bits - 1)))

    frame_ids = torch.arange(nvals, device=dev)[None, :] // channels
    live = frame_ids < n_frames.to(torch.int64)[:, None]
    return torch.where(live, val, torch.zeros((), dtype=torch.float32,
                                              device=dev))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 word as int32 (bit pattern preserved)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)

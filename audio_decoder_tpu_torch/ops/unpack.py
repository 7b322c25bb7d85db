"""Batched PCM sample unpacking: uint8 byte tensors → flat f32 PCM.

One gather + integer assemble + scale over the whole batch, for 8/16/24/
32-bit integer PCM (unsigned 8-bit for WAV, signed for other
containers), both endiannesses, IEEE float32/float64 and G.711 A-law and
µ-law.

The ADPCM unpackers (WAV IMA, Apple ima4, WAV MS) decode every (file,
block, channel) lane at once: each block carries its own predictor
state, so only the nibbles within a block are sequential.  The JAX
package's ``lax.scan`` over nibble position becomes a Python loop over
the block's steps, each step a few int32 ops over all lanes.

Conversion convention (the framework-wide PCM contract):
  int N-bit  →  f32 = signed_int / 2^(N-1)      (bit-exact for N <= 24)
  float32    →  passthrough;  float64 → nearest float32
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.trace import span, to_device


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
    read over the buffer padded by one full span, from ``_region_start``,
    so a region starting near the end reads zero padding, never shifted
    bytes.
    """
    dev = bufs.device
    bps = bits // 8
    nvals = max_frames * channels
    B, N = bufs.shape
    span = nvals * bps
    pad = torch.nn.functional.pad(bufs, (0, span))
    start = _region_start(data_off, N, span)[:, None]
    pos = start + torch.arange(nvals, device=dev, dtype=torch.int64)[None] * bps

    def byte(k: int) -> torch.Tensor:
        return torch.gather(pad, 1, pos + k).to(torch.int64)

    if companded is not None:
        if bits != 8:
            raise ValueError("companded PCM must be 8-bit")
        lut = to_device(_ALAW_F32 if companded == "alaw" else _ULAW_F32, dev)
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

    return _mask_frames(val, n_frames, channels)


def _mask_frames(pcm: torch.Tensor, n_frames: torch.Tensor,
                 channels: int) -> torch.Tensor:
    """Zero the values of flat interleaved ``[B, frames*C]`` PCM past each
    file's ``n_frames``."""
    ids = torch.arange(pcm.shape[1], device=pcm.device)[None, :] // channels
    live = ids < n_frames.to(torch.int64)[:, None]
    return torch.where(live, pcm, torch.zeros((), dtype=pcm.dtype,
                                              device=pcm.device))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 word as int32 (bit pattern preserved)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _region_start(data_off: torch.Tensor, N: int, span: int) -> torch.Tensor:
    """Start of each file's ``span``-byte region in its row padded by one
    span, as the JAX package's ``dynamic_slice`` takes it: a negative
    offset counts from the padded row's end, then the start is clamped
    into ``[0, N]``."""
    off = data_off.to(torch.int64)
    return torch.clamp(torch.where(off < 0, off + N + span, off), 0, N)


def _slice_region(bufs: torch.Tensor, data_off: torch.Tensor,
                  span: int) -> torch.Tensor:
    """Each file's contiguous ``span``-byte window from ``data_off`` → u8
    ``[B, span]``, with unpack_pcm's edge rule (``_region_start``)."""
    pad = torch.nn.functional.pad(bufs, (0, span))
    start = _region_start(data_off, bufs.shape[1], span)[:, None]
    idx = start + torch.arange(span, device=bufs.device, dtype=torch.int64)
    return torch.gather(pad, 1, idx)


def _to_pcm(samples: torch.Tensor, B: int, K: int, channels: int,
            n_frames: torch.Tensor, max_frames: int) -> torch.Tensor:
    """int32 samples ``[spb, B*K*C]`` (step-major, lanes in (file, block,
    channel) order) → flat interleaved f32 ``[B, max_frames*C]``, frames
    past ``n_frames`` zero."""
    spb = samples.shape[0]
    nvals = max_frames * channels
    pcm = (samples.reshape(spb, B, K, channels).permute(1, 2, 0, 3)
           .reshape(B, K * spb * channels)[:, :nvals]
           .to(torch.float32) * np.float32(1.0 / 32768.0))
    return _mask_frames(pcm, n_frames, channels)


def _i16(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Little-endian int16 from two byte tensors, as int32."""
    v = lo.to(torch.int32) | (hi.to(torch.int32) << 8)
    return torch.where(v >= 1 << 15, v - (1 << 16), v)


# IMA/DVI ADPCM step-size and index-adaptation tables (IMA ADPCM
# reference algorithm; WAV format code 0x11).
_IMA_STEPS = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767,
], np.int32)
_IMA_INDEX = np.array(
    [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], np.int32)


def _ima_step_tables() -> tuple[np.ndarray, np.ndarray]:
    """The IMA recurrence folded into two tables indexed by ``16*index +
    nibble``: the signed predictor change, and ``16*`` the next step
    index (clamped to 0..88), both exactly the per-nibble arithmetic."""
    step = _IMA_STEPS.astype(np.int64)[:, None]
    d = np.arange(16)[None, :]
    vpdiff = ((step >> 3) + np.where(d & 4, step, 0)
              + np.where(d & 2, step >> 1, 0) + np.where(d & 1, step >> 2, 0))
    delta = np.where(d & 8, -vpdiff, vpdiff)
    nxt = np.clip(np.arange(89)[:, None] + _IMA_INDEX[None, :], 0, 88)
    return (delta.reshape(-1).astype(np.int32),
            (16 * nxt).reshape(-1).astype(np.int64))


_IMA_DELTA, _IMA_NEXT16 = _ima_step_tables()


def _ima_scan(pred0: torch.Tensor, idx0: torch.Tensor,
              nib: torch.Tensor) -> torch.Tensor:
    """The IMA ADPCM nibble recurrence over ``[S, lanes]`` codes (shared by
    the WAV IMA and ima4 unpackers) → int32 samples ``[S, lanes]``.

    Per step: the predictor moves by its table change and clamps to
    int16; the step index follows its table (0..88)."""
    dev = nib.device
    delta_tab = to_device(_IMA_DELTA, dev)
    next_tab = to_device(_IMA_NEXT16, dev)
    out = torch.empty(nib.shape, dtype=torch.int32, device=dev)
    pred = pred0.to(torch.int32)
    k16 = idx0.to(torch.int64) * 16
    nib = nib.to(torch.int64)
    with span("adpcm.scan"):
        for s in range(nib.shape[0]):
            k = k16 + nib[s]
            torch.add(pred, delta_tab[k], out=out[s])
            pred = out[s].clamp_(-32768, 32767)
            k16 = next_tab[k]
    return out


def unpack_ima_adpcm(
    bufs: torch.Tensor,      # u8 [B, N] raw file bytes
    data_off: torch.Tensor,  # i32 [B] byte offset of the first block
    n_frames: torch.Tensor,  # i32 [B] valid frame count per file
    *,
    channels: int,
    block_align: int,
    max_frames: int,
) -> torch.Tensor:
    """Decode WAV IMA ADPCM (format 0x11) → flat interleaved f32
    ``[B, max_frames*C]``.

    Each ``block_align``-byte block holds a 4-byte header per channel
    (int16 LE predictor, the block's first sample; uint8 step index) and
    then 4-byte nibble groups interleaved per channel, low nibble first."""
    C = channels
    if block_align <= 4 * C or block_align % (4 * C):
        raise ValueError(f"bad IMA block_align {block_align}")
    B = bufs.shape[0]
    W = (block_align - 4 * C) // (4 * C)  # words per channel per block
    spb = 1 + 8 * W                       # samples per channel per block
    K = -(-max_frames // spb)              # blocks
    blocks = _slice_region(bufs, data_off, K * block_align).reshape(
        B, K, block_align)

    hdr = blocks[:, :, : 4 * C].reshape(B, K, C, 4)
    pred0 = _i16(hdr[..., 0], hdr[..., 1]).reshape(-1)
    idx0 = torch.clamp(hdr[..., 2].to(torch.int32), 0, 88).reshape(-1)

    # body nibbles → [S, lanes] in decode order: low nibble first in each
    # byte, bytes in order in each channel's 4-byte group
    body = blocks[:, :, 4 * C:].reshape(B, K, W, C, 4)
    nib = torch.stack([body & 0xF, body >> 4], dim=-1)   # [B,K,W,C,4,2]
    nib = nib.permute(0, 1, 3, 2, 4, 5).reshape(B * K * C, 8 * W).t()

    out = _ima_scan(pred0, idx0, nib)
    samples = torch.cat([pred0.to(torch.int32)[None], out], dim=0)
    return _to_pcm(samples, B, K, C, n_frames, max_frames)


def unpack_ima4(
    bufs: torch.Tensor,      # u8 [B, N] raw file bytes
    data_off: torch.Tensor,  # i32 [B] byte offset of the first packet group
    n_frames: torch.Tensor,  # i32 [B] valid frame count per file
    *,
    channels: int,
    max_frames: int,
) -> torch.Tensor:
    """Decode AIFF-C/CAF 'ima4' (Apple IMA) → flat interleaved f32
    ``[B, max_frames*C]``.

    34-byte packets per channel, interleaved by channel per 64-sample
    group: a 2-byte big-endian header packs the predictor's top 9 bits
    (sign-extended) with the 7-bit step index, then 32 bytes of nibbles,
    low first.  All 64 outputs come from the scan."""
    C = channels
    B = bufs.shape[0]
    K = -(-max_frames // 64)
    pkts = _slice_region(bufs, data_off, K * 34 * C).reshape(B, K, C, 34)

    hdr = (pkts[..., 0].to(torch.int32) << 8) | pkts[..., 1].to(torch.int32)
    pred0 = hdr & 0xFF80
    pred0 = torch.where(pred0 >= 1 << 15, pred0 - (1 << 16), pred0)
    idx0 = torch.clamp(hdr & 0x7F, 0, 88)

    body = pkts[..., 2:]                                    # [B,K,C,32]
    nib = torch.stack([body & 0xF, body >> 4], dim=-1)      # low first
    nib = nib.reshape(B * K * C, 64).t()

    out = _ima_scan(pred0.reshape(-1), idx0.reshape(-1), nib)
    return _to_pcm(out, B, K, C, n_frames, max_frames)


# MS ADPCM (WAV format 0x02): the 7 standard predictor coefficient pairs
# and the idelta adaptation table (decoders use these built-ins whatever
# the fmt chunk's copy says).
_MS_COEF1 = np.array([256, 512, 0, 192, 240, 460, 392], np.int32)
_MS_COEF2 = np.array([0, -256, 0, 64, 0, -208, -232], np.int32)
_MS_ADAPT = np.array(
    [230, 230, 230, 230, 307, 409, 512, 614,
     768, 614, 512, 409, 307, 230, 230, 230], np.int32)


def unpack_ms_adpcm(
    bufs: torch.Tensor,      # u8 [B, N] raw file bytes
    data_off: torch.Tensor,  # i32 [B] byte offset of the first block
    n_frames: torch.Tensor,  # i32 [B] valid frame count per file
    *,
    channels: int,
    block_align: int,
    max_frames: int,
) -> torch.Tensor:
    """Decode WAV MS ADPCM (format 0x02) → flat interleaved f32
    ``[B, max_frames*C]``.

    Block header, per channel and interleaved by channel: 1-byte predictor
    index, int16 LE idelta, int16 LE sample1, int16 LE sample2; then one
    4-bit code per channel per byte, high nibble first.  sample2 and
    sample1 are the block's first two frames.  Per code: predictor =
    (s1·coef1 + s2·coef2) / 256 truncated toward zero, + signed code ·
    idelta, clamped to int16; idelta becomes (ADAPT[code]·idelta) >> 8
    with a floor of 16 (the header's idelta is used raw for the first
    code)."""
    C = channels
    if C not in (1, 2):
        raise ValueError("MS ADPCM: 1 or 2 channels")
    if block_align <= 7 * C:
        raise ValueError(f"bad MS block_align {block_align}")
    B = bufs.shape[0]
    dev = bufs.device
    body_n = block_align - 7 * C
    S = body_n * 2 // C                 # coded samples per channel
    spb = 2 + S
    K = -(-max_frames // spb)
    blocks = _slice_region(bufs, data_off, K * block_align).reshape(
        B, K, block_align)

    hdr = blocks[:, :, : 7 * C]
    cidx = torch.clamp(hdr[:, :, 0:C].to(torch.int64), 0, 6).reshape(-1)
    idelta0 = _i16(hdr[:, :, C:3 * C:2], hdr[:, :, C + 1:3 * C:2])
    samp1 = _i16(hdr[:, :, 3 * C:5 * C:2], hdr[:, :, 3 * C + 1:5 * C:2])
    samp2 = _i16(hdr[:, :, 5 * C:7 * C:2], hdr[:, :, 5 * C + 1:7 * C:2])

    body = blocks[:, :, 7 * C:]                              # [B,K,body_n]
    nib = torch.stack([body >> 4, body & 0xF], dim=-1)       # high first
    # stereo: byte k carries (left, right); mono: two consecutive codes
    nib = nib.reshape(B, K, S, C).permute(0, 1, 3, 2).reshape(B * K * C, S)
    nib = nib.t().to(torch.int64)                            # [S, lanes]
    signed = (nib - ((nib & 8) << 1)).to(torch.int32)
    adapt = to_device(_MS_ADAPT, dev)[nib]

    coef1 = to_device(_MS_COEF1, dev)[cidx]
    coef2 = to_device(_MS_COEF2, dev)[cidx]
    s1, s2 = samp1.reshape(-1), samp2.reshape(-1)
    delta = idelta0.reshape(-1)
    out = torch.empty((S, s1.shape[0]), dtype=torch.int32, device=dev)
    with span("adpcm.scan"):
        for s in range(S):
            lin = torch.div(s1 * coef1 + s2 * coef2, 256, rounding_mode="trunc")
            torch.add(lin, signed[s] * delta, out=out[s])
            s2, s1 = s1, out[s].clamp_(-32768, 32767)
            delta = torch.clamp((adapt[s] * delta) >> 8, min=16)
    samples = torch.cat([samp2.reshape(1, -1), samp1.reshape(1, -1), out],
                        dim=0)
    return _to_pcm(samples, B, K, C, n_frames, max_frames)

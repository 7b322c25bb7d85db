"""Apple CAF (Core Audio Format) header parsing as batched tensor ops.

CAF chunks carry int64 big-endian sizes: an 8-byte file header ('caff',
version, flags), a 32-byte 'desc' chunk (float64 sample rate, codec
fourcc, format flags, packet geometry) and a 'data' chunk whose size may
be -1 ("runs to EOF").  Codecs: 'lpcm' (8/16/24/32-bit int and f32/f64,
either endianness by the format flags), 'ulaw'/'alaw' (G.711) and 'ima4'
(Apple IMA ADPCM, as in AIFF-C).

The chunk walk runs over every file of a packed ``u8 [B, N]`` batch at
once, a bounded loop with masked updates in place of the JAX package's
vmapped ``lax.while_loop``.  Each int64 size is read as two u32 words: a
high word that is neither 0 nor the -1 sentinel fails the truncation
check.  The f64 rate is decoded with f32 significand arithmetic and an
exact power of two, exact for every rate with at most 24 significant bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import errors as E
from ..ops.bytes import f32_to_i32, fourcc, read_tag, read_u16be, read_u32be
from .wav import _fdiv, _i32

_CAFF = fourcc("caff")
_DESC = fourcc("desc")
_DATA = fourcc("data")
_LPCM = fourcc("lpcm")
_ULAW = fourcc("ulaw")
_ALAW = fourcc("alaw")
_IMA4 = fourcc("ima4")

#: kCAFLinearPCMFormatFlag bits
_FLAG_FLOAT = 1
_FLAG_LITTLE = 2

_MAX_CHUNKS = 128


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as f32 for integers ``k`` in [-126, 127], exact on every device
    (built from the exponent bits)."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def _read_f64be_int(bufs: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The big-endian IEEE float64 at ``p`` rounded to int32 (half to
    even), as the JAX package computes it: the significand's top bits in
    f32, scaled by an exact power of two (``ldexp``); zero, subnormal, inf/NaN and negative values
    give 0, and the value is clipped to ``[0, 2^31 - 128]``."""
    hi = read_u32be(bufs, p)
    lo = read_u32be(bufs, p + 4)
    e = ((hi >> 20) & 0x7FF).to(torch.int32)
    hi_s = ((hi & 0xFFFFF) | (1 << 20)).to(torch.float32)  # top 21 bits
    sig = hi_s * np.float32(4294967296.0) + lo.to(torch.float32)
    val = sig * _pow2(torch.clamp(e - 1075, -100, 40))  # ldexp
    zero = torch.zeros_like(val)
    val = torch.where(e == 0, zero, val)  # zero/subnormal → 0
    val = torch.where(e == 0x7FF, zero, val)  # inf/NaN → 0
    val = torch.where((hi >> 31) != 0, zero, val)  # negative → 0
    return f32_to_i32(torch.round(torch.clamp(val, 0.0, float(2**31 - 128))))


def _parse_one(bufs: torch.Tensor, lens: torch.Tensor) -> dict:
    """Chunk-walk every CAF file of a packed batch → dict of int32 ``[B]``
    tensors: err, fmt_code, channels, sample_rate, bits, data_off,
    data_size, n_frames, flags."""
    dev = bufs.device
    B = bufs.shape[0]
    i32 = torch.int32
    flen = lens.to(i32)

    def full(v):
        return torch.full((B,), v, dtype=i32, device=dev)

    ok_magic = ((flen >= 8) & (read_tag(bufs, full(0)) == _CAFF)
                & (read_u16be(bufs, full(4)) == 1))

    cursor, it = full(8), full(0)
    desc_off, data_off, data_size = full(-1), full(-1), full(0)
    err = full(E.ERR_OK)
    for _ in range(_MAX_CHUNKS):
        active = ((cursor + 12 <= flen) & (it < _MAX_CHUNKS) & (data_off < 0)
                  & (err == E.ERR_OK))
        if not bool(active.any()):
            break
        cid = read_tag(bufs, cursor)
        size_hi = _i32(read_u32be(bufs, cursor + 4))
        size_lo = _i32(read_u32be(bufs, cursor + 8))
        payload = cursor + 12
        # int64 size -1 = "to EOF"; any other nonzero high word cannot fit
        # an int32-indexed buffer
        to_eof = (size_hi == -1) & (size_lo == -1)
        csize = torch.where(to_eof, flen - payload, size_lo)
        overflow = ((size_hi != 0) & ~to_eof) | (csize < 0)
        is_desc = active & (cid == _DESC)
        is_data = active & (cid == _DATA)
        desc_off = torch.where(is_desc, payload, desc_off)
        trunc = (payload + csize > flen) | overflow
        err = torch.where((is_desc | is_data) & trunc, full(E.ERR_EOF), err)
        # data payload: u32 edit count, then the audio bytes
        data_off = torch.where(is_data, payload + 4, data_off)
        data_size = torch.where(is_data, torch.clamp(csize - 4, min=0),
                                data_size)
        cursor = torch.where(active, payload + csize, cursor)
        it = torch.where(active, it + 1, it)

    err = torch.where(ok_magic, err, full(E.ERR_UNSUPPORTED))
    missing = (desc_off < 0) | (data_off < 0)
    err = torch.where((err == E.ERR_OK) & missing, full(E.ERR_EOF), err)

    # desc: f64 rate, fourcc codec, u32 flags, u32 bytes/packet, u32
    # frames/packet, u32 channels, u32 bits
    p = torch.clamp(desc_off, min=0)
    sample_rate = _read_f64be_int(bufs, p)
    codec = read_tag(bufs, p + 8)
    flags = _i32(read_u32be(bufs, p + 12))
    bytes_pp = _i32(read_u32be(bufs, p + 16))
    frames_pp = _i32(read_u32be(bufs, p + 20))
    channels = _i32(read_u32be(bufs, p + 24))
    bits = _i32(read_u32be(bufs, p + 28))

    is_lpcm = codec == _LPCM
    is_ulaw = codec == _ULAW
    is_alaw = codec == _ALAW
    is_ima4 = codec == _IMA4
    g711 = is_ulaw | is_alaw

    is_float = is_lpcm & ((flags & _FLAG_FLOAT) != 0)
    lpcm_ok = is_lpcm & torch.where(
        is_float, (bits == 32) | (bits == 64),
        (bits == 8) | (bits == 16) | (bits == 24) | (bits == 32))
    # lpcm packets must be packed frames (no per-packet padding)
    lpcm_ok = lpcm_ok & (frames_pp == 1) & (
        bytes_pp == channels * _fdiv(bits, full(8)))
    g711_ok = g711 & (bytes_pp == channels) & (frames_pp == 1)
    ima4_ok = is_ima4 & (bytes_pp == 34 * channels) & (frames_pp == 64)
    supported = lpcm_ok | g711_ok | ima4_ok
    err = torch.where((err == E.ERR_OK) & ~supported, full(E.ERR_UNSUPPORTED),
                      err)
    bad_geom = (channels <= 0) | (sample_rate <= 0)
    err = torch.where((err == E.ERR_OK) & bad_geom, full(E.ERR_INVALID), err)

    bps = torch.where(g711, full(1), _fdiv(bits, full(8)))
    n_frames = torch.where(
        is_ima4,
        _fdiv(data_size, torch.clamp(34 * channels, min=1)) * 64,
        _fdiv(data_size, torch.clamp(channels * bps, min=1)),
    )
    # fmt_code: 0 lpcm-int, 1 lpcm-float, 4 ulaw, 5 alaw, 6 ima4 (the
    # AIFF family's G.711/ima4 codes)
    fmt_code = torch.where(
        is_ima4, full(6), torch.where(
            is_alaw, full(5), torch.where(is_ulaw, full(4),
                                          is_float.to(i32))))
    return dict(
        err=err,
        fmt_code=fmt_code,
        channels=channels,
        sample_rate=sample_rate,
        bits=bits,
        data_off=data_off,
        data_size=data_size,
        n_frames=n_frames,
        flags=flags,
    )


def parse_meta_batch(bufs: torch.Tensor, lens: torch.Tensor) -> dict:
    """Parse CAF headers for a packed batch: u8 [B, N] + lens [B] → dict of
    i32 [B] metadata tensors."""
    return _parse_one(bufs, lens)


def unpack_args(meta_host: dict) -> dict:
    """Static unpack config from desc: lpcm follows the float/endian flags;
    ulaw/alaw are G.711 bytes; ima4 is Apple IMA ADPCM in 34·C-byte
    groups."""
    code = int(meta_host["fmt_code"])
    if code == 6:
        return dict(
            bits=4, big_endian=True, unsigned8=False, is_float=False,
            companded=None, adpcm="ima4",
            block_align=34 * int(meta_host["channels"]),
        )
    if code in (4, 5):
        return dict(
            bits=8, big_endian=True, unsigned8=False, is_float=False,
            companded="ulaw" if code == 4 else "alaw",
        )
    return dict(
        bits=int(meta_host["bits"]),
        big_endian=not (int(meta_host["flags"]) & _FLAG_LITTLE),
        unsigned8=False,  # CAF integer lpcm is signed
        is_float=code == 1,
        companded=None,
    )

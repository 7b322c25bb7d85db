"""AIFF/AIFF-C header parsing as batched tensor ops.

The chunk walk (FORM → COMM, SSND in any IFF order) runs over every file
of a packed ``u8 [B, N]`` batch at once: the JAX package's per-file
``lax.while_loop`` under ``vmap`` becomes one bounded Python loop whose
state tensors are ``[B]`` and whose updates are masked to the files still
walking (as codecs/wav.py does).  The sample rate is COMM's IEEE 754
80-bit float (ops.bytes.read_ieee_extended).  Unpacking covers 8/16/24/
32-bit signed big-endian PCM and the AIFF-C codes sowt (little-endian
PCM), fl32/fl64 (big-endian IEEE float), ulaw/alaw (G.711) and ima4
(Apple IMA ADPCM, 34-byte packets).

COMM must be 18 bytes in AIFF and at least 22 in AIFF-C, else
ERR_INVALID.
"""

from __future__ import annotations

import torch

from ..core import errors as E
from ..ops.bytes import (f32_to_i32, fourcc, read_ieee_extended, read_tag,
                         read_u16be, read_u32be)
from .wav import _fdiv, _i32

_FORM = fourcc("FORM")
_AIFF = fourcc("AIFF")
_AIFC = fourcc("AIFC")
_COMM = fourcc("COMM")
_SSND = fourcc("SSND")
_NONE = fourcc("NONE")
_SOWT = fourcc("sowt")
_TWOS = fourcc("twos")  # explicit big-endian PCM (synonym of NONE)
_FL32 = fourcc("fl32")
_FL32U = fourcc("FL32")  # SoundManager emits uppercase variants
_FL64 = fourcc("fl64")
_FL64U = fourcc("FL64")
_ULAW = fourcc("ulaw")
_ULAWU = fourcc("ULAW")
_ALAW = fourcc("alaw")
_ALAWU = fourcc("ALAW")
_IMA4 = fourcc("ima4")  # Apple/QuickTime IMA: 34-byte 64-sample packets

_MAX_CHUNKS = 128


def _parse_one(bufs: torch.Tensor, lens: torch.Tensor) -> dict:
    """Chunk-walk every AIFF file of a packed batch → dict of int32 ``[B]``
    tensors: err, fmt_code, channels, sample_rate, bits, data_off,
    data_size, n_frames."""
    dev = bufs.device
    B = bufs.shape[0]
    i32 = torch.int32
    flen = lens.to(i32)

    def full(v):
        return torch.full((B,), v, dtype=i32, device=dev)

    form_type = read_tag(bufs, full(8))
    is_aifc = form_type == _AIFC
    ok_magic = ((flen >= 12) & (read_tag(bufs, full(0)) == _FORM)
                & ((form_type == _AIFF) | is_aifc))

    cursor, it = full(12), full(0)
    comm_off, comm_size = full(-1), full(0)
    ssnd_off, ssnd_size = full(-1), full(0)
    err = full(E.ERR_OK)
    for _ in range(_MAX_CHUNKS):
        active = ((cursor + 8 <= flen) & (it < _MAX_CHUNKS)
                  & ~((comm_off >= 0) & (ssnd_off >= 0)) & (err == E.ERR_OK))
        if not bool(active.any()):
            break
        cid = read_tag(bufs, cursor)
        csize = _i32(read_u32be(bufs, cursor + 4))
        payload = cursor + 8
        is_comm = active & (cid == _COMM)
        is_ssnd = active & (cid == _SSND)
        comm_off = torch.where(is_comm, payload, comm_off)
        comm_size = torch.where(is_comm, csize, comm_size)
        err = torch.where(is_ssnd & (payload + csize > flen), full(E.ERR_EOF),
                          err)
        ssnd_off = torch.where(is_ssnd, payload, ssnd_off)
        ssnd_size = torch.where(is_ssnd, csize, ssnd_size)
        # IFF chunks are word-aligned: odd sizes carry a pad byte
        cursor = torch.where(active, payload + csize + (csize & 1), cursor)
        it = torch.where(active, it + 1, it)

    err = torch.where(ok_magic, err, full(E.ERR_UNSUPPORTED))
    # COMM's size is checked as soon as COMM is seen, before a missing
    # SSND's EOF (a bad size misaligns the walk)
    bad_comm = (comm_off >= 0) & torch.where(is_aifc, comm_size < 22,
                                             comm_size != 18)
    err = torch.where((err == E.ERR_OK) & bad_comm, full(E.ERR_INVALID), err)
    missing = (comm_off < 0) | (ssnd_off < 0)
    err = torch.where((err == E.ERR_OK) & missing, full(E.ERR_EOF), err)

    p = torch.clamp(comm_off, min=0)
    channels = read_u16be(bufs, p).to(i32)
    comm_frames = _i32(read_u32be(bufs, p + 2))
    bits = read_u16be(bufs, p + 6).to(i32)
    sample_rate = f32_to_i32(torch.round(read_ieee_extended(bufs, p + 8)))

    q = torch.clamp(ssnd_off, min=0)
    # SSND payload: offset u32 + blockSize u32, then the samples
    offset = _i32(read_u32be(bufs, q))
    data_off = q + 8 + offset
    data_size = torch.clamp(ssnd_size - 8 - offset, min=0)

    # AIFF-C compression type (both case variants); COMM's sampleSize is
    # the decoded width for G.711, whose samples are stored 1 byte each
    comp = torch.where(is_aifc, read_tag(bufs, p + 18),
                       torch.full_like(form_type, _NONE))
    little = comp == _SOWT
    f32c = (comp == _FL32) | (comp == _FL32U)
    f64c = (comp == _FL64) | (comp == _FL64U)
    ulawc = (comp == _ULAW) | (comp == _ULAWU)
    alawc = (comp == _ALAW) | (comp == _ALAWU)
    g711 = ulawc | alawc
    int_ok = (((bits == 8) | (bits == 16) | (bits == 24) | (bits == 32))
              & ((comp == _NONE) | (comp == _TWOS) | little))
    float_ok = (f32c & (bits == 32)) | (f64c & (bits == 64))
    g711_ok = g711 & ((bits == 8) | (bits == 16))
    ima4 = comp == _IMA4
    supported = int_ok | float_ok | g711_ok | (ima4 & (bits == 16))
    err = torch.where((err == E.ERR_OK) & ~supported, full(E.ERR_UNSUPPORTED),
                      err)
    bad_geom = (channels <= 0) | (sample_rate <= 0)
    err = torch.where((err == E.ERR_OK) & bad_geom, full(E.ERR_INVALID), err)

    bps = torch.where(g711, full(1), _fdiv(bits, full(8)))
    denom = torch.clamp(channels * bps, min=1)
    # ima4: whole 34·C-byte packet groups of 64 frames each
    n_ima4 = _fdiv(data_size, torch.clamp(34 * channels, min=1)) * 64
    n_frames = torch.minimum(
        comm_frames, torch.where(ima4, n_ima4, _fdiv(data_size, denom)))
    # fmt_code: 0 BE PCM, 1 sowt LE PCM, 2 fl32, 3 fl64, 4 ulaw, 5 alaw,
    # 6 ima4
    fmt_code = torch.where(
        ima4, full(6), torch.where(
            alawc, full(5), torch.where(
                ulawc, full(4), torch.where(
                    f64c, full(3), torch.where(f32c, full(2),
                                               little.to(i32))))))
    return dict(
        err=err,
        fmt_code=fmt_code,
        channels=channels,
        sample_rate=sample_rate,
        bits=bits,
        data_off=data_off,
        data_size=data_size,
        n_frames=n_frames,
    )


def parse_meta_batch(bufs: torch.Tensor, lens: torch.Tensor) -> dict:
    """Parse AIFF headers for a packed batch: u8 [B, N] + lens [B] → dict
    of i32 [B] metadata tensors."""
    return _parse_one(bufs, lens)


def unpack_args(meta_host: dict) -> dict:
    """Static unpack config: AIFF is big-endian signed PCM at all depths;
    sowt (fmt_code 1) is little-endian, fl32/fl64 (2/3) big-endian IEEE
    float, ulaw/alaw (4/5) G.711 bytes, and ima4 (6) Apple IMA ADPCM in
    34·C-byte groups."""
    code = int(meta_host["fmt_code"])
    g711 = code in (4, 5)
    if code == 6:
        return dict(
            bits=4, big_endian=True, unsigned8=False, is_float=False,
            companded=None, adpcm="ima4",
            block_align=34 * int(meta_host["channels"]),
        )
    return dict(
        bits=8 if g711 else int(meta_host["bits"]),
        big_endian=code != 1,
        unsigned8=False,  # AIFF 8-bit is signed (unlike WAV)
        is_float=code in (2, 3),
        companded=("ulaw" if code == 4 else "alaw") if g711 else None,
    )

"""WAV/RIFF header parsing as batched tensor ops.

The chunk walk (RIFF → "fmt " → ... → "data") runs over every file of a
packed ``u8 [B, N]`` batch at once: the JAX package's per-file
``lax.while_loop`` under ``vmap`` becomes one Python loop whose state
tensors are ``[B]`` and whose updates are masked to the files still
walking.  Arithmetic is int32 where the JAX package's is, so sizes that
overflow wrap the same way on malformed headers.  Error reporting is
vectorized: each file carries an int32 code (core.errors).
"""

from __future__ import annotations

import torch

from ..core import errors as E
from ..ops.bytes import fourcc, read_tag, read_u16le, read_u32le

_RIFF = fourcc("RIFF")
_RF64 = fourcc("RF64")  # EBU 64-bit RIFF (data > 4 GB); sizes in ds64
_BW64 = fourcc("BW64")  # ITU-R BS.2088 synonym
_WAVE = fourcc("WAVE")
_FMT = fourcc("fmt ")
_DATA = fourcc("data")
_FACT = fourcc("fact")
_DS64 = fourcc("ds64")

FORMAT_PCM = 0x0001
FORMAT_MS_ADPCM = 0x0002
FORMAT_IEEE_FLOAT = 0x0003
FORMAT_ALAW = 0x0006
FORMAT_MULAW = 0x0007
FORMAT_IMA_ADPCM = 0x0011
FORMAT_EXTENSIBLE = 0xFFFE

_MAX_CHUNKS = 128


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wrap (the JAX ``astype``)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _fdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _parse_one(bufs: torch.Tensor, lens: torch.Tensor) -> dict:
    """Chunk-walk every WAV file of a packed batch.

    bufs: u8 ``[B, N]``; lens: ``[B]`` file lengths.  Returns a dict of
    int32 ``[B]`` tensors: err, fmt_code, channels, sample_rate, bits,
    data_off, data_size, n_frames, block_align."""
    dev = bufs.device
    B = bufs.shape[0]
    i32 = torch.int32
    flen = lens.to(i32)

    def full(v):
        return torch.full((B,), v, dtype=i32, device=dev)

    def read_u32_i32(off):
        return _i32(read_u32le(bufs, off))

    magic = read_tag(bufs, full(0))
    is_64 = (magic == _RF64) | (magic == _BW64)
    ok_magic = (flen >= 12) & ((magic == _RIFF) | is_64) & (
        read_tag(bufs, full(8)) == _WAVE)

    # walk state; RF64/BW64 keep their 64-bit sizes in ds64 and write
    # 0xFFFFFFFF (-1 as int32) in the data header — only the low words
    # are read, as in the JAX package
    cursor, it = full(12), full(0)
    fmt_off, fmt_size = full(-1), full(0)
    data_off, data_size = full(-1), full(0)
    fact_val, ds64_data, ds64_count = full(0), full(0), full(0)
    err = full(E.ERR_OK)
    for _ in range(_MAX_CHUNKS):
        active = ((cursor + 8 <= flen) & (it < _MAX_CHUNKS) & (data_off < 0)
                  & (err == E.ERR_OK))
        if not bool(active.any()):
            break
        cid = read_tag(bufs, cursor)
        csize = read_u32_i32(cursor + 4)
        payload = cursor + 8
        is_fmt = active & (cid == _FMT)
        is_data = active & (cid == _DATA)
        fmt_off = torch.where(is_fmt, payload, fmt_off)
        fmt_size = torch.where(is_fmt, csize, fmt_size)
        is_ds64 = active & (cid == _DS64) & (csize >= 24)
        ds64_data = torch.where(is_ds64, read_u32_i32(payload + 8), ds64_data)
        ds64_count = torch.where(is_ds64, read_u32_i32(payload + 16),
                                 ds64_count)
        # fact: dwSampleLength, the exact frame count of compressed formats
        is_fact = active & (cid == _FACT) & (csize >= 4)
        fact_val = torch.where(is_fact, read_u32_i32(payload), fact_val)
        csize = torch.where(is_data & is_64 & (csize == -1), ds64_data, csize)
        # a truncated (or negative, wrapped) data chunk is undecodable
        trunc = is_data & ((payload + csize > flen) | (csize < 0))
        err = torch.where(trunc, full(E.ERR_EOF), err)
        data_off = torch.where(is_data, payload, data_off)
        data_size = torch.where(is_data, csize, data_size)
        # RIFF chunks are word-aligned: odd sizes carry a pad byte
        cursor = torch.where(active, payload + csize + (csize & 1), cursor)
        it = torch.where(active, it + 1, it)

    err = torch.where(ok_magic, err, full(E.ERR_UNSUPPORTED))
    missing = (fmt_off < 0) | (data_off < 0)
    err = torch.where((err == E.ERR_OK) & missing, full(E.ERR_EOF), err)
    # ds64's sampleCount plays fact's role when no fact chunk is present
    fact_val = torch.where((fact_val == 0) & is_64, ds64_count, fact_val)

    # fmt payload fields; reads are clamped, garbage on errored files is
    # masked by `err` downstream
    p = torch.clamp(fmt_off, min=0)
    fmt_code = read_u16le(bufs, p).to(i32)
    channels = read_u16le(bufs, p + 2).to(i32)
    sample_rate = read_u32_i32(p + 4)
    block_align = read_u16le(bufs, p + 12).to(i32)
    bits = read_u16le(bufs, p + 14).to(i32)
    # WAVEFORMATEXTENSIBLE: the effective format is the SubFormat GUID's
    # leading u16
    cb_size = torch.where(fmt_size >= 18, read_u16le(bufs, p + 16).to(i32),
                          full(0))
    is_ext = (fmt_code == FORMAT_EXTENSIBLE) & (cb_size >= 22)
    sub_code = read_u16le(bufs, p + 24).to(i32)
    fmt_code = torch.where(is_ext, sub_code, fmt_code)

    supported = (
        ((fmt_code == FORMAT_PCM)
         & ((bits == 8) | (bits == 16) | (bits == 24) | (bits == 32)))
        | ((fmt_code == FORMAT_IEEE_FLOAT) & ((bits == 32) | (bits == 64)))
        | (((fmt_code == FORMAT_ALAW) | (fmt_code == FORMAT_MULAW))
           & (bits == 8))
    )
    is_ima = fmt_code == FORMAT_IMA_ADPCM
    is_ms = fmt_code == FORMAT_MS_ADPCM
    is_adpcm = is_ima | is_ms
    supported = supported | (is_adpcm & (bits == 4))
    err = torch.where((err == E.ERR_OK) & ~supported,
                      full(E.ERR_UNSUPPORTED), err)
    bad_geom = (channels <= 0) | (bits == 0)
    err = torch.where((err == E.ERR_OK) & bad_geom, full(E.ERR_INVALID), err)

    # ADPCM geometry: the declared wSamplesPerBlock (p+18) must match the
    # block's capacity when present; a fmt chunk too short to carry it
    # derives the count from block_align instead
    spb_absent = fmt_size < 20
    spb_decl = read_u16le(bufs, p + 18).to(i32)
    ch4 = torch.clamp(4 * channels, min=1)
    ima_w = _fdiv(block_align - 4 * channels, ch4)
    ima_ok = ((block_align > 4 * channels) & (block_align % ch4 == 0)
              & (spb_absent | (spb_decl == 1 + 8 * ima_w)))
    ch1 = torch.clamp(channels, min=1)
    ms_body = block_align - 7 * channels
    ms_spb = 2 + _fdiv(ms_body * 2, ch1)
    ms_ok = ((block_align > 7 * channels) & (channels <= 2)
             & (spb_absent | (spb_decl == ms_spb)))
    adpcm_ok = torch.where(is_ms, ms_ok, ima_ok)
    err = torch.where((err == E.ERR_OK) & is_adpcm & ~adpcm_ok,
                      full(E.ERR_INVALID), err)

    denom = torch.clamp(channels * _fdiv(bits, full(8)), min=1)
    ba1 = torch.clamp(block_align, min=1)
    full_blocks = _fdiv(data_size, ba1)
    rem = data_size - full_blocks * ba1
    ima_partial = torch.where(
        rem >= 4 * channels, 1 + _fdiv(rem - 4 * channels, ch4) * 8, full(0))
    ms_partial = torch.where(
        rem > 7 * channels, 2 + _fdiv((rem - 7 * channels) * 2, ch1), full(0))
    spb = torch.where(is_ms, ms_spb, 1 + 8 * ima_w)
    nf_adpcm = full_blocks * spb + torch.where(is_ms, ms_partial, ima_partial)
    nf_adpcm = torch.where(fact_val > 0, torch.minimum(nf_adpcm, fact_val),
                           nf_adpcm)
    n_frames = torch.where(is_adpcm, nf_adpcm, _fdiv(data_size, denom))
    return dict(
        err=err,
        fmt_code=fmt_code,
        channels=channels,
        sample_rate=sample_rate,
        bits=bits,
        data_off=data_off,
        data_size=data_size,
        n_frames=n_frames,
        block_align=block_align,
    )


def parse_meta_batch(bufs: torch.Tensor, lens: torch.Tensor) -> dict:
    """Parse WAV headers for a packed batch: u8 [B, N] + lens [B] → dict of
    i32 [B] metadata tensors."""
    return _parse_one(bufs, lens)


def unpack_args(meta_host: dict) -> dict:
    """Static unpack config for a single file's host-side meta row (used
    by the registry to group files into identically-typed batches)."""
    bits = int(meta_host["bits"])
    code = int(meta_host["fmt_code"])
    if code in (FORMAT_IMA_ADPCM, FORMAT_MS_ADPCM):
        return dict(
            bits=4, big_endian=False, unsigned8=False, is_float=False,
            companded=None,
            adpcm="ima" if code == FORMAT_IMA_ADPCM else "ms",
            block_align=int(meta_host["block_align"]),
        )
    return dict(
        bits=bits,
        big_endian=False,
        unsigned8=bits == 8,  # WAV convention: 8-bit PCM is unsigned
        is_float=code == FORMAT_IEEE_FLOAT,
        companded=(
            "alaw" if code == FORMAT_ALAW
            else ("ulaw" if code == FORMAT_MULAW else None)
        ),
    )

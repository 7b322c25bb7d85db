"""Sun AU / NeXT SND header parsing as batched tensor ops.

A fixed big-endian header (magic ".snd", data offset, data size,
encoding, rate, channels) followed by raw samples: no chunk walk, so the
parser is fixed-offset reads over every file of a packed ``u8 [B, N]``
batch at once.  Every encoding maps onto ``ops/unpack.unpack_pcm``:
G.711 µ-law/A-law, signed 8/16/24/32-bit big-endian PCM and IEEE
float32/64.  int32 arithmetic wraps as in the JAX package.

Encodings (header word 3): 1 µ-law, 2 int8, 3 int16, 4 int24, 5 int32,
6 float32, 7 float64, 27 A-law, all big-endian.
"""

from __future__ import annotations

import torch

from ..core import errors as E
from ..ops.bytes import fourcc, read_tag, read_u32be
from .wav import _fdiv, _i32

_MAGIC = fourcc(".snd")

#: encoding → (bits, is_float, companded): the decode capability matrix
ENCODINGS = {
    1: (8, False, "ulaw"),
    2: (8, False, None),
    3: (16, False, None),
    4: (24, False, None),
    5: (32, False, None),
    6: (32, True, None),
    7: (64, True, None),
    27: (8, False, "alaw"),
}


def _parse_one(bufs: torch.Tensor, lens: torch.Tensor) -> dict:
    """Read every AU header of a packed batch → dict of int32 ``[B]``
    tensors: err, fmt_code, channels, sample_rate, bits, data_off,
    data_size, n_frames."""
    dev = bufs.device
    B = bufs.shape[0]
    i32 = torch.int32
    flen = lens.to(i32)

    def full(v):
        return torch.full((B,), v, dtype=i32, device=dev)

    def word(off):
        return _i32(read_u32be(bufs, full(off)))

    ok_magic = (flen >= 24) & (read_tag(bufs, full(0)) == _MAGIC)
    data_off = word(4)
    data_size = word(8)
    enc = word(12)
    sample_rate = word(16)
    channels = word(20)

    err = torch.where(ok_magic, full(E.ERR_OK), full(E.ERR_UNSUPPORTED))
    bits = full(0)
    for code, (b, _f, _c) in ENCODINGS.items():
        bits = torch.where(enc == code, full(b), bits)
    err = torch.where((err == E.ERR_OK) & (bits == 0),
                      full(E.ERR_UNSUPPORTED), err)
    bad_geom = (channels <= 0) | (sample_rate <= 0) | (data_off < 24)
    err = torch.where((err == E.ERR_OK) & bad_geom, full(E.ERR_INVALID), err)
    err = torch.where((err == E.ERR_OK) & (data_off > flen), full(E.ERR_EOF),
                      err)

    # data_size 0xFFFFFFFF (-1 as int32) = "unknown, read to EOF"; any
    # declared size is clamped to the file
    avail = torch.clamp(flen - data_off, min=0)
    data_size = torch.where(data_size < 0, avail,
                            torch.minimum(data_size, avail))
    g711 = (enc == 1) | (enc == 27)
    bps = torch.where(g711, full(1), _fdiv(bits, full(8)))
    n_frames = _fdiv(data_size, torch.clamp(channels * bps, min=1))
    return dict(
        err=err,
        fmt_code=enc,
        channels=channels,
        sample_rate=sample_rate,
        bits=bits,
        data_off=data_off,
        data_size=data_size,
        n_frames=n_frames,
    )


def parse_meta_batch(bufs: torch.Tensor, lens: torch.Tensor) -> dict:
    """Parse AU headers for a packed batch: u8 [B, N] + lens [B] → dict of
    i32 [B] metadata tensors."""
    return _parse_one(bufs, lens)


def unpack_args(meta_host: dict) -> dict:
    """Static unpack config from the encoding word (all big-endian)."""
    bits, is_float, companded = ENCODINGS[int(meta_host["fmt_code"])]
    return dict(
        bits=8 if companded else bits,
        big_endian=True,
        unsigned8=False,  # AU 8-bit PCM is signed two's complement
        is_float=is_float,
        companded=companded,
    )

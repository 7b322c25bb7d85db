"""Fused PCM decode step: header parse + sample unpack in one call, for
WAV and AIFF.

The single-device half of the JAX package's ``parallel/decode.py``; the
mesh-sharded steps are not ported yet.
"""

from __future__ import annotations

import torch

from ..codecs import aiff as aiff_codec
from ..codecs import wav as wav_codec
from ..ops.unpack import unpack_pcm


def decode_pcm_step(
    bufs: torch.Tensor,
    lens: torch.Tensor,
    *,
    bits: int = 16,
    channels: int = 2,
    max_frames: int,
    family: str = "wav",
):
    """Parse + unpack a uniform-config batch of WAV (``family="wav"``) or
    AIFF (``"aiff"``) files.

    Returns (pcm ``[B, max_frames*channels]`` flat interleaved, meta dict
    of int32 ``[B]`` tensors).  Files whose actual geometry disagrees with
    the static config get err=ERR_INVALID rather than mis-decoding."""
    if family == "wav":
        meta = wav_codec.parse_meta_batch(bufs, lens)
        big_endian, unsigned8 = False, bits == 8
        # only plain integer PCM matches this step's static unpack config
        fmt_plain = meta["fmt_code"] == wav_codec.FORMAT_PCM
    elif family == "aiff":
        meta = aiff_codec.parse_meta_batch(bufs, lens)
        big_endian, unsigned8 = True, False
        # fmt_code 0 is big-endian integer PCM; sowt, floats, G.711 and
        # ima4 need other unpackers
        fmt_plain = meta["fmt_code"] == 0
    else:
        raise ValueError(f"decode_pcm_step: family must be 'wav' or 'aiff', "
                         f"got {family!r}")
    geom_ok = fmt_plain & (meta["bits"] == bits) & (meta["channels"] == channels)
    err = torch.where((meta["err"] == 0) & ~geom_ok,
                      torch.full_like(meta["err"], 3), meta["err"])
    n_frames = torch.where(err == 0, meta["n_frames"],
                           torch.zeros_like(meta["n_frames"]))
    pcm = unpack_pcm(
        bufs,
        meta["data_off"],
        n_frames,
        bits=bits,
        channels=channels,
        big_endian=big_endian,
        unsigned8=unsigned8,
        is_float=False,
        max_frames=max_frames,
    )
    meta = dict(meta, err=err, n_frames=n_frames)
    return pcm, meta

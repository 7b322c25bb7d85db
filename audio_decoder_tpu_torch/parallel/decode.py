"""Fused decode steps, on one device and sharded over a mesh.

``decode_pcm_step`` parses and unpacks a uniform WAV or AIFF batch in one
call.  The ``sharded_*_fn`` functions bind a decode to a mesh
(parallel/mesh.py), as the JAX package's ``parallel/decode.py`` does: the
file (or lane) axis shards over ``data`` and each data shard runs the
single-device step once, on the device at (data i, model 0); JAX runs it
on every ``model`` device of the row too, with equal results.  Decode
needs no collective but the WAV step's consensus (one gather of three
``[B]`` arrays) and the FLAC assemblies (K5).  Inputs may be tensors or
arrays anywhere (each shard's rows are copied to its device) or
``Sharded``; outputs are ``Sharded`` over files and ``Replicated``
scalars.  A leading axis the ``data`` size does not divide raises, as
JAX's ``jit`` does: ``pad_batch`` pads a WAV batch, ``round_sizing`` a
FLAC group's lane counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs import aiff as aiff_codec
from ..codecs import wav as wav_codec
from ..dsp.consensus import consensus_config
from ..ops.unpack import unpack_pcm
from . import mesh as M


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


def pad_batch(bufs, lens, multiple: int):
    """Pad the file axis to a multiple of the mesh's data-axis size.

    Zero-length rows are appended, which the parsers reject (err != 0,
    n_frames == 0), so padding rows add nothing to consensus or frame
    totals.  Returns host numpy (bufs, lens, valid), valid[b] False on
    padding."""
    bufs = np.asarray(bufs)
    lens = np.asarray(lens)
    B = bufs.shape[0]
    Bp = M.pad_to_multiple(max(B, 1), multiple)
    valid = np.zeros((Bp,), bool)
    valid[:B] = True
    if Bp == B:
        return bufs, lens, valid
    bufs = np.concatenate(
        [bufs, np.zeros((Bp - B,) + bufs.shape[1:], bufs.dtype)])
    lens = np.concatenate([lens, np.zeros((Bp - B,), lens.dtype)])
    return bufs, lens, valid


def round_sizing(sizing: dict, multiple: int) -> dict:
    """A FLAC group's sizing (codecs/flac/decoder.sizing_for) with the
    sharded counts F, Lr, Lw and Ld rounded up to a multiple of the data
    size (padding frames and lanes decode to nothing)."""
    return dict(sizing, **{k: M.pad_to_multiple(sizing[k], multiple)
                           for k in ("F", "Lr", "Lw", "Ld")})


def _per_shard(mesh, fn, *args) -> list:
    """``fn`` on each data shard's rows of every argument."""
    parts = [M.shard(a, mesh) for a in args]
    return [fn(*(p.shards[i] for p in parts))
            for i in range(mesh.shape["data"])]


def sharded_decode_fn(mesh, **static):
    """Bind ``decode_pcm_step`` to a mesh: ``step(bufs, lens)`` →
    (pcm ``Sharded``, meta {key: ``Sharded``}, rate, channels), the
    consensus rate and channel count ``Replicated``.  Consensus is one
    collective over every shard's meta: their sample rates, channel counts
    and error codes gathered on the first mesh device."""

    def step(bufs, lens):
        outs = _per_shard(mesh, lambda b, n: decode_pcm_step(b, n, **static),
                          bufs, lens)
        pcm = M.Sharded(tuple(p for p, _ in outs))
        meta = {k: M.Sharded(tuple(m[k] for _, m in outs)) for k in outs[0][1]}
        dev = mesh.devices[0]
        rate, ch = consensus_config(*(meta[k].gather(dev) for k in
                                      ("sample_rate", "channels", "err")))
        return pcm, meta, M.replicate(rate, mesh), M.replicate(ch, mesh)

    return step


def sharded_l12_fn(mesh, *, channels: int, steps: int):
    """Bind the Layer I/II synthesis (``layer12.l12_synthesize``, K2 on a
    card) to a mesh: ``step(codes, cls, sf_idx)`` → pcm ``Sharded`` over
    files, collective-free."""
    from ..codecs.mpeg.layer12 import l12_synthesize

    def step(codes, cls, sf_idx):
        return M.Sharded(tuple(_per_shard(
            mesh, lambda *a: l12_synthesize(*a, channels=channels, steps=steps),
            codes, cls, sf_idx)))

    return step


def sharded_mp3_decode_fn(mesh, *, channels: int, joint_stereo: bool,
                          n_big: int = 288, n_c1: int = 144,
                          granules_per_frame: int = 2):
    """Bind the fused Layer III decode (``dsp.mp3_decode_fused``: K1, the
    DSP tail, K2) to a mesh: ``step(*args)`` over the 16 tensors of
    ``decoder.fused_wire_args``, each with a leading file axis, → pcm
    ``Sharded`` over files.  One entropy scan of ``n_big``/``n_c1`` per
    shard; collective-free."""
    from ..codecs.mpeg.dsp import mp3_decode_fused

    def step(*args):
        if len(args) != 16:
            raise ValueError(f"sharded MP3 step takes the 16 wire tensors, "
                             f"got {len(args)}")
        return M.Sharded(tuple(_per_shard(
            mesh, lambda *a: mp3_decode_fused(
                *a, None, channels=channels, joint_stereo=joint_stereo,
                n_big=n_big, n_c1=n_c1, granules_per_frame=granules_per_frame),
            *args)))

    return step


def sharded_flac_fn(mesh, **static):
    """Bind the FLAC device decode to a mesh: ``step(*args)`` over
    ``decoder.pack_group``'s 28 tensors (the byte stream replicated, every
    descriptor sharded over ``data``) → (pcm, ovf) ``Sharded`` over files.
    The value and PCM assemblies are K5 calls (codecs/flac/device.py's
    ``_decode_on_mesh``); the group's sizing must be ``round_sizing``-ed to
    the data size."""
    from ..codecs.flac.device import flac_decode_batch

    def step(*args):
        return flac_decode_batch(*args, mesh=mesh, **static)

    return step

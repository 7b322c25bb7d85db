"""The multi-device dry run: every sharded path once, held against one
device.

It is the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: a WAV batch one file longer than
the ``data`` size (padded by ``pad_batch``, consensus over the shards),
then MP3 Layer III, Layer II and FLAC from bytes the caller passes (the
GPU machine has no MP3 or FLAC encoder), then the voice-sharded render.
Every requested path runs or raises; none is skipped.  Usage::

    from audio_decoder_tpu_torch.parallel import dryrun_multichip
    dryrun_multichip(8, devices=["cpu"] * 8, inputs={"flac": blob})
    dryrun_multichip(torch.cuda.device_count(), inputs={...})  # the cards
"""

from __future__ import annotations

import operator
import struct

import numpy as np
import torch

from . import mesh as M
from .decode import (pad_batch, round_sizing, sharded_decode_fn,
                     sharded_flac_fn, sharded_l12_fn, sharded_mp3_decode_fn)
from .render import shard_engine_state, sharded_render_fn

#: the bytes-driven paths, in the order they run
INPUT_PATHS = ("mp3", "layer2", "flac")
#: float32 bars: MP3 amplitude-scaled RMS, Layer II and the render max abs
MP3_RMS, L12_ATOL, RENDER_ATOL = 5e-7, 1e-6, 2e-6


def wav_blob(pcm: np.ndarray, rate: int) -> bytes:
    """A 16-bit PCM WAV file of ``pcm`` int16 ``[frames, channels]``."""
    data = pcm.astype("<i2").tobytes()
    ch = pcm.shape[1]
    fmt = struct.pack("<HHIIHH", 1, ch, rate, rate * ch * 2, ch * 2, 16)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def pack_mp3_group(blobs: list[bytes], device="cpu") -> tuple[list, dict]:
    """One channel layout's Layer III files → the 16 wire tensors of
    ``dsp.mp3_decode_fused`` on ``device`` and the keyword arguments of
    ``sharded_mp3_decode_fn`` (one scan over the group's widest lane)."""
    from ..codecs.mpeg import decoder as D
    from ..codecs.mpeg import native

    with native.Mp3Session(blobs) as sess:
        infos = sess.infos
        bad = [i for i, p in enumerate(infos) if p["err"] != 0]
        if bad or len({(p["channels"], p["joint"]) for p in infos}) != 1:
            raise ValueError(f"pack_mp3_group: files {bad} fail to walk or "
                             f"the channel layouts differ")
        ch = infos[0]["channels"]
        g_cap = D._bucket(max(p["n_granules"] for p in infos))
        m_cap = D._bucket(max(p["main_bytes"] for p in infos), 1024)
        r = sess.lanes_batch(list(range(len(blobs))), g_cap, m_cap, ch)
    args = D.fused_wire_args(r, D._rate_idx_arr(r["sample_rate"]), device)
    return args, dict(channels=ch, joint_stereo=bool(infos[0]["joint"]),
                      n_big=D._n_big(r["big"], r["valid"]), n_c1=144,
                      granules_per_frame=2 if infos[0]["sample_rate"] >= 32000
                      else 1)


def scaled_rms(ref, got) -> tuple[float, float]:
    """(RMS of ``got - ref``, its bar): ``MP3_RMS`` scaled by the signal's
    RMS / 0.2, as float32 round-off is relative to amplitude.  Tensors or
    arrays; the difference passes when RMS < bar."""
    ref, got = (np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float64)
                for a in (ref, got))
    rms = float(np.sqrt(((ref - got) ** 2).mean()))
    return rms, MP3_RMS * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _wav(mesh: M.Mesh, frames: int = 256) -> None:
    """An uneven WAV batch: the real files decode exactly, the padding
    rows err out, and consensus ignores them."""
    from ..io.assets import pack_bytes

    n = mesh.shape["data"] + 1
    rng = np.random.default_rng(0)
    pcm = [np.clip(rng.standard_normal((frames, 2)) * 8000, -32768,
                   32767).astype(np.int16) for _ in range(n)]
    bufs, lens, valid = pad_batch(*pack_bytes([wav_blob(p, 44100) for p in pcm]),
                                  mesh.shape["data"])
    out, meta, rate, ch = sharded_decode_fn(
        mesh, bits=16, channels=2, max_frames=frames, family="wav")(bufs, lens)
    err = meta["err"].gather("cpu").numpy()
    _check((err[valid] == 0).all() and (err[~valid] != 0).all(),
           f"WAV error codes {err}")
    _check(int(meta["n_frames"].gather("cpu")[~valid].sum()) == 0,
           "padding rows carry frames")
    _check((int(rate.value), int(ch.value)) == (44100, 2),
           f"consensus {int(rate.value)} Hz x {int(ch.value)}")
    got = out.gather("cpu")[:n].reshape(n, frames, 2)
    _check(torch.equal(got, torch.as_tensor(np.stack(pcm)) / 32768.0),
           "WAV PCM differs from its source")


def _mp3(mesh: M.Mesh, blob: bytes, B: int) -> None:
    from ..codecs.mpeg.dsp import mp3_decode_fused

    args, kw = pack_mp3_group([blob] * B)
    got = sharded_mp3_decode_fn(mesh, **kw)(*args).gather("cpu")
    dev = mesh.devices[0]
    one = mp3_decode_fused(*(a.to(dev) for a in args), None, **kw).cpu()
    _check(got.shape == one.shape and bool(torch.isfinite(got).all())
           and operator.lt(*scaled_rms(one, got)),
           "sharded MP3 differs from one device")


def _layer2(mesh: M.Mesh, blob: bytes, B: int) -> None:
    from ..codecs.mpeg import layer12 as L12
    from ..codecs.mpeg.decoder import pack_layer12

    an = L12.analyze_l2(blob)
    arrays = pack_layer12([an] * B, "cpu")
    kw = dict(channels=an.channels, steps=an.steps_per_frame)
    got = sharded_l12_fn(mesh, **kw)(*arrays).gather("cpu")
    dev = mesh.devices[0]
    one = L12.l12_synthesize(*(a.to(dev) for a in arrays), **kw).cpu()
    _check(torch.allclose(got, one, rtol=0, atol=L12_ATOL),
           "sharded Layer II differs from one device")


def _flac(mesh: M.Mesh, blob: bytes, B: int) -> None:
    from ..codecs.flac import decoder as FD
    from ..codecs.flac import frontend
    from ..codecs.flac.device import flac_decode_batch

    analyses = [frontend.analyze(blob)] * B
    sizing = round_sizing(FD.sizing_for(analyses), mesh.shape["data"])
    args, statics = FD.pack_group(analyses, "cpu", sizing)
    pcm, ovf = sharded_flac_fn(mesh, **statics)(*args)
    dev = mesh.devices[0]
    one, ovf1 = flac_decode_batch(*(a.to(dev) for a in args), **statics)
    _check(torch.equal(pcm.gather("cpu"), one.cpu())
           and torch.equal(ovf.gather("cpu"), ovf1.cpu()),
           "sharded FLAC differs from one device")
    _check(not bool(ovf1.any()), "FLAC lanes overflowed")


def _render(mesh: M.Mesh, frames: int = 128) -> None:
    """One voice with all three process kinds (seq + trem + env) and a
    second free voice, rendered for 3 blocks on the mesh and on one
    device."""
    from ..engine import commands as EC
    from ..engine import state as ES
    from ..engine.render import render_block

    dev = mesh.devices[0]
    tracks = np.zeros((2, 256, 2), np.float32)
    tracks[0, :8] = 0.5
    tracks[1] = np.random.default_rng(1).standard_normal((256, 2)) * 0.4
    st = ES.empty_state(tracks, [256, 256], [2, 2], out_channels=2, device=dev)
    reg = ES.HostRegistry(["t", "u"])
    proc = EC.CmdProcessor(reg, 44100)
    for line in ["load t -t s:64", "seq t -p 2 -s 0,1", "trem t -p 4 -d 0.3",
                 "env t -p 2 -d 0.5", "start -v t", "load u", "start -v u"]:
        st = EC.apply(st, reg, proc.parse(line))
    step = sharded_render_fn(mesh, frames=frames, out_channels=2)
    sst = shard_engine_state(st, mesh)
    for _ in range(3):
        ref, st = render_block(st, frames=frames, out_channels=2)
        block, sst = step(sst)
        _check(torch.allclose(block.value.to(dev), ref, rtol=0, atol=RENDER_ATOL),
               "sharded render block differs from one device")
    whole = sst.gather(dev)
    for k in ("v_pos", "v_active", "clock"):
        _check(torch.equal(getattr(whole, k), getattr(st, k)),
               f"sharded render {k} differs from one device")
    _check(float(ref.abs().max()) > 0.1, "the render is silent")


def _counts() -> dict:
    from ..codecs.mpeg import huffman_kernel as HK
    from ..ops import synth_kernel as SK
    from ..ops import window_add as PW

    return {"mp3_entropy_scan": HK.launches,
            "mp3_polyphase_synthesis": SK.launches, **PW.launches,
            **{f"collective_{k}": v for k, v in M.collectives.items()}}


def dryrun_multichip(n_devices: int, *, devices=None, inputs: dict) -> dict:
    """Run every sharded path on an ``n_devices`` mesh (``model`` 2 where
    ``n_devices`` is even and at least 4; the first ``n_devices`` visible
    cards, or of ``devices``), each held against one device: WAV and the
    render always, and MP3, Layer II and FLAC for each of ``inputs``'
    keys (``"mp3"``, ``"layer2"``, ``"flac"``: one file's bytes, decoded
    as twice the ``data`` size of copies).  Returns {"mesh": shape,
    "paths": the paths that ran, "launches": kernel launches and
    collectives during the run}; a path that fails raises."""
    unknown = sorted(set(inputs) - set(INPUT_PATHS))
    if unknown:
        raise ValueError(f"dryrun_multichip: unknown inputs {unknown}; "
                         f"takes {INPUT_PATHS}")
    model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = M.make_mesh(n_devices, model, devices=devices)
    before = _counts()
    paths = []
    _wav(mesh)
    paths.append("wav")
    B = 2 * mesh.shape["data"]
    for key, run in zip(INPUT_PATHS, (_mp3, _layer2, _flac)):
        if key in inputs:
            run(mesh, inputs[key], B)
            paths.append(key)
    _render(mesh)
    paths.append("render")
    after = _counts()
    return {"mesh": dict(mesh.shape), "paths": paths,
            "launches": {k: after[k] - before[k] for k in after}}

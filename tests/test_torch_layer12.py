"""PyTorch port, MPEG Layers I and II against the JAX package.

Inputs are random spec-valid frames from a seed: Layer I from
``tests/test_layer12.py::_l1_frames`` (stereo, mono, an intensity-stereo
bound), Layer II from ``tests/seeded_writers.layer2_frames`` (44.1/48/32
kHz, MPEG-2 22.05 kHz, mono and stereo, the low-rate tables).  The host
walk (``analyze_l1``/``analyze_l2``) must give the same arrays,
``l12_synthesize`` the same PCM within amplitude-scaled RMS 5e-7 (the
repo's float32 round-off bar), and ``decode_group`` the same metadata.
On the CPU the synthesis runs its plain twin, never the kernel.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audio_decoder_tpu as J
import audio_decoder_tpu_torch as P
from audio_decoder_tpu.codecs.mpeg import decoder as JD
from audio_decoder_tpu.codecs.mpeg import layer12 as JL
from audio_decoder_tpu.io.assets import Asset as JAsset
from audio_decoder_tpu_torch.codecs.mpeg import decoder as PD
from audio_decoder_tpu_torch.codecs.mpeg import layer12 as PL
from audio_decoder_tpu_torch.core import errors as E
from audio_decoder_tpu_torch.io.assets import Asset as PAsset
from audio_decoder_tpu_torch.ops import synth_kernel as SK

from .seeded_writers import layer1_frames, layer2_frames
from .test_layer12 import _l1_frames

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
L3_MP3 = os.path.join(DATA, "stereo_44k1_128k_js.mp3")

L1_CASES = {  # name: (channels, joint mode_ext)
    "l1_stereo": (2, None), "l1_mono": (1, None), "l1_joint": (2, 1),
}
L2_CASES = {  # name: layer2_frames keyword arguments
    "l2_44k1_192_stereo": dict(ch=2, sr=44100, kbps=192),
    "l2_48k_256_joint": dict(ch=2, sr=48000, kbps=256, joint_ext=1),
    "l2_32k_48_stereo_low": dict(ch=2, sr=32000, kbps=48),
    "l2_44k1_32_mono_low": dict(ch=1, sr=44100, kbps=32),
    "l2_22k05_64_lsf": dict(ch=2, sr=22050, kbps=64, version=2),
}


def _blob(name: str, n_frames: int = 10) -> bytes:
    seed = sum(map(ord, name))
    if name in L1_CASES:
        ch, ext = L1_CASES[name]
        return _l1_frames(np.random.default_rng(seed), n_frames, ch,
                          joint_ext=ext)
    kw = dict(L2_CASES[name])
    return layer2_frames(np.random.default_rng(seed), n_frames, kw.pop("ch"),
                         **kw)


NAMES = sorted(L1_CASES) + sorted(L2_CASES)


def _scaled_rms(ref, got):
    rms = float(np.sqrt(((ref - got) ** 2).mean()))
    return rms, 5e-7 * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)


def test_layer1_writer_equals_the_test_writer():
    """seeded_writers.layer1_frames (chip_smoke.py's Layer I input) gives
    _l1_frames's bytes from the same seed."""
    for ch, ext in L1_CASES.values():
        a = layer1_frames(np.random.default_rng(11), 6, ch, joint_ext=ext)
        b = _l1_frames(np.random.default_rng(11), 6, ch, joint_ext=ext)
        assert a == b


@pytest.mark.parametrize("name", NAMES)
def test_analyze_matches_jax(name):
    blob = _blob(name)
    fn = "analyze_l1" if name in L1_CASES else "analyze_l2"
    a, b = getattr(JL, fn)(blob), getattr(PL, fn)(blob)
    for k in ("sample_rate", "channels", "layer", "n_frames",
              "steps_per_frame"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("codes", "cls", "sf_idx"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert (b.cls > 0).any()  # the frames carry allocated subbands


@pytest.mark.parametrize("steps,channels", [(12, 2), (36, 1), (36, 2)])
def test_l12_synthesize_matches_jax(steps, channels):
    """Random codes of every class and scalefactor indices, silent (63)
    ones included."""
    rng = np.random.default_rng(steps + channels)
    B, F = 2, 6
    cls = rng.integers(0, 18, size=(B, F, channels, 32)).astype(np.int8)
    nb = PL._NB_BY_CLASS[cls.astype(np.int64)]
    codes = (rng.integers(0, 1 << 16, size=(B, F, channels, 32, steps))
             % ((1 << nb) - 1)[..., None]).astype(np.int32)
    sf_idx = rng.integers(0, 64, size=(B, F, channels, 32, 3)).astype(np.int8)
    kw = dict(channels=channels, steps=steps)
    ref = np.asarray(JL.l12_synthesize(jnp.asarray(codes), jnp.asarray(cls),
                                       jnp.asarray(sf_idx), **kw))
    launches = SK.launches
    got = PL.l12_synthesize(torch.as_tensor(codes), torch.as_tensor(cls),
                            torch.as_tensor(sf_idx), **kw)
    assert SK.launches == launches  # CPU: the plain twin
    assert got.dtype == torch.float32 and got.shape == ref.shape
    rms, bar = _scaled_rms(ref, got.numpy())
    assert rms < bar, (rms, bar)


def _files(names, ext_of=lambda n: "mp1" if n.startswith("l1") else "mp2"):
    return [(n, ext_of(n), _blob(n)) for n in names]


def _group(pkg, files):
    mod, Asset = (JD, JAsset) if pkg == "jax" else (PD, PAsset)
    assets = [Asset(path=f"{n}.{e}", name=n, ext=e, data=b) for n, e, b in files]
    kw = {} if pkg == "jax" else dict(device="cpu")
    out = {}
    for idxs, batch in mod.decode_group(assets, **kw):
        for row, i in enumerate(idxs):
            out[files[i][0]] = batch.file(row)
    return out


@pytest.mark.parametrize("layer", [1, 2])
def test_decode_group_matches_jax(layer):
    """Each layer's files in one group (one synthesis call per channel
    count), plus a garbage .mp2 that fails its walk."""
    names = sorted(L1_CASES if layer == 1 else L2_CASES)
    files = _files(names) + [("junk", "mp2", b"\xff\xfd" + bytes(300))]
    j, p = _group("jax", files), _group("torch", files)
    assert set(j) == set(p)
    for n in j:
        a, b = j[n], p[n]
        assert (a.err, a.sample_rate, a.num_channels, a.bits_per_sample,
                a.format) == (b.err, b.sample_rate, b.num_channels,
                              b.bits_per_sample, b.format), n
        assert a.pcm.shape == b.pcm.shape, n
        if b.pcm.size:
            rms, bar = _scaled_rms(a.pcm, b.pcm)
            assert rms < bar, (n, rms, bar)
    assert p["junk"].err != E.ERR_OK
    assert all(p[n].err == 0 and p[n].format == f"mp{layer}" for n in names)


def test_mixed_mpeg_folder_matches_jax(tmp_path):
    """A .mp1, a .mp2, a .mp3 that holds Layer II and a real Layer III
    .mp3 in one decode_dir: routed by layer on both sides."""
    for name, ext in (("l1_stereo", "mp1"), ("l2_44k1_192_stereo", "mp2"),
                      ("l2_48k_256_joint", "mp3")):
        (tmp_path / f"{name}.{ext}").write_bytes(_blob(name, 8))
    shutil.copyfile(L3_MP3, tmp_path / "layer3.mp3")
    jb, jn = J.decode_dir(str(tmp_path))
    launches = SK.launches
    pb, pn = P.decode_dir(str(tmp_path), device="cpu")
    assert SK.launches == launches
    assert pn == jn and pb.names == jb.names and pb.formats == jb.formats
    assert dict(zip(pb.names, pb.formats)) == {
        "l1_stereo": "mp1", "l2_44k1_192_stereo": "mp2",
        "l2_48k_256_joint": "mp2", "layer3": "mp3"}
    for k in ("sample_rate", "num_channels", "bits_per_sample",
              "valid_frames", "err"):
        np.testing.assert_array_equal(getattr(pb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    for i, name in enumerate(pb.names):
        a, b = jb.file(i), pb.file(i)
        assert a.pcm.shape == b.pcm.shape, name
        rms, bar = _scaled_rms(a.pcm, b.pcm)
        assert rms < bar, (name, rms, bar)

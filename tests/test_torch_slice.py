"""PyTorch port, the whole slice: ``decode_dir`` on a mixed WAV + MP3
folder against the JAX package's ``decode_dir``, both on the CPU.

Names, order, metadata and error codes must match exactly, WAV PCM
exactly, MP3 PCM to amplitude-scaled RMS below 5e-7 (the repo's float32
round-off bar, tests/test_mp3_tpu.py).  On the CPU no kernel launches.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import audio_decoder_tpu as J
import audio_decoder_tpu_torch as P
from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel as HK
from audio_decoder_tpu_torch.codecs.mpeg import native
from audio_decoder_tpu_torch.core import errors as E
from audio_decoder_tpu_torch.ops import synth_kernel as SK

from . import codec_refs as CR
from .synth import make_wav

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
LSF = os.path.join(DATA, "mono_22k05_lsf.mp3")


def _folder(path, with_mp3: bool):
    rng = np.random.default_rng(0x51CE)
    ints = lambda f, c, b: rng.integers(-(1 << (b - 1)), 1 << (b - 1),  # noqa: E731
                                        size=(f, c))
    files = {
        "a_stereo16.wav": make_wav(ints(3000, 2, 16), 44100, bits=16),
        "b_mono24.wav": make_wav(ints(2100, 1, 24), 48000, bits=24),
        "c_float.wav": make_wav(
            np.clip(rng.standard_normal((1500, 2)) * 0.3, -1, 1).astype(np.float32),
            44100, bits=32, float32=True),
        "d_stereo16b.wav": make_wav(ints(4000, 2, 16), 44100, bits=16),
        "garbage.wav": bytes(rng.integers(0, 256, size=700, dtype=np.uint8)),
        "notes.xyz": b"not audio",
    }
    if with_mp3:
        s = 0.3 * rng.standard_normal(11025)
        x = np.clip(np.stack([s, np.roll(s, 17) * 0.8], 1) * 30000,
                    -32768, 32767).astype(np.int16)
        files["m_joint.mp3"] = CR.lame_encode(x, 44100, 128, mode=1)
        files["a_stereo16.mp3"] = files["m_joint.mp3"]  # duplicate stem
    for name, blob in files.items():
        with open(os.path.join(path, name), "wb") as f:
            f.write(blob)
    if with_mp3:
        shutil.copyfile(LSF, os.path.join(path, "lsf.mp3"))


def _scaled_rms(ref, got):
    rms = float(np.sqrt(((ref - got) ** 2).mean()))
    return rms, 5e-7 * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)


@pytest.mark.skipif(not CR.have_lame(), reason="system lame not available")
def test_decode_dir_matches_jax(tmp_path):
    _folder(tmp_path, with_mp3=True)
    hk, sk = HK.launches, SK.launches
    jb, jn = J.decode_dir(str(tmp_path))
    pb, pn = P.decode_dir(str(tmp_path), device="cpu")
    assert (HK.launches, SK.launches) == (hk, sk)  # CPU: plain twins only

    assert pn == jn
    assert pb.names == jb.names and pb.formats == jb.formats
    assert pb.channels == jb.channels
    assert tuple(pb.data.shape) == tuple(jb.data.shape)
    assert pb.data.device.type == "cpu" and pb.data.dtype == torch.float32
    for k in ("sample_rate", "num_channels", "bits_per_sample",
              "valid_frames", "err"):
        np.testing.assert_array_equal(getattr(pb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    err = dict(zip(pb.names, pb.err.tolist()))
    assert err["notes"] == E.ERR_UNSUPPORTED and err["garbage"] != 0
    assert pb.formats[pb.names.index("a_stereo16")] == "mp3"  # first stem wins

    for i, name in enumerate(pb.names):
        a, b = jb.file(i), pb.file(i)
        assert a.pcm.shape == b.pcm.shape, name
        if pb.formats[i] == "wav":
            np.testing.assert_array_equal(a.pcm, b.pcm, err_msg=name)
        elif b.pcm.size:
            rms, bar = _scaled_rms(a.pcm, b.pcm)
            assert rms < bar, (name, rms, bar)
    # the whole padded batch agrees too (padding is zero on both sides)
    wav_rows = [i for i, f in enumerate(pb.formats) if f == "wav"]
    np.testing.assert_array_equal(pb.data.numpy()[wav_rows],
                                  np.asarray(jb.data)[wav_rows])


def test_decode_paths_wav_only_matches_jax(tmp_path):
    _folder(tmp_path, with_mp3=False)
    paths = sorted(str(p) for p in tmp_path.iterdir())
    jb = J.decode_paths(paths)
    pb = P.decode_paths(paths, device="cpu")
    assert pb.names == jb.names
    np.testing.assert_array_equal(pb.err.numpy(), np.asarray(jb.err))
    np.testing.assert_array_equal(pb.data.numpy(), np.asarray(jb.data))


@pytest.mark.parametrize("ext", ["aiff", "au", "caf", "mp1", "mp2"])
def test_families_not_ported_raise(tmp_path, ext):
    path = tmp_path / f"x.{ext}"
    path.write_bytes(b"\x00" * 64)
    with pytest.raises(NotImplementedError, match="not ported"):
        P.decode_paths([str(path)], device="cpu")


def test_native_frontend_builds_from_the_reference_source():
    """mp3fe is compiled from the port's copy of the reference source
    (native/mp3fe.cc) into the port's own build directory and answers a
    probe."""
    assert native.available()
    blob = open(LSF, "rb").read()
    info = native.probe(blob)
    assert (info["err"], info["channels"], info["sample_rate"]) == (0, 1, 22050)
    assert info["n_granules"] > 0 and not info["joint"]


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _folder(tmp_path, with_mp3=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.decode_dir(str(tmp_path), device="cuda")

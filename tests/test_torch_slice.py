"""PyTorch port, the whole decode surface: ``decode_dir`` on mixed
folders (WAV + MP3, then every family) against the JAX package's
``decode_dir``, both on the CPU.

Names, order, metadata and error codes must match exactly, integer and
PCM families exactly, MPEG PCM to amplitude-scaled RMS below 5e-7 (the
repo's float32 round-off bar, tests/test_mp3_tpu.py).  On the CPU no
kernel launches.
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


def _family_blob(ext: str) -> bytes:
    """A small valid file of the family behind ``ext``."""
    from .seeded_writers import layer1_frames, layer2_frames
    from .synth import make_aiff, make_au, make_caf

    rng = np.random.default_rng(sum(map(ord, ext)))
    pcm = rng.integers(-32768, 32768, size=(300, 2))
    if ext == "aiff":
        return make_aiff(pcm, 44100, 16)
    if ext == "au":
        return make_au(pcm, 22050, 3)
    if ext == "caf":
        return make_caf(pcm, 48000, bits=16, little=True)
    if ext == "mp1":
        return layer1_frames(rng, 4, 2)
    return layer2_frames(rng, 4, 2)


def _assert_batches_match(jb, pb):
    assert pb.names == jb.names and pb.formats == jb.formats
    for k in ("sample_rate", "num_channels", "bits_per_sample",
              "valid_frames", "err"):
        np.testing.assert_array_equal(getattr(pb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    for i, name in enumerate(pb.names):
        a, b = jb.file(i), pb.file(i)
        assert a.pcm.shape == b.pcm.shape, name
        if pb.formats[i] in ("mp1", "mp2", "mp3"):
            if not b.pcm.size:
                continue
            rms, bar = _scaled_rms(a.pcm, b.pcm)
            assert rms < bar, (name, rms, bar)
        else:
            np.testing.assert_array_equal(a.pcm, b.pcm, err_msg=name)


@pytest.mark.parametrize("ext", ["aiff", "au", "caf", "mp1", "mp2"])
def test_families_decode_like_jax(tmp_path, ext):
    path = tmp_path / f"x.{ext}"
    path.write_bytes(_family_blob(ext))
    jb = J.decode_paths([str(path)])
    pb = P.decode_paths([str(path)], device="cpu")
    assert int(pb.err[0]) == 0 and pb.data.device.type == "cpu"
    _assert_batches_match(jb, pb)


def test_every_family_in_one_folder_matches_jax(tmp_path):
    """The whole decode surface in one decode_dir: WAV, IMA and MS ADPCM
    WAV, AIFF, AIFF-C ima4, AU, CAF, mp1, mp2, a Layer II .mp3, Layer III,
    FLAC, garbage and an unknown extension."""
    from . import ima_ref as IR
    from . import ms_ref as MR
    from .seeded_writers import ima_wav, ms_wav
    from .synth import make_aiff

    rng = np.random.default_rng(0xA11)
    tone = np.clip(rng.normal(0, 3000, size=(700, 2)), -32768,
                   32767).astype(np.int16)
    files = {f"f_{e}.{e}": _family_blob(e)
             for e in ("aiff", "au", "caf", "mp1", "mp2")}
    files.update({
        "pcm.wav": make_wav(tone.astype(np.int64), 44100, bits=16),
        "ima.wav": ima_wav(IR.encode(tone, 512), 2, 512),
        "ms.wav": ms_wav(MR.encode(tone, 256), 2, 256),
        "ima4.aifc": make_aiff(np.zeros((0, 2), np.int16), 44100, 16,
                               compression=b"ima4",
                               data_override=IR.encode_ima4(tone),
                               frames_override=700),
        "layer2.mp3": _family_blob("mp2"),
        "garbage.au": rng.integers(0, 256, size=500).astype(np.uint8).tobytes(),
        "random.mp2": rng.integers(0, 256, size=900).astype(np.uint8).tobytes(),
        "notes.xyz": b"not audio",
    })
    for name, blob in files.items():
        (tmp_path / name).write_bytes(blob)
    shutil.copyfile(os.path.join(DATA, "stereo_44k1_128k_js.mp3"),
                    tmp_path / "layer3.mp3")
    shutil.copyfile(os.path.join(DATA, "mono_48k_s24.flac"),
                    tmp_path / "mono24.flac")
    jb, jn = J.decode_dir(str(tmp_path))
    hk, sk = HK.launches, SK.launches
    pb, pn = P.decode_dir(str(tmp_path), device="cpu")
    assert (HK.launches, SK.launches) == (hk, sk)  # CPU: plain twins only
    assert pn == jn
    _assert_batches_match(jb, pb)
    err = dict(zip(pb.names, pb.err.tolist()))
    assert err["notes"] == E.ERR_UNSUPPORTED
    assert err["garbage"] != 0 and err["random"] != 0
    assert all(v == 0 for k, v in err.items()
               if k not in ("notes", "garbage", "random"))
    assert dict(zip(pb.names, pb.formats))["layer2"] == "mp2"


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

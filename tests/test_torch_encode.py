"""PyTorch port, the PCM writers (io/encode.py) against the JAX package.

Every comparison is byte for byte on the CPU: ``pack_pcm`` at 8/16/24/32
bits, little and big endian, unsigned 8-bit and f32, with and without the
TPDF dither (the port draws JAX's ``jax.random.uniform`` bits with its own
threefry); every container writer (WAV, RF64, AIFF with integer and
fractional rates, AU, CAF both byte orders); ``write_audio``,
``export_batch`` and the ``export``/``transcode`` subcommands.  The port's
output is also read back by the port's own decoders.  The ``.flac``
writer (``write_audio`` and ``export``) decodes equal to JAX's ``.flac`` of
the same input with the same STREAMINFO MD5; tests/test_torch_flac_encode.py
holds the encoder's bytes against JAX's.
"""

import numpy as np
import pytest
import torch

import audio_decoder_tpu.io.encode as JE
import audio_decoder_tpu_torch as P
import audio_decoder_tpu_torch.io.encode as PE
from audio_decoder_tpu_torch import cli

CPU = "cpu"


def _grid_pcm(rng, bits, frames=311, ch=2):
    hi = 1 << (bits - 1)
    ints = rng.integers(-hi, hi, size=(frames, ch))
    if bits == 32:
        ints &= ~0xFF
    return (ints.astype(np.float64) / hi).astype(np.float32)


def _wild_pcm(rng, frames=257, ch=2):
    """Off-grid values, out-of-range values, exact halves and edges."""
    x = (rng.standard_normal((frames, ch)) * 0.6).astype(np.float32)
    x[:8, 0] = [1.5, -1.5, 1.0, -1.0, 0.0, -0.0, 0.5 / 32768, -1.5 / 32768]
    x[8:12, -1] = [np.float32(32767.5 / 32768), 2.5 / 128, -2.5 / 128, 3e-5]
    return x


PACK_CASES = [
    dict(bits=8, unsigned8=True), dict(bits=8), dict(bits=16),
    dict(bits=16, big_endian=True), dict(bits=24), dict(bits=24, big_endian=True),
    dict(bits=32), dict(bits=32, big_endian=True), dict(bits=32, is_float=True),
    dict(bits=32, is_float=True, big_endian=True),
]


@pytest.mark.parametrize("case,dither", [
    (c, d) for c, kw in enumerate(PACK_CASES) for d in (None, 0, 1, 12345)
    if d is None or not kw.get("is_float")])  # float words take no dither
def test_pack_pcm_bytes_match_jax(rng, case, dither):
    kw = PACK_CASES[case]
    pcm = _wild_pcm(rng)
    want = np.asarray(JE.pack_pcm(pcm, dither=dither, **kw))
    got = PE.pack_pcm(torch.as_tensor(pcm), dither=dither, **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(want, got.numpy())


def test_pack_pcm_odd_sizes_and_nan(rng):
    for frames, ch in ((1, 1), (7, 3), (333, 1)):
        pcm = _wild_pcm(rng, frames + 12, ch)[:frames]
        pcm[0, 0] = np.nan
        for kw in PACK_CASES:
            np.testing.assert_array_equal(
                np.asarray(JE.pack_pcm(pcm, dither=5, **kw)
                           if not kw.get("is_float") else JE.pack_pcm(pcm, **kw)),
                (PE.pack_pcm(torch.as_tensor(pcm), dither=5, **kw)
                 if not kw.get("is_float") else
                 PE.pack_pcm(torch.as_tensor(pcm), **kw)).numpy())


def test_pack_pcm_rejects_bad_configs():
    x = torch.zeros((4, 2))
    for kw in (dict(bits=12), dict(bits=16, is_float=True),
               dict(bits=16, unsigned8=True)):
        with pytest.raises(ValueError):
            PE.pack_pcm(x, **kw)


WRITER_CASES = [
    ("wav", dict(bits=8)), ("wav", dict(bits=16)), ("wav", dict(bits=24)),
    ("wav", dict(bits=32)), ("wav", dict(bits=32, float_=True)),
    ("wav", dict(bits=16, rf64=True)), ("wav", dict(bits=24, rf64=True)),
    ("wav", dict(bits=16, dither=3)),
    ("aiff", dict(bits=8)), ("aiff", dict(bits=16)), ("aiff", dict(bits=24)),
    ("aiff", dict(bits=32)), ("aiff", dict(bits=16, dither=9)),
    ("au", dict(bits=8)), ("au", dict(bits=16)), ("au", dict(bits=24)),
    ("au", dict(bits=32)), ("au", dict(bits=32, float_=True)),
    ("caf", dict(bits=16)), ("caf", dict(bits=24, little=True)),
    ("caf", dict(bits=32, float_=True)), ("caf", dict(bits=32, little=True)),
    ("caf", dict(bits=16, dither=2)),
]


@pytest.mark.parametrize("rate", [8000, 44100, 96000])
@pytest.mark.parametrize("case", range(len(WRITER_CASES)))
def test_writer_bytes_match_jax(rng, case, rate):
    kind, kw = WRITER_CASES[case]
    pcm = _wild_pcm(rng, frames=129 if kw.get("bits") == 8 else 130)
    if kind != "wav":
        pcm = pcm[:, :1] if case % 2 else pcm
    want = getattr(JE, f"encode_{kind}")(pcm, rate, **kw)
    got = getattr(PE, f"encode_{kind}")(pcm, rate, device=CPU, **kw)
    assert got == want


@pytest.mark.parametrize("rate", [22050.5, 11025.25, 44100.0])
def test_aiff_fractional_rates_match_jax(rng, rate):
    pcm = _grid_pcm(rng, 16, frames=50, ch=1)
    assert PE.encode_aiff(pcm, rate, device=CPU) == JE.encode_aiff(pcm, rate)


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_wav_round_trip_through_the_ports_decoder(rng, bits):
    pcm = _grid_pcm(rng, bits)
    blob = PE.encode_wav(pcm, 44100, bits=bits, device=CPU)
    from audio_decoder_tpu_torch.codecs.registry import decode_assets
    from audio_decoder_tpu_torch.io.assets import Asset

    f = decode_assets([Asset(path="a.wav", name="a", ext="wav", data=blob)],
                      device=CPU).file(0)
    assert f.err == 0 and (f.sample_rate, f.num_channels) == (44100, 2)
    np.testing.assert_array_equal(f.pcm, pcm)


def test_write_audio_dispatch(tmp_path, rng):
    pcm = _grid_pcm(rng, 16, frames=64)
    for name in ("x.wav", "x.aif", "x.aiff", "x.au", "x.snd", "x.caf"):
        P.write_audio(str(tmp_path / name), pcm, 44100, bits=16, device=CPU)
        JE.write_audio(str(tmp_path / ("j" + name)), pcm, 44100, bits=16)
        assert (tmp_path / name).read_bytes() == (tmp_path / ("j" + name)).read_bytes()
    with pytest.raises(ValueError, match="no encoder"):
        P.write_audio(str(tmp_path / "x.mp3"), pcm, 44100, device=CPU)
    with pytest.raises(ValueError, match="float AIFF"):
        P.write_audio(str(tmp_path / "y.aif"), pcm, 44100, bits=32, float_=True,
                      device=CPU)
    P.write_audio(str(tmp_path / "y.flac"), pcm, 44100, device=CPU)
    JE.write_audio(str(tmp_path / "jy.flac"), pcm, 44100)
    _same_flac(tmp_path / "y.flac", tmp_path / "jy.flac")
    assert PE.FLOAT_CONTAINERS == JE.FLOAT_CONTAINERS


def _same_flac(mine, theirs):
    """Two .flac files decode (port, CPU) to the same PCM and carry the same
    STREAMINFO MD5, which matches the decoded integers."""
    from audio_decoder_tpu_torch.codecs.flac import frontend as PF

    batch = P.decode_paths([str(mine), str(theirs)], device=CPU)
    a, b = batch.file(0), batch.file(1)
    assert a.err == b.err == 0 and a.sample_rate == b.sample_rate
    np.testing.assert_array_equal(a.pcm, b.pcm)
    an = PF.analyze(mine.read_bytes())
    assert an.md5 == PF.analyze(theirs.read_bytes()).md5
    scale = 2.0 ** (a.bits_per_sample - 1)
    ints = np.round(a.pcm.astype(np.float64) * scale).astype(np.int64)
    assert PF.verify_md5(an, ints) is True


def test_writers_default_to_the_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PE.encode_wav(_grid_pcm(rng, 16, frames=8), 44100)


def _assets(tmp_path, rng):
    src = tmp_path / "assets"
    src.mkdir()
    a = _grid_pcm(rng, 16, frames=300, ch=2)
    b = _grid_pcm(rng, 16, frames=150, ch=1)
    JE.write_audio(str(src / "a.wav"), a, 44100, bits=16)
    JE.write_audio(str(src / "b.aiff"), b, 22050, bits=16)
    (src / "junk.wav").write_bytes(b"RIFFnope")
    return src


@pytest.mark.parametrize("container,kw", [("aiff", {}), ("wav", {"bits": 24}),
                                          ("caf", {"dither": 4}),
                                          ("au", {"bits": 8})])
def test_export_batch_matches_jax(tmp_path, rng, container, kw):
    import audio_decoder_tpu as J

    src = _assets(tmp_path, rng)
    jb, jn = J.decode_dir(str(src))
    pb, pn = P.decode_dir(str(src), device=CPU)
    want = J.export_batch(str(tmp_path / "j"), jb, jn, container=container, **kw)
    got = P.export_batch(str(tmp_path / "p"), pb, pn, container=container,
                         device=CPU, **kw)
    assert sorted(got) == sorted(want) == ["a", "b"]
    for name in got:
        assert open(got[name], "rb").read() == open(want[name], "rb").read()
    with pytest.raises(ValueError, match="no encoder"):
        P.export_batch(str(tmp_path / "x"), pb, pn, container="mp3", device=CPU)


def test_export_cli_matches_jax(tmp_path, rng, capsys):
    from audio_decoder_tpu import cli as jcli

    src = _assets(tmp_path, rng)
    assert cli.main(["--platform", "cpu", "export", "--assets", str(src),
                     "--out", str(tmp_path / "p"), "--container", "caf",
                     "--dither", "7"]) == 0
    assert jcli.main(["export", "--assets", str(src), "--out",
                      str(tmp_path / "j"), "--container", "caf",
                      "--dither", "7"]) == 0
    for name in ("a.caf", "b.caf"):
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert not (tmp_path / "p" / "junk.caf").exists()
    assert "2 written, 1 skipped" in capsys.readouterr().out
    assert cli.main(["--platform", "cpu", "export", "--assets", str(src),
                     "--out", str(tmp_path / "pf"), "--container", "flac"]) == 0
    assert "2 written, 1 skipped" in capsys.readouterr().out
    assert jcli.main(["export", "--assets", str(src), "--out",
                      str(tmp_path / "jf"), "--container", "flac"]) == 0
    for name in ("a.flac", "b.flac"):
        _same_flac(tmp_path / "pf" / name, tmp_path / "jf" / name)
    assert not (tmp_path / "pf" / "junk.flac").exists()


def test_transcode_cli_matches_jax(tmp_path, rng):
    from audio_decoder_tpu import cli as jcli

    pcm = _grid_pcm(rng, 16, frames=500)
    src = tmp_path / "in.wav"
    JE.write_audio(str(src), pcm, 44100, bits=16)
    for args in ([], ["--bits", "24"], ["--float"]):
        ext = "wav" if "--float" in args else "aiff"
        po, jo = tmp_path / f"p.{ext}", tmp_path / f"j.{ext}"
        assert cli.main(["--platform", "cpu", "transcode", str(src), str(po)] + args) == 0
        assert jcli.main(["transcode", str(src), str(jo)] + args) == 0
        assert po.read_bytes() == jo.read_bytes()
    for args in ([], ["--bits", "24"]):
        po, jo = tmp_path / "p.flac", tmp_path / "j.flac"
        assert cli.main(["--platform", "cpu", "transcode", str(src), str(po)] + args) == 0
        assert jcli.main(["transcode", str(src), str(jo)] + args) == 0
        _same_flac(po, jo)
    # resampling: the port's resampler is held to JAX within 2e-6
    # (tests/test_torch_resample.py), so only the length and the decode
    out = tmp_path / "half.wav"
    assert cli.main(["--platform", "cpu", "transcode", str(src), str(out),
                     "--rate", "22050"]) == 0
    g = P.decode_paths([str(out)], device=CPU).file(0)
    assert g.err == 0 and g.sample_rate == 22050 and abs(g.pcm.shape[0] - 250) <= 2
    assert cli.main(["--platform", "cpu", "transcode", str(src),
                     str(tmp_path / "x.flac"), "--float"]) == 1
    assert not (tmp_path / "x.flac").exists()

"""PyTorch port, the host-Huffman MP3 route against the JAX package on the
CPU: mp3fe's ``analyze_batch`` binding, ``analyze_assets``,
``decode_analyses`` and ``decode_group_hosthuff``.

Inputs: the committed joint-stereo and LSF fixtures, an MPEG-1 mono and a
plain (not joint) stereo stream written from a seed by tests/mp3_writer.py,
and a broken file of seeded random bytes.

Tolerances, stated with their reasons:
* the host analysis (native and Python front-ends) is integer work: every
  array, its dtype and ``st``'s absence are compared for equality;
* metadata and error codes are exact;
* PCM: amplitude-scaled RMS below 5e-7, the repo's float32 round-off bar
  for MP3 (tests/test_mp3_tpu.py), against JAX and against the port's own
  device-Huffman route (``decode_group``) on the same bytes.
"""

import os

import numpy as np
import pytest
import torch

from audio_decoder_tpu.codecs.mpeg import decoder as JD
from audio_decoder_tpu.codecs.mpeg import native as JN
from audio_decoder_tpu.io.assets import Asset as JAsset
from audio_decoder_tpu_torch.codecs.mpeg import decoder as PD
from audio_decoder_tpu_torch.codecs.mpeg import native as PN
from audio_decoder_tpu_torch.io.assets import Asset
from audio_decoder_tpu_torch.utils import build

from .mp3_writer import make_l3_frame

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")


def _frames(rng, n: int, mode: int) -> bytes:
    """``n`` MPEG-1 44.1 kHz frames (mode 3 mono, 0 plain stereo) with
    seeded spectra and block types."""
    ch = 1 if mode == 3 else 2
    out = []
    for _ in range(n):
        spectra = tuple(rng.integers(-1, 2, size=2 * int(rng.integers(8, 120)))
                        for _ in range(ch))
        bt = int(rng.choice([0, 1, 2, 3]))
        out.append(make_l3_frame(sr=44100, mode=mode, mode_ext=0,
                                 spectra=spectra, block_type=(bt, bt)))
    return b"".join(out)


def _blobs() -> dict:
    rng = np.random.default_rng(0x4055)
    blobs = {n: open(os.path.join(DATA, f), "rb").read()
             for n, f in (("joint", "stereo_44k1_128k_js.mp3"),
                          ("lsf", "mono_22k05_lsf.mp3"))}
    blobs["mono"] = _frames(rng, 12, 3)
    blobs["mono_short"] = _frames(rng, 5, 3)
    blobs["stereo"] = _frames(rng, 9, 0)
    blobs["broken"] = rng.integers(0, 256, size=3000).astype(np.uint8).tobytes()
    return blobs


BLOBS = _blobs()
NAMES = tuple(BLOBS)


def _assets(names=NAMES) -> list:
    return [Asset(path=f"{n}.mp3", name=n, ext="mp3", data=BLOBS[n])
            for n in names]


def _jax_assets(names=NAMES) -> list:
    return [JAsset(path=f"{n}.mp3", name=n, ext="mp3", data=BLOBS[n])
            for n in names]


def scaled_rms(ref: np.ndarray, got: np.ndarray) -> tuple[float, float]:
    """(rms of the difference, its bar: 5e-7 scaled by the signal's RMS/0.2)."""
    rms = float(np.sqrt(((ref - got) ** 2).mean()))
    return rms, 5e-7 * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)


#: analyze_batch groups: (files, channels, joint) — the group's own
#: geometry, a padded group of two lengths, no stereo bytes for plain
#: stereo, and a group whose mono and broken files the batch rejects
BATCH_CASES = {
    "joint": (("joint",), 2, True),
    "lsf": (("lsf",), 1, False),
    "mono_padded": (("mono", "mono_short"), 1, False),
    "stereo_not_joint": (("stereo",), 2, False),
    "mismatch_and_broken": (("joint", "lsf", "broken"), 2, True),
}


@pytest.mark.parametrize("case", BATCH_CASES)
def test_analyze_batch_equals_jax(case):
    names, ch, joint = BATCH_CASES[case]
    blobs = [BLOBS[n] for n in names]
    g_cap = PD._bucket(max(PN.probe(b)["n_granules"] for b in blobs))
    walks_p, walks_j = PN.frame_walks(), JN.frame_walks()
    got = PN.analyze_batch(blobs, g_cap, ch, joint)
    ref = JN.analyze_batch(blobs, g_cap, ch, joint)
    # the same native walks per call as JAX's binding
    assert PN.frame_walks() - walks_p == JN.frame_walks() - walks_j > 0
    assert got.keys() == ref.keys()
    for k in ref:
        if ref[k] is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (got["st"] is None) == (not (ch == 2 and joint))
    if case == "mismatch_and_broken":
        assert got["err"][0] == 0 and got["err"][1] == 3 and got["err"][2] != 0
        assert not got["is_q"][1:].any()  # nothing written for rejects


def test_analyze_assets_matches_jax():
    got_an, got_fail = PD.analyze_assets(_assets())
    ref_an, ref_fail = JD.analyze_assets(_jax_assets())
    assert got_fail == ref_fail
    assert [NAMES[i] for i, _ in got_fail] == ["broken"]
    assert [i for i, _ in got_an] == [i for i, _ in ref_an]
    for (_, a), (_, b) in zip(got_an, ref_an):
        assert (a.sample_rate, a.channels, a.n_granules, a.joint_stereo) == (
            b.sample_rate, b.channels, b.n_granules, b.joint_stereo)
        for k in ("is_q", "exp_b", "st_mode", "blockcfg"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if y is not None:
                np.testing.assert_array_equal(x, y, err_msg=k)


def _assert_batch_matches(pb, jb, names=None):
    """Metadata and error codes exact, PCM within the RMS bar."""
    assert pb.names == (jb.names if names is None else names)
    assert pb.formats == jb.formats and pb.channels == jb.channels
    assert pb.data.device.type == "cpu" and pb.data.dtype == torch.float32
    assert tuple(pb.data.shape) == tuple(jb.data.shape)
    for k in ("sample_rate", "num_channels", "bits_per_sample",
              "valid_frames", "err"):
        np.testing.assert_array_equal(getattr(pb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    got, ref = pb.data.numpy(), np.asarray(jb.data)
    assert np.isfinite(got).all()
    rms, bar = scaled_rms(ref, got)
    assert rms < bar, (pb.names, rms, bar)


@pytest.mark.parametrize("key", [(2, True), (1, False)],
                         ids=["joint", "mono"])
def test_decode_analyses_matches_jax(key):
    """One (channels, joint) group of ``analyze_assets``: the joint-stereo
    fixture, and the mono group (LSF and MPEG-1, two lengths)."""
    got_an, _ = PD.analyze_assets(_assets())
    ref_an, _ = JD.analyze_assets(_jax_assets())

    def group(ans):
        items = [(i, a) for i, a in ans if (a.channels, a.joint_stereo) == key]
        return [i for i, _ in items], [a for _, a in items]

    pi, pb = PD.decode_analyses(*group(got_an), device="cpu")
    ji, jb = JD.decode_analyses(*group(ref_an))
    assert pi == ji and len(pi) == (1 if key[0] == 2 else 3)
    _assert_batch_matches(pb, jb)
    assert pb.names == tuple(str(i) for i in pi)


def _pieces_by_name(pieces, assets) -> dict:
    out = {}
    for idxs, batch in pieces:
        for row, i in enumerate(idxs):
            out[assets[i].name] = (batch, batch.file(row))
    return out


def test_decode_group_hosthuff_matches_jax():
    assets = _assets()
    got = PD.decode_group_hosthuff(assets, device="cpu")
    ref = JD.decode_group_hosthuff(_jax_assets())
    assert [i for i, _ in got] == [i for i, _ in ref]
    for (idxs, pb), (_, jb) in zip(got, ref):
        _assert_batch_matches(pb, jb,
                              names=tuple(assets[i].name for i in idxs))
    err = {n: f.err for n, (_, f) in _pieces_by_name(got, assets).items()}
    assert err.pop("broken") != 0 and set(err.values()) == {0}


def test_decode_group_hosthuff_matches_the_device_huffman_route():
    """The host-Huffman route against the port's own ``decode_group`` (the
    Huffman decode on the device) on the same bytes, file by file."""
    assets = _assets()
    host = _pieces_by_name(PD.decode_group_hosthuff(assets, device="cpu"), assets)
    dev = _pieces_by_name(PD.decode_group(assets, device="cpu"), assets)
    assert host.keys() == dev.keys() == set(NAMES)
    for name in NAMES:
        (_, h), (_, d) = host[name], dev[name]
        assert (h.err, h.sample_rate, h.num_channels, h.bits_per_sample) == (
            d.err, d.sample_rate, d.num_channels, d.bits_per_sample), name
        assert h.pcm.shape == d.pcm.shape, name
        if h.err == 0:
            rms, bar = scaled_rms(d.pcm, h.pcm)
            assert rms < bar, (name, rms, bar)


def test_hosthuff_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means the card, so without one both entry points
    raise rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PD.decode_group_hosthuff(_assets(("lsf",)))
    an, _ = PD.analyze_assets(_assets(("lsf",)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PD.decode_analyses([0], [an[0][1]])


def test_hosthuff_raises_without_mp3fe(monkeypatch):
    """Without mp3fe the route raises ``BuildError``; it has no Python
    fallback (JAX's falls back to ``analyze_assets``)."""
    def missing():
        raise build.BuildError("mp3fe unavailable")

    monkeypatch.setattr(PN, "_load", missing)
    with pytest.raises(build.BuildError):
        PD.decode_group_hosthuff(_assets(("lsf",)), device="cpu")
    with pytest.raises(build.BuildError):
        PN.frame_walks()

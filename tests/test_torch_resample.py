"""PyTorch port, the batch DSP (consensus, resample, route) against the JAX
package.

The same numpy-seeded inputs go through both packages on the CPU:
``consensus_config`` and ``valid_frames`` must match exactly, the
polyphase weights bit for bit, resampled PCM within max abs 2e-6 and
amplitude-scaled RMS 5e-7 (the torch product sums in another order than
XLA's einsum: 6e-7 worst seen), a resampled 1 kHz tone above 60 dB SNR
(the bar of ``tests/test_resample.py``), and routed PCM within 1e-6.  A
TF32 product would miss the resample bound by three orders of magnitude.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audio_decoder_tpu as J
import audio_decoder_tpu_torch as P
from audio_decoder_tpu.core.batch import AudioBatch as JBatch
from audio_decoder_tpu.dsp import consensus as JC
from audio_decoder_tpu.dsp import resample as JR
from audio_decoder_tpu.dsp import route as JRT
from audio_decoder_tpu_torch.core.batch import AudioBatch as PBatch
from audio_decoder_tpu_torch.dsp import consensus as PC
from audio_decoder_tpu_torch.dsp import resample as PR
from audio_decoder_tpu_torch.dsp import route as PRT

from .test_resample import _snr_vs_tone, _tone

CPU = "cpu"
MAX_ABS = 2e-6
RMS_TOL = 5e-7
PAIRS = [(48000, 44100), (44100, 48000), (32000, 44100), (44100, 32000),
         (22050, 44100), (48000, 32000)]


def _close(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    if ref.size == 0:
        return
    err = float(np.abs(ref - got).max())
    rms = float(np.sqrt(((ref - got) ** 2).mean()))
    bar = RMS_TOL * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)
    assert err <= MAX_ABS and rms < bar, (err, rms, bar)


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("src,dst", PAIRS)
def test_poly_matrix_flat_equals_jax(src, dst, C):
    L, M = PR._ratio(src, dst)
    assert (L, M) == JR._ratio(src, dst)
    mine, ref = PR._poly_matrix_flat(L, M, C), JR._poly_matrix_flat(L, M, C)
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(PR._poly_matrix(L, M), JR._poly_matrix(L, M))
    assert torch.equal(PR._wf_tensor(L, M, C, torch.device(CPU)),
                       torch.as_tensor(ref))


@pytest.mark.parametrize("src,dst", PAIRS)
def test_resample_batch_matches_jax(src, dst):
    """Random stereo noise within the bound of JAX; a 1 kHz tone above
    60 dB SNR."""
    rng = np.random.default_rng(src + dst)
    x = (rng.standard_normal((3, src // 5, 2)) * 0.3).astype(np.float32)
    got = P.resample_batch(x, src, dst, device=CPU)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    _close(JR.resample_batch(x, src, dst), got.numpy())
    tone = P.resample_batch(_tone(1000.0, src), src, dst, device=CPU)
    y = tone.numpy()[0, :, 0]
    assert y.shape[0] >= int(0.49 * dst)
    assert _snr_vs_tone(y, 1000.0, dst) > 60.0


@pytest.mark.parametrize("S", [0, 1, 159, 160, 161])
def test_resample_short_rows_match_jax(S):
    """Rows shorter than one polyphase frame, and at its edges."""
    x = np.random.default_rng(S).standard_normal((2, S, 2)).astype(np.float32)
    got = P.resample_batch(x, 48000, 44100, device=CPU).numpy()
    _close(JR.resample_batch(x, 48000, 44100), got)


def test_resample_batch_identity():
    x = _tone(440, 44100)
    got = P.resample_batch(x, 44100, 44100, device=CPU)
    np.testing.assert_array_equal(got.numpy(), x)


def _pcm_batch(rates, frames, err=None, seed=0):
    """A [B, S, 2] batch of 1 kHz tones plus noise 70 dB under them, each
    row at its own rate, as both packages' AudioBatch (from_pcm)."""
    rng = np.random.default_rng(seed)
    B, S = len(rates), max(frames)
    pcm = np.zeros((B, S, 2), np.float32)
    for i, (r, n) in enumerate(zip(rates, frames)):
        t = np.arange(n) / r
        s = 0.5 * np.sin(2 * np.pi * 1000 * t)[:, None] + 1e-4 * (
            rng.standard_normal((n, 2)))
        pcm[i, :n] = s
    meta = dict(
        sample_rate=np.asarray(rates, np.int32),
        num_channels=np.full(B, 2, np.int32),
        bits_per_sample=np.full(B, 16, np.int32),
        valid_frames=np.asarray(frames, np.int32),
        err=np.asarray(err if err is not None else [0] * B, np.int32),
    )
    names = tuple(f"f{i}" for i in range(B))
    j = JBatch.from_pcm(jnp.asarray(pcm), names=names, formats=("wav",) * B,
                        **{k: jnp.asarray(v) for k, v in meta.items()})
    p = PBatch.from_pcm(torch.as_tensor(pcm), names=names,
                        formats=("wav",) * B,
                        **{k: torch.as_tensor(v) for k, v in meta.items()})
    return j, p, pcm


def test_from_pcm_matches_jax():
    j, p, pcm = _pcm_batch([44100, 48000], [300, 200])
    assert p.channels == j.channels == 2
    np.testing.assert_array_equal(p.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(p.pcm.numpy(), pcm)
    assert p.file(1).pcm.shape == j.file(1).pcm.shape == (200, 2)


@pytest.mark.parametrize("length", ["floor", "exact"])
def test_resample_to_consensus_matches_jax(length):
    rates = [48000, 44100, 32000, 22050, 48000, 44100, 96000]
    frames = [4800, 4410, 3201, 2205, 4799, 4000, 9600]
    err = [0, 0, 0, 0, 0, 0, 3]  # the errored row keeps its rate
    j, p, pcm = _pcm_batch(rates, frames, err)
    jo = JR.resample_to_consensus(j, 44100, length=length)
    po = P.resample_to_consensus(p, 44100, length=length, device=CPU)
    assert po.data.device.type == "cpu" and po.channels == jo.channels
    assert po.names == jo.names and po.formats == jo.formats
    for k in ("sample_rate", "num_channels", "bits_per_sample",
              "valid_frames", "err"):
        got, ref = getattr(po, k), np.asarray(getattr(jo, k))
        assert got.dtype == torch.int32, k
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=k)
    assert po.sample_rate.tolist() == [44100] * 6 + [96000]
    _close(np.asarray(jo.data), po.data.numpy())
    # rows already at the consensus rate are untouched, bit for bit
    for i in (1, 5):
        n = frames[i] * 2
        np.testing.assert_array_equal(po.data[i, :n].numpy(),
                                      pcm[i].reshape(-1)[:n])
        assert not po.data[i, pcm.shape[1] * 2:].any()
    # the errored row is zero
    assert not po.data[6].any()
    # the tone survives every ratio
    for i in (0, 2, 3, 4):
        y = po.pcm[i, : int(po.valid_frames[i]), 0].numpy()
        assert _snr_vs_tone(y, 1000.0, 44100) > 60.0


@pytest.mark.parametrize("rates", [[44100, 44100], [22050, 22050, 96000]])
def test_resample_to_consensus_passes_a_uniform_batch_through(rates):
    err = [0] * (len(rates) - 1) + [0 if len(rates) == 2 else 1]
    j, p, _pcm = _pcm_batch(rates, [100] * len(rates), err)
    target = 44100 if len(rates) == 2 else 22050
    jo = JR.resample_to_consensus(j, target)
    po = P.resample_to_consensus(p, target, device=CPU)
    assert jo is j  # JAX hands the batch back as it is
    assert torch.equal(po.data, p.data)
    np.testing.assert_array_equal(po.sample_rate.numpy(),
                                  np.asarray(jo.sample_rate))
    np.testing.assert_array_equal(po.valid_frames.numpy(),
                                  np.asarray(jo.valid_frames))


def test_resample_to_consensus_rejects_a_bad_length_policy():
    j, p, _pcm = _pcm_batch([48000, 44100], [10, 10])
    for fn in (lambda: JR.resample_to_consensus(j, 44100, length="round"),
               lambda: P.resample_to_consensus(p, 44100, length="round",
                                               device=CPU)):
        with pytest.raises(ValueError, match="length policy"):
            fn()


ROUTES = {  # name: (c_in, c_out, scale, matrix)
    "1to2": (1, 2, 0.5, None), "2to1": (2, 1, 0.5, None),
    "4to2": (4, 2, 0.3, None), "2to4": (2, 4, 0.5, None),
    "2to2": (2, 2, 0.5, None), "3to2": (3, 2, 0.3, None),
    "clip": (2, 1, 3.0, np.array([[1.5], [1.5]])),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_channels_matches_jax(name):
    c_in, c_out, scale, m = ROUTES[name]
    x = (np.random.default_rng(c_in * 10 + c_out).standard_normal(
        (3, 257, c_in)) * scale).astype(np.float32)
    np.testing.assert_array_equal(PRT.routing_matrix(c_in, c_out),
                                  JRT.routing_matrix(c_in, c_out))
    got = P.route_channels(x, c_out, m, device=CPU)
    ref = np.asarray(JRT.route_channels(jnp.asarray(x), c_out, m))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert float(got.abs().max()) <= 1.0
    if name == "clip":
        assert (got.abs() == 1.0).any()


CONSENSUS = {  # name: (rates, channels, err)
    "majority": ([44100, 48000, 44100, 22050], [2, 1, 2, 6], [0, 0, 0, 0]),
    "tie-first-seen": ([48000, 44100, 44100, 48000], [1, 2, 1, 1],
                       [0, 0, 0, 0]),
    "tie-after-errors": ([96000, 96000, 32000, 48000], [8, 8, 2, 1],
                         [1, 2, 0, 0]),
    "errors-masked": ([8000, 8000, 8000, 44100], [6, 6, 6, 1], [1, 1, 1, 0]),
    "all-errors": ([8000, 22050], [1, 1], [1, 3]),
    "one": ([32000], [1], [0]),
    "empty": ([], [], []),
}


@pytest.mark.parametrize("name", sorted(CONSENSUS))
def test_consensus_config_matches_jax(name):
    rates, chans, err = (np.asarray(v, np.int32) for v in CONSENSUS[name])
    jr, jc = JC.consensus_config(jnp.asarray(rates), jnp.asarray(chans),
                                 jnp.asarray(err))
    pr, pc = PC.consensus_config(torch.as_tensor(rates),
                                 torch.as_tensor(chans), torch.as_tensor(err))
    assert pr.dtype == pc.dtype == torch.int32
    assert (int(pr), int(pc)) == (int(jr), int(jc))
    if name in ("all-errors", "empty"):
        assert (int(pr), int(pc)) == (44100, 2)
    if name.startswith("tie"):
        assert int(pr) == int(rates[err == 0][0])


def test_consensus_for_a_decoded_folder(tmp_path):
    """consensus_for on the same mixed folder in both packages."""
    from .synth import make_aiff, make_wav

    rng = np.random.default_rng(5)
    for i, (rate, ch) in enumerate(((48000, 2), (44100, 1), (48000, 1),
                                    (22050, 6))):
        pcm = rng.integers(-3000, 3000, size=(100, ch))
        (tmp_path / f"w{i}.wav").write_bytes(make_wav(pcm, rate, 16))
    (tmp_path / "a.aif").write_bytes(make_aiff(rng.integers(
        -3000, 3000, size=(50, 2)), 44100, 16))
    (tmp_path / "bad.wav").write_bytes(b"\x00" * 64)
    jb, _ = J.decode_dir(str(tmp_path))
    pb, _ = P.decode_dir(str(tmp_path), device=CPU)
    got = P.consensus_for(pb, device=CPU)
    assert got == J.consensus_for(jb)
    assert got[1] == 6 and got[0] in (44100, 48000)  # a two-way tie

"""PyTorch port, MP3 DSP: synthesis filterbank and the DSP tail against the
JAX package on the CPU.

Tolerances, stated with their reasons:
* one-hot selections (band → line, stereo slot → coefficients) are exact
  in f32 on both sides: compared for equality;
* the polyphase synthesis sums in another order than XLA: atol 1e-4,
  rtol 1e-5, the JAX package's own kernel-vs-XLA bar
  (tests/test_pallas_synth.py);
* requantization's ``|x|^(4/3)`` and ``2^(e/4)`` come from two math
  libraries whose f32 ``pow``/``exp2`` are not correctly rounded (XLA's
  CPU versions are fast approximations), and the two results are
  multiplied together: rtol 16 float32 ulps (1.9e-6);
* PCM from the DSP tail: amplitude-scaled RMS below 5e-7, the repo's
  float32 round-off bar for MP3 (tests/test_mp3_tpu.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_decoder_tpu.codecs.mpeg import dsp as JD
from audio_decoder_tpu.codecs.mpeg import frontend as FE
from audio_decoder_tpu_torch.codecs.mpeg import dsp as PD
from audio_decoder_tpu_torch.ops import synth_kernel as SK

from . import codec_refs as CR

F32_ULP16 = 16 * float(np.finfo(np.float32).eps)


def scaled_rms(ref: np.ndarray, got: np.ndarray) -> tuple[float, float]:
    """(rms of the difference, its bar: 5e-7 scaled by the signal's RMS/0.2)."""
    rms = float(np.sqrt(((ref - got) ** 2).mean()))
    return rms, 5e-7 * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)


def test_polyphase_synthesis_matches_xla():
    rng = np.random.default_rng(3)
    TS = (rng.standard_normal((2, 2, 100, 32)) * 0.3).astype(np.float32)
    ref = np.asarray(JD.polyphase_synthesis(jnp.asarray(TS)))
    got = PD.polyphase_synthesis(torch.as_tensor(TS)).numpy()
    assert got.shape == ref.shape == (2, 100 * 32 * 2)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_synthesis_wrapper_uses_plain_on_cpu_and_rejects_other_devices():
    rng = np.random.default_rng(4)
    ts = torch.as_tensor(rng.standard_normal((3, 40, 32)).astype(np.float32))
    c = PD._consts("cpu")
    before = SK.launches
    out = SK.polyphase_synthesis_blocks(ts, c["synth_n"], c["g2"])
    assert SK.launches == before
    assert torch.equal(out, SK.synthesis_plain(ts, c["synth_n"], c["g2"]))
    with pytest.raises(ValueError, match="unsupported device"):
        SK.polyphase_synthesis_blocks(ts.to("meta"), c["synth_n"].to("meta"),
                                      c["g2"].to("meta"))


def _rand_side(rng, B=2, G=6, C=2):
    is_q = rng.integers(-40, 41, size=(B, G, C, 576)).astype(np.int16)
    is_q[rng.random(is_q.shape) < 0.5] = 0
    is_q[:, :, :, 400:] = 0
    exp_b = rng.integers(-120, 30, size=(B, G, C, 61)).astype(np.int16)
    blockcfg = rng.choice([0, 1, 2, 3, 6], size=(B, G, C)).astype(np.int8)
    rate_idx = np.array([0, 4], np.int32)[:B]
    return is_q, exp_b, blockcfg, rate_idx


def test_band_to_lines_is_exact_and_matches_jax():
    rng = np.random.default_rng(5)
    _q, exp_b, blockcfg, rate_idx = _rand_side(rng)
    vals = rng.standard_normal(exp_b.shape).astype(np.float32)
    cfg_j, _, _ = JD._expand_blockcfg(jnp.asarray(blockcfg))
    cfg_p, _, _ = PD._expand_blockcfg(torch.as_tensor(blockcfg))
    np.testing.assert_array_equal(np.asarray(cfg_j), cfg_p.numpy())
    ref = np.asarray(JD._band_to_lines(jnp.asarray(vals), cfg_j,
                                       jnp.asarray(rate_idx)))
    got = PD._band_to_lines(torch.as_tensor(vals), cfg_p,
                            torch.as_tensor(rate_idx)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_requantize_matches_jax():
    rng = np.random.default_rng(6)
    is_q, exp_b, blockcfg, rate_idx = _rand_side(rng)
    cfg_j, _, _ = JD._expand_blockcfg(jnp.asarray(blockcfg))
    cfg_p, _, _ = PD._expand_blockcfg(torch.as_tensor(blockcfg))
    ref = np.asarray(JD._requantize(jnp.asarray(is_q), jnp.asarray(exp_b),
                                    cfg_j, jnp.asarray(rate_idx)))
    got = PD._requantize(torch.as_tensor(is_q), torch.as_tensor(exp_b), cfg_p,
                         torch.as_tensor(rate_idx)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=F32_ULP16, atol=0)


def test_derive_stereo_coeffs_matches_jax():
    rng = np.random.default_rng(7)
    B, G = 3, 8
    is_r = rng.integers(-3, 4, size=(B, G, 576)).astype(np.int16)
    for b in range(B):
        for g in range(G):
            is_r[b, g, rng.integers(0, 577):] = 0  # varied zero regions
    st_flags = rng.integers(0, 16, size=(B, G)).astype(np.int8)
    sfr = rng.integers(0, 8, size=(B, G, 61)).astype(np.int8)
    bc_r = rng.choice([0, 1, 2, 3, 6], size=(B, G)).astype(np.int8)
    rate_idx = np.array([0, 3, 8], np.int32)
    args = (is_r, st_flags, sfr, bc_r, rate_idx)
    ref = np.asarray(JD.derive_stereo_coeffs(*[jnp.asarray(a) for a in args]))
    got = PD.derive_stereo_coeffs(*[torch.as_tensor(a) for a in args]).numpy()
    np.testing.assert_array_equal(got, ref)


def test_compact_lane_wire_matches_jax():
    rng = np.random.default_rng(8)
    is_q, exp_b, blockcfg, rate_idx = _rand_side(rng)
    start = rng.integers(0, 1 << 16, size=blockcfg.shape).astype(np.int32)
    end = start + rng.integers(0, 4000, size=start.shape)
    limit = end + rng.integers(0, 100, size=start.shape)
    a = JD.compact_lane_wire(start, end, limit, exp_b, blockcfg, rate_idx)
    b = PD.compact_lane_wire(start, end, limit, exp_b, blockcfg, rate_idx)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _sig(n: int, ch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = 0.3 * rng.standard_normal(n)
    s[:: 3000] = 0.9  # transients: short blocks
    x = np.stack([s, np.roll(s, 17) * 0.8], 1) if ch == 2 else s[:, None]
    return np.clip(x * 30000, -32768, 32767).astype(np.int16)


@pytest.mark.skipif(not CR.have_lame(), reason="system lame not available")
@pytest.mark.parametrize("ch,mode,sr", [(2, 1, 44100), (1, 3, 22050)])
def test_mp3_dsp_tail_matches_jax(ch, mode, sr):
    blob = CR.lame_encode(_sig(sr // 4, ch, ch), sr, 96, mode=mode)
    an = FE.analyze(blob)
    G, C = an.n_granules, an.channels
    args = [an.is_q.reshape(1, G * C, 576), an.exp_b.reshape(1, G * C * 61),
            None if an.st_mode is None else an.st_mode.reshape(1, G * 576),
            an.blockcfg.reshape(1, G * C), np.asarray([an.rate_idx], np.int32)]
    kw = dict(channels=C, joint_stereo=an.joint_stereo)
    ref = np.asarray(JD.mp3_dsp_tail(
        *[None if a is None else jnp.asarray(a) for a in args], **kw))
    got = PD.mp3_dsp_tail(
        *[None if a is None else torch.as_tensor(a) for a in args], **kw).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    rms, bar = scaled_rms(ref, got)
    assert rms < bar, (rms, bar)

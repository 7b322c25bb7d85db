"""PyTorch port, the FLAC encoder (codecs/flac/encode.py) against the JAX
package on the CPU.

Seeded numpy inputs go through JAX's encoder and the port's:

* pass A (``flac_cost_batch``): the integer arrays exactly; the f32 cost
  sums within 1e-6 relative and the autocorrelation within 1e-6 of its lag
  0 (the sums run in another order than XLA's); a FIXED order may differ
  only on a frame whose two costs tie within 1e-6;
* pass B (``flac_residual_batch``) on JAX's plan: ``sub`` and ``resid``
  exactly, ``psums`` within 1e-6 relative;
* the whole encode with JAX's pass-A arrays put in place of the port's:
  the bytes equal JAX's at every level, so the planner, pass B and the
  packer are exact;
* the whole encode on its own: byte-equal at levels 0-2 (FIXED only); at
  the LPC levels a quantized coefficient may flip, so there the stream
  decodes bit for bit to the quantized input through both packages'
  decoders with a matching MD5, within 0.5% of JAX's size.

Block sizes stay within 256-1,152 and the audio under 2 s.
"""

import inspect
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audio_decoder_tpu_torch as P
from audio_decoder_tpu.codecs.flac import encode as JX
from audio_decoder_tpu.codecs.flac import frontend as JF
from audio_decoder_tpu_torch.codecs.flac import encode as PX
from audio_decoder_tpu_torch.codecs.flac import frontend as PF
from audio_decoder_tpu_torch.io.assets import Asset
from audio_decoder_tpu_torch.utils import trace

from .test_flac_device import _device_decode
from .test_torch_cuda import (check_pass_a, check_pass_b, flac_blocked,
                              flac_music)

CPU = "cpu"


def _content(rng, kind, S, C):
    if kind == "noise":
        return rng.uniform(-1.0, 1.0, size=(S, C)).astype(np.float32)
    if kind == "tone":
        return flac_music(rng, S, C)
    if kind == "silence":
        return np.zeros((S, C), np.float32)
    # "wild": NaN, ±inf, out-of-range and exact-half samples in music
    x = flac_music(rng, S, C)
    x[::97, 0] = np.nan
    x[5::89, -1] = np.inf
    x[9::83, 0] = -np.inf
    x[11::61, -1] = 3.5
    x[13::67, 0] = -2.0
    x[15::71, -1] = np.float32(0.5 / 128)
    return x


def _pass_a(x, blocksize, *, bits, maxo, names, dither):
    xb, nvalid = flac_blocked(x, blocksize)
    C = x.shape[1]
    w = JX.window_bank(names, blocksize) if maxo > 0 else None
    kw = dict(bits=bits, channels=C, nmax=blocksize, maxo=maxo, dither=dither)
    j = JX.flac_cost_batch(jnp.asarray(xb), jnp.asarray(nvalid),
                           None if w is None else jnp.asarray(w), **kw)
    p = PX.flac_cost_batch(torch.from_numpy(xb), torch.from_numpy(nvalid),
                           None if w is None else torch.from_numpy(w), **kw)
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: v.numpy() for k, v in p.items()}, nvalid)


#: (bits, channels, maxo, windows, dither, content, S, blocksize)
PASS_A_CASES = {
    "16-stereo-o8-tone": (16, 2, 8, 1, None, "tone", 9000, 1024),
    "16-stereo-o12-6win-noise": (16, 2, 12, 6, None, "noise", 5000, 1152),
    "8-mono-o0-noise": (8, 1, 0, 1, None, "noise", 3000, 256),
    "24-6ch-o8-dither-tone": (24, 6, 8, 1, 7, "tone", 4000, 512),
    "16-stereo-o0-dither-silence": (16, 2, 0, 1, 7, "silence", 2000, 512),
    "24-stereo-o12-6win-wild": (24, 2, 12, 6, None, "wild", 6000, 1024),
    "8-stereo-o8-dither-wild": (8, 2, 8, 1, 7, "wild", 3000, 512),
    "16-6ch-o12-6win-silence": (16, 6, 12, 6, None, "silence", 1500, 256),
}


def _names(nw):
    return JX.LEVELS[8][1] if nw == 6 else ("tukey(0.5)",)


@pytest.mark.parametrize("case", PASS_A_CASES)
def test_pass_a_matches_jax(rng, case):
    bits, C, maxo, nw, dither, content, S, bs = PASS_A_CASES[case]
    x = _content(rng, content, S, C)
    want, got, nvalid = _pass_a(x, bs, bits=bits, maxo=maxo,
                                names=_names(nw), dither=dither)
    if maxo:
        assert want["acorr"].shape[2] == nw
    check_pass_a(want, got, nvalid, bits, C)


def _plan_and_pass_b(want, nvalid, *, bits, C, maxo, blocksize):
    plan = JX._plan_predictors(want, nvalid, bits=bits, channels=C, maxo=maxo,
                               nmax=blocksize)
    _mode, sel, _kind, order, shift, coeffs, _prec = plan
    npart = PX._npart(blocksize)
    return _pass_b(want["cands"], nvalid, sel, order, coeffs, shift, C=C,
                   blocksize=blocksize, npart=npart, maxo=max(maxo, 4))


def _pass_b(cands, nvalid, sel, order, coeffs, shift, *, C, blocksize, npart,
            maxo):
    kw = dict(channels=C, nmax=blocksize, npart=npart, maxo=maxo)
    arrs = (cands, nvalid, sel, order, coeffs, shift)
    j = JX.flac_residual_batch(*(jnp.asarray(a) for a in arrs), **kw)
    p = PX.flac_residual_batch(*(torch.from_numpy(np.array(a)) for a in arrs),
                               **kw)
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: v.numpy() for k, v in p.items()})


@pytest.mark.parametrize("case", ["16-stereo-o8-tone", "16-stereo-o12-6win-noise",
                                  "24-6ch-o8-dither-tone",
                                  "24-stereo-o12-6win-wild"])
def test_pass_b_on_jax_plan_matches_jax(rng, case):
    bits, C, maxo, nw, dither, content, S, bs = PASS_A_CASES[case]
    x = _content(rng, content, S, C)
    want, _got, nvalid = _pass_a(x, bs, bits=bits, maxo=maxo,
                                 names=_names(nw), dither=dither)
    check_pass_b(*_plan_and_pass_b(want, nvalid, bits=bits, C=C, maxo=maxo,
                                   blocksize=bs))


@pytest.mark.parametrize("shift", [0, 15])
def test_pass_b_extreme_predictor(rng, shift):
    """A 24-bit side channel (25 bits), coefficients at ±2^14 and in between,
    32 taps: the dot passes 2^42, and with shift 0 the residual wraps."""
    F, nmax, maxo = 4, 256, 32
    hi = 1 << 24
    cands = rng.integers(-hi, hi, size=(F, 4, nmax)).astype(np.int32)
    cands[:, 2, :64] = hi - 1  # a run at the side channel's extreme
    nvalid = np.array([256, 256, 200, 17], np.int32)
    sel = np.array([[0, 2], [2, 1], [3, 2], [2, 2]], np.int32)
    order = np.array([[32, 32], [32, 1], [32, 16], [5, 32]], np.int32)
    coeffs = rng.integers(-(1 << 14), 1 << 14, size=(F, 2, maxo)).astype(np.int32)
    coeffs[:, :, ::3] = 1 << 14
    coeffs[:, :, 1::3] = -(1 << 14)
    coeffs[0] = 1 << 14  # every tap at the extreme on a constant run
    shifts = np.full((F, 2), shift, np.int32)
    check_pass_b(*_pass_b(cands, nvalid, sel, order, coeffs, shifts, C=2,
                          blocksize=nmax, npart=16, maxo=maxo))


def _jax_pass_a_in_port(monkeypatch):
    """Put JAX's pass A in place of the port's inside the port's encoder."""
    def jax_pass_a(pcm, nvalid, windows=None, **kw):
        out = JX.flac_cost_batch(
            jnp.asarray(pcm.numpy()), jnp.asarray(nvalid.numpy()),
            None if windows is None else jnp.asarray(windows.numpy()), **kw)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    monkeypatch.setattr(PX, "flac_cost_batch", jax_pass_a)


@pytest.mark.parametrize("level", [0, 5, 8])
def test_encode_with_jax_pass_a_is_byte_equal(rng, monkeypatch, level):
    x = flac_music(rng, 20000)
    x[3000:3100] += rng.standard_normal((100, 2)).astype(np.float32) * 0.2
    want = JX.encode_flac(x, 44100, level=level, blocksize=1024)
    _jax_pass_a_in_port(monkeypatch)
    assert PX.encode_flac(x, 44100, level=level, blocksize=1024,
                          device=CPU) == want


def _quantized(x, bits):
    hi = (1 << (bits - 1)) - 1
    scale = float(1 << (bits - 1))
    q = np.clip(np.round(x.astype(np.float32) * np.float32(scale)), -scale, hi)
    return np.nan_to_num(q, nan=0.0).astype(np.int64)


#: id → (content, channels, bits, blocksize, encode_flac keywords)
OWN_CASES = {
    "level0-music": ("tone", 2, 16, 1024, dict(level=0)),
    "level1-6ch": ("tone", 6, 16, 512, dict(level=1)),
    "level2-24bit-noise": ("noise", 1, 24, 1152, dict(level=2)),
    "lpc0-8bit-wild": ("wild", 2, 8, 256, dict(lpc_order=0)),
}


@pytest.mark.parametrize("case", OWN_CASES)
def test_encode_fixed_levels_byte_equal_to_jax(rng, case):
    content, C, bits, bs, kw = OWN_CASES[case]
    x = _content(rng, content, 7000, C)
    want = JX.encode_flac(x, 44100, bits=bits, blocksize=bs, **kw)
    assert PX.encode_flac(x, 44100, bits=bits, blocksize=bs, device=CPU,
                          **kw) == want


def _decoded_both(blob, bits):
    """The stream through the port's decoder and JAX's: integers [S, C]."""
    f = P.decode_assets([Asset("x.flac", "x", "flac", blob)], device=CPU).file(0)
    assert f.err == 0 and f.bits_per_sample == bits
    mine = np.round(f.pcm.astype(np.float64) * 2.0 ** (bits - 1)).astype(np.int64)
    theirs, err = _device_decode([blob])[0]
    assert err == 0
    np.testing.assert_array_equal(mine, theirs)
    return mine


@pytest.mark.parametrize("level,bits,C", [(5, 16, 2), (8, 16, 2), (5, 24, 1)])
def test_encode_lpc_levels_decode_exact(rng, level, bits, C):
    x = flac_music(rng, 12000, C)
    if bits == 24:
        x = x + (rng.standard_normal(x.shape) * 2.0 ** -20).astype(np.float32)
    want = JX.encode_flac(x, 44100, bits=bits, level=level, blocksize=1152)
    got = PX.encode_flac(x, 44100, bits=bits, level=level, blocksize=1152,
                         device=CPU)
    q = _quantized(x, bits)
    np.testing.assert_array_equal(_decoded_both(got, bits), q)
    assert PF.verify_md5(PF.analyze(got), q) is True
    assert JF.verify_md5(JF.analyze(got), q) is True
    assert PF.analyze(got).md5 == JF.analyze(want).md5
    assert abs(len(got) - len(want)) <= 0.005 * len(want)


def test_dithered_encode_decodes_to_jax_integers(rng):
    """The dithered stream holds JAX's dithered integers (its pass A's)."""
    x = flac_music(rng, 6000) * np.float32(0.7)
    blob = PX.encode_flac(x, 48000, dither=7, blocksize=512, device=CPU)
    xb, nvalid = flac_blocked(x, 512)
    ints = JX.flac_cost_batch(jnp.asarray(xb), jnp.asarray(nvalid), bits=16,
                              channels=2, nmax=512, maxo=0, dither=7)["ints"]
    want = np.transpose(np.asarray(ints), (0, 2, 1)).reshape(-1, 2)[:6000]
    assert not np.array_equal(want, _quantized(x, 16))
    np.testing.assert_array_equal(_decoded_both(blob, 16), want)


#: every host function the port copies verbatim
COPIED = ["_tukey", "window_bank", "_levinson", "_quantize_lpc",
          "_plan_predictors", "_Tokens", "_pack_tokens", "_utf8_tokens",
          "_residual_tokens", "_subframe_tokens"]


@pytest.mark.parametrize("name", COPIED)
def test_host_copies_are_verbatim(name):
    assert inspect.getsource(getattr(PX, name)) == \
        inspect.getsource(getattr(JX, name))


def test_constants_and_emitter_are_copies():
    for name in ("_ORDERS", "_KMAX", "_LPC_PREC", "MAX_LPC_ORDER", "LEVELS",
                 "_BS_CODE", "_RATE_CODE", "_BPS_CODE"):
        assert getattr(PX, name) == getattr(JX, name), name
    for name in ("_MODE_A", "_MODE_B", "_MODE_CODE"):
        np.testing.assert_array_equal(getattr(PX, name), getattr(JX, name))
    # the frame and STREAMINFO emitter: JAX's lines in order, apart from
    # where ``ints`` comes from
    src = inspect.getsource(PX._emit)
    jsrc = inspect.getsource(JX.encode_flac)
    block = jsrc[jsrc.index("    frames = []"):].splitlines()
    at = 0
    for line in block:
        if "out[\"ints\"]" in line:
            continue
        at = src.index(line + "\n", at)
    assert PX.__all__ == ["encode_flac"]


def test_encode_validation():
    pcm = np.zeros((100, 2), np.float32)
    bad = [dict(pcm=pcm, sample_rate=44100, bits=13),
           dict(pcm=pcm, sample_rate=44100, blocksize=8),
           dict(pcm=pcm, sample_rate=0),
           dict(pcm=np.zeros((100, 9), np.float32), sample_rate=44100),
           dict(pcm=np.zeros((0, 2), np.float32), sample_rate=44100),
           dict(pcm=pcm, sample_rate=44100, lpc_order=40),
           dict(pcm=pcm, sample_rate=44100, level=9)]
    for kw in bad:
        with pytest.raises(ValueError) as mine:
            PX.encode_flac(device=CPU, **kw)
        with pytest.raises(ValueError) as theirs:
            JX.encode_flac(**kw)
        assert str(mine.value) == str(theirs.value)


def test_encode_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PX.encode_flac(np.zeros((64, 2), np.float32), 44100)


def test_profile_to_writes_a_trace_and_tracer_is_a_tracer(tmp_path):
    assert isinstance(trace.TRACE, trace.Tracer)
    with trace.profile_to(str(tmp_path)):
        PX.encode_flac(np.zeros((300, 2), np.float32), 44100, blocksize=256,
                       device=CPU)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    text = (tmp_path / files[0]).read_text()
    assert len(text) > 0 and "flac.encode.pass_a" in text

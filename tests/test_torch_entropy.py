"""PyTorch port, MP3 entropy scan: the plain torch scan (the CUDA kernel's
twin) against the JAX package's XLA scan, ``decode_spectra(impl="xla")``.

Lines and fail flags must match exactly on LAME streams, a bit-corrupted
stream, reserved-table and invalid lanes, an LSF stream, a count1 cap that
is not a multiple of 32, and a multi-bucket ``_plan_buckets`` plan.  The
JAX scan is jitted once per (n_big, n_c1) and every case shares one lane
shape (N0 lanes, M0 main bytes), so this module compiles it twice.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_decoder_tpu.codecs.mpeg import frontend as FE
from audio_decoder_tpu.codecs.mpeg import huffman_device as JHD
from audio_decoder_tpu_torch.codecs.mpeg import decoder as PD
from audio_decoder_tpu_torch.codecs.mpeg import dsp as PDSP
from audio_decoder_tpu_torch.codecs.mpeg import huffman_device as PHD
from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel as PHK

from . import codec_refs as CR

pytestmark = pytest.mark.skipif(
    not CR.have_lame(), reason="system lame not available"
)

N0 = 96
M0 = 32768
_jax_scan = jax.jit(JHD.decode_spectra, static_argnames=("n_big", "n_c1", "impl"))


def _sig(kind: str, n: int, ch: int, sr: int = 44100) -> np.ndarray:
    rng = np.random.default_rng(41)
    t = np.arange(n) / sr
    if kind == "noise":
        s = 0.5 * rng.standard_normal(n)
    elif kind == "transient":
        s = np.zeros(n)
        s[:: sr // 37] = 0.9
        s += 0.05 * rng.standard_normal(n)
    else:
        s = 0.6 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(
            2 * np.pi * 1320.0 * t)
    s = np.stack([s, np.roll(s, 31) * 0.8], 1) if ch == 2 else s[:, None]
    return np.clip(s * 30000, -32768, 32767).astype(np.int16)


def _lane_arrays(ln, tsel=None) -> list[np.ndarray]:
    """decode_spectra's 13 arguments as int32/uint8 numpy arrays, padded to
    N0 lanes (padding lanes are invalid)."""
    N = ln.n_granules * ln.channels
    assert N <= N0 and ln.main_data.size <= M0
    short = (ln.blockcfg & 3) == 2
    cfg = np.where(short, np.where((ln.blockcfg >> 2) == 1, 2, 1), 0)

    def lane(a, width=None):
        a = np.asarray(a).reshape((N, width) if width else (N,))
        out = np.zeros((N0,) + a.shape[1:], np.int32)
        out[:N] = a
        return out

    main = np.zeros((1, M0), np.uint8)
    main[0, : ln.main_data.size] = ln.main_data
    return [
        main,
        np.zeros(N0, np.int32),
        lane(ln.start_bit), lane(ln.end_bit), lane(ln.limit_bit),
        lane(ln.big_values), lane(ln.region1), lane(ln.region2),
        lane(ln.tsel if tsel is None else tsel, width=3),
        lane(ln.c1sel), lane(ln.valid),
        np.full(N0, ln.rate_idx, np.int32),
        lane(cfg),
    ]


def _both(arrays, n_big=512, n_c1=144):
    lx, fx = _jax_scan(*[jnp.asarray(a) for a in arrays], n_big=n_big,
                       n_c1=n_c1, impl="xla")
    lp, fp = PHD.decode_spectra(*[torch.as_tensor(a) for a in arrays],
                                n_big=n_big, n_c1=n_c1)
    return (np.asarray(lx), np.asarray(fx)), (lp.numpy(), fp.numpy())


def _assert_same(arrays, **kw):
    (lx, fx), (lp, fp) = _both(arrays, **kw)
    np.testing.assert_array_equal(fx, fp)
    np.testing.assert_array_equal(lx, lp)
    return lx, fx


@pytest.mark.parametrize(
    "kind,ch,mode,bitrate,sr",
    [("tone", 2, 1, 128, 44100), ("noise", 2, 0, 320, 44100),
     ("transient", 1, 3, 64, 44100), ("noise", 1, 3, 48, 22050)],
)
def test_plain_scan_matches_xla(kind, ch, mode, bitrate, sr):
    n = 11025 if sr == 44100 else 6000
    blob = CR.lame_encode(_sig(kind, n, ch, sr), sr, bitrate, mode=mode)
    ln = FE.analyze_lanes(blob)
    lx, fx = _assert_same(_lane_arrays(ln))
    live = np.asarray(ln.valid).reshape(-1) > 0
    assert fx[: live.size][live].sum() == 0  # clean stream: no live failure
    assert np.abs(lx).sum() > 0


def test_plain_scan_matches_xla_on_corrupt_stream():
    """Bit flips in main_data: bad codes and part2_3 overruns must fail the
    same lanes in both scans."""
    blob = CR.lame_encode(_sig("noise", 11025, 2), 44100, 128, mode=1)
    ln = FE.analyze_lanes(blob)
    rng = np.random.default_rng(5)
    md = np.array(ln.main_data, copy=True)
    flips = rng.integers(0, md.size, size=md.size // 2)
    md[flips] ^= (1 << rng.integers(0, 8, size=flips.size)).astype(np.uint8)
    _lx, fx = _assert_same(_lane_arrays(dataclasses.replace(ln, main_data=md)))
    live = np.asarray(ln.valid).reshape(-1) > 0
    assert fx[: live.size][live].any()  # the corruption failed some lanes


def test_plain_scan_matches_xla_reserved_and_invalid_lanes():
    blob = CR.lame_encode(_sig("tone", 8820, 2), 44100, 96, mode=1)
    ln = FE.analyze_lanes(blob)
    tsel = np.array(ln.tsel, copy=True).reshape(-1, 3)
    live = np.flatnonzero(ln.valid.reshape(-1) > 0)
    tsel[live[0], 0] = 4   # reserved table select → lane fail
    tsel[live[1], 1] = 14  # reserved in region 1
    lnr = dataclasses.replace(ln, valid=np.array(ln.valid, copy=True))
    lnr.valid.reshape(-1)[live[-1:]] = 0  # one invalid lane
    _lx, fx = _assert_same(_lane_arrays(lnr, tsel=tsel.reshape(ln.tsel.shape)))
    assert fx[live[0]] and fx[live[-1]]


def test_plain_scan_matches_xla_small_caps():
    """n_big below the lane maxima and an n_c1 that is not a multiple of
    32: both scans clamp and round the same way."""
    blob = CR.lame_encode(_sig("noise", 8820, 2), 44100, 192, mode=1)
    ln = FE.analyze_lanes(blob)
    arrays = _lane_arrays(ln)
    assert arrays[5].max() > 64  # some lane has more than 64 pairs
    _assert_same(arrays, n_big=64, n_c1=40)


def _random_lanes(seed: int) -> list[np.ndarray]:
    """Garbage main_data with random side info: start past end, limit
    before end, reserved tables, big_values past 288, invalid lanes."""
    rng = np.random.default_rng(seed)
    main = rng.integers(0, 256, size=(1, M0), dtype=np.uint8)
    main[0, rng.integers(1000, M0):] = 0
    start = rng.integers(0, 8 * 6000, size=N0)
    end = start + rng.integers(-50, 4000, size=N0)
    limit = end + rng.integers(-20, 300, size=N0)
    r1 = rng.integers(0, 577, size=N0)
    arrays = [
        main, np.zeros(N0), start, end, limit,
        rng.integers(0, 512, size=N0), r1,
        np.maximum(r1, rng.integers(0, 577, size=N0)),
        rng.integers(0, 32, size=(N0, 3)), rng.integers(0, 2, size=N0),
        rng.random(N0) < 0.9, np.full(N0, rng.integers(0, 9)),
        rng.integers(0, 3, size=N0),
    ]
    return [arrays[0]] + [np.asarray(a, np.int32) for a in arrays[1:]]


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_scan_matches_xla_on_random_lanes(seed):
    _lx, fx = _assert_same(_random_lanes(seed))
    assert 0 < fx.sum() < N0  # both fail paths and decodes are exercised


def test_multi_bucket_plan_matches_single_xla_scan():
    """The port's bucketed scan (``_plan_buckets`` perm + per-bucket caps +
    scatter back) gives the JAX single scan's lines exactly."""
    blob = CR.lame_encode(_sig("transient", 11025, 2), 44100, 128, mode=1)
    ln = FE.analyze_lanes(blob)
    arrays = _lane_arrays(ln)
    big, valid = arrays[5], arrays[10]
    perm, buckets = PD._plan_buckets(big, valid, 512)
    assert perm is not None and len(buckets) > 1
    lx, fx = _jax_scan(*[jnp.asarray(a) for a in arrays], n_big=512,
                       n_c1=144, impl="xla")
    t = [torch.as_tensor(a) for a in arrays]
    lp, fp = PDSP.decode_buckets(t[0], t[1:], torch.as_tensor(perm), buckets)
    np.testing.assert_array_equal(np.asarray(fx), fp.numpy())
    np.testing.assert_array_equal(np.asarray(lx), lp.numpy())


def test_raw_scan_triple_layout():
    """scan_plain's raw triple: pairs line-ordered, count1 quads unshifted,
    and _assemble of it equals decode_spectra."""
    blob = CR.lame_encode(_sig("tone", 8820, 2), 44100, 128, mode=1)
    ln = FE.analyze_lanes(blob)
    t = [torch.as_tensor(a) for a in _lane_arrays(ln)]
    big576, c1, fail = PHD.scan_plain(*t[:11])
    assert big576.shape == (N0, 576) and c1.shape == (N0, 144, 4)
    assert big576.dtype == c1.dtype == torch.int16 and fail.dtype == torch.bool
    lines, fail2 = PHD._assemble(big576, c1, t[5], fail, t[11], t[12])
    ref_lines, ref_fail = PHD.decode_spectra(*t)
    assert torch.equal(lines, ref_lines) and torch.equal(fail2, ref_fail)


def test_scan_wrapper_counts_no_launch_on_cpu_and_rejects_other_devices():
    before = PHK.launches
    blob = CR.lame_encode(_sig("tone", 4410, 1), 44100, 64, mode=3)
    t = [torch.as_tensor(a) for a in _lane_arrays(FE.analyze_lanes(blob))]
    PHK.entropy_scan(*t[:11])
    assert PHK.launches == before
    meta = [a.to("meta") for a in t[:11]]
    with pytest.raises(ValueError, match="unsupported device"):
        PHK.entropy_scan(*meta)


def test_count1_quads_rounds_like_the_xla_scan():
    assert [PHD.count1_quads(n) for n in (1, 32, 33, 64, 96, 128, 129, 144, 500)] \
        == [32, 32, 64, 64, 96, 128, 144, 144, 144]

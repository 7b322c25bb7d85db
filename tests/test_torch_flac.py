"""PyTorch port, FLAC: each device stage and the whole family against the
JAX package on the CPU.

The same inputs, made from a numpy seed or written by the clear-room
encoder (tests/flac_writer.py), go through the JAX function and its port.
Every integer result must match exactly and every PCM sample must be equal
(FLAC is lossless; the f32 scaling is by a power of two).  The JAX side
runs its XLA scatter path, and once its Pallas window-add in interpret
mode.  Block sizes stay at or below 1152 so the JAX programs compile fast.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audio_decoder_tpu as J
import audio_decoder_tpu_torch as P
from audio_decoder_tpu.codecs.flac import decoder as JD
from audio_decoder_tpu.codecs.flac import device as JV
from audio_decoder_tpu.codecs.flac import frontend as JF
from audio_decoder_tpu.io.assets import Asset as JAsset
from audio_decoder_tpu_torch.codecs.flac import decoder as PD
from audio_decoder_tpu_torch.codecs.flac import device as PV
from audio_decoder_tpu_torch.codecs.flac import frontend as PF
from audio_decoder_tpu_torch.codecs.flac.stream import FlacStream
from audio_decoder_tpu_torch.core import errors as E
from audio_decoder_tpu_torch.io.assets import Asset as PAsset
from audio_decoder_tpu_torch.ops import window_add as PW

from . import flac_writer as FW
from .synth import make_wav
from .test_flac_oracle import STEREO_MODES, SUBFRAME_CASES, _material

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")

_jit_rice = jax.jit(JV._rice_scan, static_argnames=("steps", "narrow"))
_jit_fixed = jax.jit(JV._fixed_width, static_argnames=("imax",))
_jit_predict = jax.jit(JV._predict, static_argnames=("nmax",))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows8(stream: np.ndarray):
    return JV._overlap_rows(JV._be_words(jnp.asarray(stream)[None, :]))


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------


def _lanes(rng, n_bytes, L, pmax, steps, kc):
    """Random rice lanes over a random stream with a zero run (all-zero
    windows read as q = 32 > Q_CAP: overflow)."""
    stream = rng.integers(0, 256, size=n_bytes).astype(np.uint8)
    stream[1000:1040] = 0
    bitpos = rng.integers(0, (n_bytes - 600) * 8, size=L).astype(np.int32)
    bitpos[:2] = 1000 * 8 + np.asarray([0, 37])  # inside the zero run
    count = rng.integers(0, steps * kc + 1, size=L).astype(np.int32)
    count[:2] = steps * kc
    param = rng.integers(0, pmax + 1, size=L).astype(np.int32)
    limit = np.minimum(bitpos.astype(np.int64) + rng.integers(0, 6000, size=L),
                       n_bytes * 8).astype(np.int32)
    limit[:2] = n_bytes * 8
    return stream, bitpos, count, param, limit


@pytest.mark.parametrize("narrow,pmax", [(True, 16), (False, 30)],
                         ids=["narrow", "wide"])
def test_rice_scan_matches_jax(narrow, pmax):
    rng = np.random.default_rng(21 + narrow)
    steps, kc = 4, PV.rice_k(narrow)
    stream, bitpos, count, param, limit = _lanes(rng, 6000, 96, pmax, steps, kc)
    jv, jo = _jit_rice(_rows8(stream), jnp.zeros(96, jnp.int32),
                       jnp.asarray(bitpos), jnp.asarray(count),
                       jnp.asarray(param), jnp.asarray(limit),
                       steps=steps, narrow=narrow)
    pv, po = PV._rice_scan(_t(stream), _t(bitpos), _t(count), _t(param),
                           _t(limit), steps, narrow)
    assert pv.dtype == torch.int32 and tuple(pv.shape) == (96, steps * kc)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    assert po[:2].all() and not po.all()  # overflow lanes and clean lanes


def test_fixed_width_matches_jax():
    rng = np.random.default_rng(5)
    n_bytes, L, imax = 4000, 80, 16
    stream = rng.integers(0, 256, size=n_bytes).astype(np.uint8)
    width = rng.integers(0, 32, size=L).astype(np.int32)
    width[:3] = (0, 1, 31)
    bitpos = rng.integers(0, (n_bytes - 100) * 8, size=L).astype(np.int32)
    # some cursors run into their limit and clamp there
    limit = (bitpos.astype(np.int64) + rng.integers(0, 600, size=L)
             ).astype(np.int32)
    jv = _jit_fixed(_rows8(stream), jnp.zeros(L, jnp.int32),
                    jnp.asarray(bitpos), jnp.asarray(width),
                    jnp.asarray(limit), imax=imax)
    pv = PV._fixed_width(_t(stream), _t(bitpos), _t(width), _t(limit), imax)
    assert pv.dtype == torch.int32
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert (pv[0] == 0).all()


def test_exact_mac_extreme_sums():
    """46-bit sums at the contract's edges (|coef| <= 2^14, |hist| < 2^26,
    32 taps) and random ones, every shift: the port's int64 MAC wrapped to
    int32 equals the JAX i32+f32 residue reconstruction."""
    rng = np.random.default_rng(9)
    hmax, cmax = (1 << 26) - 1, 1 << 14
    rows = [np.full(32, hmax), np.full(32, -hmax), np.full(32, hmax)]
    coefs = [np.full(32, cmax - 1), np.full(32, cmax - 1), np.full(32, -cmax)]
    for _ in range(200):
        rows.append(rng.integers(-hmax, hmax + 1, size=32))
        coefs.append(rng.integers(-cmax, cmax, size=32))
    hist = np.repeat(np.stack(rows), 16, axis=0).astype(np.int32)
    coef = np.repeat(np.stack(coefs), 16, axis=0).astype(np.int32)
    shift = np.tile(np.arange(16), len(rows)).astype(np.int32)
    acc = (hist.astype(np.int64) * coef).sum(1)
    assert np.abs(acc).max() >= 1 << 44  # really 46-bit sums
    # the contract: the shifted result fits int32 (shift 0 wraps on both)
    ok = (shift == 0) | (np.abs(acc >> shift) < 1 << 31)
    hist, coef, shift = hist[ok], coef[ok], shift[ok]
    want = np.asarray(JV._exact_mac(jnp.asarray(hist), jnp.asarray(coef),
                                    jnp.asarray(coef, jnp.float32),
                                    jnp.asarray(shift)))
    got = PV._exact_mac(_t(hist), _t(coef), _t(shift))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _predict_case(rng, Ls, nmax):
    """Subframes whose residuals come from known samples: orders 0-32,
    FIXED-like integer predictors and LPC with shifts, CONSTANT rows,
    wasted bits."""
    order = rng.integers(0, 33, size=Ls).astype(np.int32)
    order[:3] = (32, 1, 0)
    kind = np.where(rng.random(Ls) < 0.1, 1, 0).astype(np.int32)
    kind[:3] = 0
    shift = rng.integers(0, 16, size=Ls).astype(np.int32)
    wasted = np.where(rng.random(Ls) < 0.2, rng.integers(1, 4, size=Ls), 0
                      ).astype(np.int32)
    coeffs = np.zeros((Ls, 32), np.int64)
    for r in range(Ls):
        o = int(order[r])
        if o:  # |prediction| <= max |sample|: residuals stay in int32
            c = min((1 << int(shift[r])) // o, (1 << 14) - 1)
            coeffs[r, :o] = rng.integers(-c, c + 1, size=o)
    s = rng.integers(-(1 << 23), 1 << 23, size=(Ls, nmax)).astype(np.int64)
    vals = s.copy()
    for r in range(Ls):
        o = int(order[r])
        for i in range(o, nmax):
            pred = int((coeffs[r, :o] * s[r, i - 1::-1][:o]).sum()) >> int(shift[r])
            vals[r, i] = s[r, i] - pred
    assert np.abs(vals).max() < 1 << 31
    return (vals.astype(np.int32), kind, order, shift, wasted,
            coeffs.astype(np.int32), s)


def test_predict_matches_jax_up_to_order_32():
    rng = np.random.default_rng(17)
    Ls, nmax = 40, 96
    vals, kind, order, shift, wasted, coeffs, s = _predict_case(rng, Ls, nmax)
    args = (vals, kind, order, shift, wasted, coeffs)
    want = np.asarray(_jit_predict(*map(jnp.asarray, args), nmax=nmax))
    got = PV._predict(*map(_t, args), nmax)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the samples the residuals came from come back
    lpc = kind == 0
    np.testing.assert_array_equal(got.numpy()[lpc],
                                  (s << wasted[:, None])[lpc].astype(np.int32))


def test_stereo_all_modes_matches_jax():
    rng = np.random.default_rng(4)
    F, N = 16, 64
    sub = rng.integers(-(1 << 20), 1 << 20, size=(F, 2, N)).astype(np.int32)
    mode = np.asarray([0, 8, 9, 10] * (F // 4), np.int32)
    want = np.asarray(JV._stereo(jnp.asarray(sub), jnp.asarray(mode), 2))
    got = PV._stereo(_t(sub), _t(mode), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    mono = sub[:, :1]
    np.testing.assert_array_equal(PV._stereo(_t(mono), _t(mode), 1).numpy(), mono)


# ---------------------------------------------------------------------------
# The device program on encoded streams
# ---------------------------------------------------------------------------


def _wire_both(blobs, window_impl="xla"):
    """Pack the same blobs with both packers and run both wire programs."""
    j_an = [JF.analyze(b) for b in blobs]
    p_an = [PF.analyze(b) for b in blobs]
    (jb, jd), js = JD.pack_wire(j_an)
    (pb, pd), ps = PD.pack_wire(p_an, "cpu")
    assert ps == js
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    jpcm, jovf = JV.flac_decode_wire(jb, jd, window_impl=window_impl, **js)
    ppcm, povf = PV.flac_decode_wire(pb, pd, **ps)
    return (np.asarray(jpcm), np.asarray(jovf)), (ppcm.numpy(), povf.numpy()), ps


def _assert_wire_equal(blobs, xs, window_impl="xla"):
    (jpcm, jovf), (ppcm, povf), st = _wire_both(blobs, window_impl)
    assert ppcm.dtype == np.float32 and ppcm.shape == jpcm.shape
    np.testing.assert_array_equal(ppcm, jpcm)
    np.testing.assert_array_equal(povf, jovf)
    assert not povf.any()
    ch = st["channels"]
    for i, x in enumerate(xs):
        bits = PF.parse_streaminfo(blobs[i])["bits"]
        rows = ppcm[i].reshape(-1, ch)[: x.shape[0], : x.shape[1]]
        ints = np.round(rows.astype(np.float64) * 2.0 ** (bits - 1))
        np.testing.assert_array_equal(ints.astype(np.int64), x)


def test_wire_subframe_matrix(rng):
    """All 13 subframe layouts, stereo modes cycling, in one call."""
    blobs, xs = [], []
    for i, (_name, kw) in enumerate(SUBFRAME_CASES):
        x = _material(rng, kw=kw)
        blobs.append(FW.encode_file(x, 44100, 16, blocksize=256,
                                    stereo=STEREO_MODES[i % 4],
                                    subframe_kw=kw))
        xs.append(x)
    _assert_wire_equal(blobs, xs)


def test_wire_stereo_modes(rng):
    blobs, xs = [], []
    for mode in STEREO_MODES:
        x = _material(rng, frames=1100)
        blobs.append(FW.encode_file(x, 48000, 16, blocksize=512, stereo=mode))
        xs.append(x)
    _assert_wire_equal(blobs, xs)


@pytest.mark.parametrize("bps", [8, 12, 16, 20, 24])
def test_wire_sample_sizes(rng, bps):
    x = _material(rng, frames=1500, ch=1, hi=1 << (bps - 1))
    _assert_wire_equal([FW.encode_file(x, 48000, bps, blocksize=576)], [x])


def test_wire_partial_tail_frame_odd_rate(rng):
    x = _material(rng, frames=1000)
    blob = FW.encode_file(x, 12345, 16, blocksize=576, stereo="mid_side")
    _assert_wire_equal([blob], [x])


def test_wire_direct_value_outliers(rng):
    """A badly fitted LPC: rice quotients past Q_CAP leave the scan and
    come back as host-decoded direct values."""
    x = _material(rng, frames=2500, hi=1 << 23)
    kw = dict(kind="lpc", lpc_coefs=[1200, -600, 300, -100], lpc_shift=10)
    blob = FW.encode_file(x, 44100, 24, blocksize=1024, stereo="mid_side",
                          subframe_kw=kw)
    assert PF.analyze(blob).dv_val.size > 0
    _assert_wire_equal([blob], [x])


def test_wire_lpc_order_32_matches_jax_pallas(rng):
    """LPC order 32, mixed layouts over three files; here the JAX side
    assembles with its Pallas window-add kernels (interpret mode)."""
    coefs = [512] + [0] * 30 + [256]
    kinds = [kw for _, kw in SUBFRAME_CASES] + [
        dict(kind="lpc", lpc_coefs=coefs, lpc_shift=11)]
    blobs, xs = [], []
    for i in range(3):
        x = rng.integers(-9000, 9000, size=(900 + 257 * i, 2)).astype(np.int32)
        blobs.append(FW.encode_file(x, 44100, 16, blocksize=448,
                                    stereo=STEREO_MODES[i], subframe_kw=kinds))
        xs.append(x)
    _assert_wire_equal(blobs, xs, window_impl="pallas")


def test_wire_entry_matches_per_array_entry(rng):
    """pack_group + flac_decode_batch (one tensor per field) equals
    pack_wire + flac_decode_wire (one descriptor tensor)."""
    blobs = []
    for i, bps in enumerate((16, 16, 24)):
        x = _material(rng, frames=700 + 64 * i, hi=1 << (bps - 1))
        blobs.append(FW.encode_file(x, 44100, bps, blocksize=256,
                                    stereo=STEREO_MODES[i]))
    an = [PF.analyze(b) for b in blobs]
    args, st = PD.pack_group(an, "cpu")
    pcm_a, ovf_a = PV.flac_decode_batch(*args, **st)
    (pb, pd), st_w = PD.pack_wire(an, "cpu")
    pcm_w, ovf_w = PV.flac_decode_wire(pb, pd, **st_w)
    assert torch.equal(pcm_a, pcm_w) and torch.equal(ovf_a, ovf_w)


def test_decode_batch_windows_stage(rng):
    """``stage="windows"`` hands out the two window-add calls' inputs; the
    wrappers on them rebuild the full decode's PCM."""
    x = _material(rng, frames=700)
    blob = FW.encode_file(x, 44100, 16, blocksize=256, stereo="left_side")
    (pb, pd), st = PD.pack_wire([PF.analyze(blob)], "cpu")
    w = PV.flac_decode_wire(pb, pd, stage="windows", **st)
    sa, ua, sb, ub, n_vals = w["window_add2"]
    starts, upd, n_pcm = w["window_add"]
    assert ua.dtype == torch.int32 and upd.dtype == torch.float32
    assert n_vals >= ua.shape[1] and n_pcm >= upd.shape[1]
    pcm, _ = PV.flac_decode_wire(pb, pd, **st)
    out = PW.window_add(starts, upd, n_pcm)
    np.testing.assert_array_equal(out[: pcm.numel()].numpy(),
                                  pcm.reshape(-1).numpy())


# ---------------------------------------------------------------------------
# decode_group, its routes, and the entry points
# ---------------------------------------------------------------------------


def _groups_equal(blobs):
    """decode_group on both sides: pieces, codes and PCM equal."""
    jp = JD.decode_group([JAsset(f"f{i}", f"f{i}", "flac", b)
                          for i, b in enumerate(blobs)])
    pp = PD.decode_group([PAsset(f"f{i}", f"f{i}", "flac", b)
                          for i, b in enumerate(blobs)], device="cpu")
    assert [i for i, _ in pp] == [i for i, _ in jp]
    for (_, jb), (_, pb) in zip(jp, pp):
        assert pb.channels == jb.channels and pb.names == jb.names
        for k in ("sample_rate", "num_channels", "bits_per_sample",
                  "valid_frames", "err"):
            np.testing.assert_array_equal(getattr(pb, k).numpy(),
                                          np.asarray(getattr(jb, k)), err_msg=k)
        np.testing.assert_array_equal(pb.data.numpy(), np.asarray(jb.data))
    return pp


def test_decode_group_error_pieces(rng):
    x = _material(rng, frames=512, ch=1)
    good = FW.encode_file(x, 44100, 16, blocksize=256)
    crc = bytearray(good)
    crc[-3] ^= 0x01  # last frame body: CRC-16 mismatch
    noise = b"fLaC" + rng.integers(0, 256, size=600, dtype=np.uint8).tobytes()
    pieces = _groups_equal([bytes(crc), good, b"not flac at all", noise,
                            good[: len(good) // 2]])
    err = {i: int(b.err[k]) for idxs, b in pieces for k, i in enumerate(idxs)}
    assert err[1] == 0 and err[0] == E.ERR_INVALID and err[2] == E.ERR_INVALID
    assert err[3] != 0 and err[4] != 0


def test_decode_group_32_bit_host_route(rng):
    x = _material(rng, frames=300, ch=1, hi=1 << 30).astype(np.int64)
    y = _material(rng, frames=400, ch=2)
    pieces = _groups_equal([FW.encode_file(x, 44100, 32, blocksize=256),
                            FW.encode_file(y, 44100, 16, blocksize=256)])
    assert [idxs for idxs, _ in pieces] == [[0], [1]]


def test_decode_group_chunked_route(rng, monkeypatch):
    """Files past BIT_CAP decode frame-chunked (cap shrunk on both sides),
    equal to JAX and to the one-shot decode."""
    x = _material(rng, frames=6000)
    blob = FW.encode_file(x, 44100, 16, blocksize=512, stereo="right_side")
    (_, one), = PD.decode_group([PAsset("f", "f", "flac", blob)], device="cpu")
    monkeypatch.setattr(JF, "BIT_CAP", 4096)
    monkeypatch.setattr(PF, "BIT_CAP", 4096)
    (_, chunked), = _groups_equal([blob])
    assert int(chunked.err[0]) == 0 and int(chunked.valid_frames[0]) == 6000
    np.testing.assert_array_equal(chunked.data.numpy()[0, : 12000],
                                  one.data.numpy()[0, : 12000])


def test_decode_group_pipelined_chunks(rng, monkeypatch):
    """A tiny chunk budget splits the group into several device calls,
    with a walk failure inside a pre-copied chunk (the repack path)."""
    monkeypatch.setattr(JD, "CHUNK_BYTES", 1 << 13)
    monkeypatch.setattr(PD, "CHUNK_BYTES", 1 << 13)
    blobs = []
    for i in range(4):
        x = _material(rng, frames=500 + 32 * i)
        blobs.append(FW.encode_file(x, 44100, 16, blocksize=256,
                                    stereo=STEREO_MODES[i]))
    bad = bytearray(blobs[1])
    bad[-3] ^= 0x01
    blobs[1] = bytes(bad)
    pieces = _groups_equal(blobs)
    assert len(pieces) >= 3


def test_flac_stream_matches_oneshot(rng):
    kinds = [kw for _, kw in SUBFRAME_CASES]
    x = _material(rng, frames=3000)
    blob = FW.encode_file(x, 44100, 16, blocksize=512, stereo="left_side",
                          subframe_kw=kinds)
    st = FlacStream(blob, frames_per_chunk=2, device="cpu")
    assert (st.total_samples, st.channels) == (3000, 2)
    got = np.concatenate(list(st.chunks()), axis=0)
    np.testing.assert_array_equal(
        np.round(got.astype(np.float64) * 32768.0).astype(np.int64), x)
    seek = np.concatenate(list(st.chunks(start_sample=1234)), axis=0)
    np.testing.assert_array_equal(seek, got[1234:])


@pytest.mark.parametrize("name", ["music_44k1_s16.flac", "mono_48k_s24.flac"])
def test_fixture_decodes_like_jax_and_passes_md5(name):
    """The committed fixtures the chip smoke run decodes: the port's CPU
    path equals JAX, and its integers match the STREAMINFO MD5."""
    blob = open(os.path.join(DATA, name), "rb").read()
    (_, b), = _groups_equal([blob])
    an = PF.analyze(blob)
    if name.startswith("mono"):
        assert not PD.sizing_for([an])["rice_narrow"]
    f = b.file(0)
    ints = np.round(f.pcm.astype(np.float64) * 2.0 ** (an.bits - 1)).astype(np.int64)
    assert PF.verify_md5(an, ints) is True


def test_decode_dir_mixed_wav_mp3_flac(tmp_path):
    """decode_dir on a small WAV + MP3 + FLAC folder: names, metadata,
    codes, WAV and FLAC PCM exactly as JAX, MP3 PCM within the repo's
    amplitude-scaled RMS bar."""
    rng = np.random.default_rng(0xF1AC)
    x16 = _material(rng, frames=2000)
    x24 = _material(rng, frames=900, ch=1, hi=1 << 23)
    files = {
        "a.flac": FW.encode_file(x16, 44100, 16, blocksize=512,
                                 stereo="mid_side"),
        "b.flac": FW.encode_file(x24, 48000, 24, blocksize=256),
        "c.wav": make_wav(rng.integers(-32768, 32768, size=(1500, 2)), 44100,
                          bits=16),
        "d.flac": b"fLaC" + bytes(100),
        "e.xyz": b"not audio",
    }
    for n, blob in files.items():
        (tmp_path / n).write_bytes(blob)
    shutil.copyfile(os.path.join(DATA, "mono_22k05_lsf.mp3"),
                    tmp_path / "m.mp3")
    before = dict(PW.launches)
    jb, jn = J.decode_dir(str(tmp_path))
    pb, pn = P.decode_dir(str(tmp_path), device="cpu")
    assert PW.launches == before  # CPU: plain twins only
    assert pn == jn and pb.names == jb.names and pb.formats == jb.formats
    assert tuple(pb.data.shape) == tuple(jb.data.shape)
    for k in ("sample_rate", "num_channels", "bits_per_sample",
              "valid_frames", "err"):
        np.testing.assert_array_equal(getattr(pb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    for i, fmt in enumerate(pb.formats):
        a, b = jb.file(i), pb.file(i)
        if fmt == "mp3":
            rms = float(np.sqrt(((a.pcm - b.pcm) ** 2).mean()))
            assert rms < 5e-7 * max(1.0, float(np.sqrt((a.pcm ** 2).mean())) / 0.2)
        else:
            np.testing.assert_array_equal(b.pcm, a.pcm, err_msg=pb.names[i])
    err = dict(zip(pb.names, pb.err.tolist()))
    assert err["a"] == err["b"] == err["c"] == err["m"] == 0
    assert err["d"] != 0 and err["e"] == E.ERR_UNSUPPORTED
    got = pb.file(pn["a"]).pcm
    np.testing.assert_array_equal(
        np.round(got.astype(np.float64) * 32768.0).astype(np.int64), x16)


def test_analyze_batch_always_walks_natively(rng):
    """The port's walk is flacfe's (no Python fallback); the Python walk
    stays callable as the oracle and agrees field by field."""
    x = _material(rng, frames=800)
    blob = FW.encode_file(x, 44100, 16, blocksize=256, stereo="mid_side")
    before = PF._native.walks()
    nat, = PF.analyze_batch([blob])
    assert PF._native.walks() == before + 1
    py = PF._analyze_py(blob)
    for f in dataclasses.fields(nat):
        a, b = getattr(nat, f.name), getattr(py, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name

"""PyTorch port, the multi-device layer (``parallel/``: mesh, sharded
decode, voice-sharded render, dry run; K5 ``window_add_spmd``) against
the JAX package on the CPU.

JAX runs its mesh on 8 virtual CPU devices (data 4 x model 2; conftest),
the port on ``make_mesh(8, 2, devices=["cpu"] * 8)``: eight logical shards
on the CPU.  The same numpy-seeded bytes go through both.  Tolerances:

* integers (WAV PCM as f32 of int16, error codes, frame counts, consensus),
  FLAC PCM and its overflow flags, and K5: equal;
* MP3: amplitude-scaled RMS 5e-7 against JAX (float32 sums in another
  order); against the port's own single-device decode: equal (a shard's
  rows go through the same per-row arithmetic at the same fixed shapes);
* Layer II: max abs 1e-6 against JAX (JAX's own bar for its sharded
  synthesis); equal against the port's single-device synthesis;
* render blocks: max abs 2e-6 (the voices are summed in shards, in another
  order); positions, active flags and the clock: equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_decoder_tpu.codecs.flac import decoder as JFD
from audio_decoder_tpu.codecs.flac import frontend as JFF
from audio_decoder_tpu.codecs.flac.encode import encode_flac
from audio_decoder_tpu.codecs.mpeg import decoder as JMD
from audio_decoder_tpu.codecs.mpeg import frontend as JFE
from audio_decoder_tpu.codecs.mpeg import layer12 as JL12
from audio_decoder_tpu.engine import commands as JC
from audio_decoder_tpu.engine import state as JS
from audio_decoder_tpu.io.assets import pack_bytes
from audio_decoder_tpu.ops import window_add as JW
from audio_decoder_tpu.parallel import decode as JPD
from audio_decoder_tpu.parallel import mesh as JM
from audio_decoder_tpu.parallel import render as JPR
from audio_decoder_tpu_torch import parallel as P
from audio_decoder_tpu_torch.codecs.flac import decoder as FD
from audio_decoder_tpu_torch.codecs.flac import device as FV
from audio_decoder_tpu_torch.codecs.flac import frontend as FF
from audio_decoder_tpu_torch.codecs.mpeg import decoder as MD
from audio_decoder_tpu_torch.codecs.mpeg import dsp as MDSP
from audio_decoder_tpu_torch.codecs.mpeg import layer12 as L12
from audio_decoder_tpu_torch.engine import commands as PC
from audio_decoder_tpu_torch.engine import render as PR
from audio_decoder_tpu_torch.engine import state as PS
from audio_decoder_tpu_torch.ops import window_add as PW
from audio_decoder_tpu_torch.parallel import mesh as M
from audio_decoder_tpu_torch.parallel import render as PPR
from audio_decoder_tpu_torch.parallel.dryrun import scaled_rms

from . import flac_writer, seeded_writers
from .synth import make_wav
from .test_torch_cuda import window_case

CPU = "cpu"
MP3_FIXTURE = "tests/data/torch_port/stereo_44k1_128k_js.mp3"
RENDER_ATOL = 2e-6


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return JM.make_mesh(8, model_parallel=2)


@pytest.fixture(scope="module")
def pmesh():
    return P.make_mesh(8, 2, devices=[CPU] * 8)


# ---------------------------------------------------------------- the mesh


def test_make_mesh_grid_and_axes(pmesh):
    assert pmesh.shape == {"data": 4, "model": 2}
    assert pmesh.axis_names == ("data", "model")
    assert len(pmesh.devices) == 8
    assert pmesh.axis_devices("data") == [torch.device(CPU)] * 4
    assert pmesh.axis_devices("model") == [torch.device(CPU)] * 2
    with pytest.raises(ValueError):
        pmesh.axis_devices("pipe")


@pytest.mark.parametrize("n,model,devices", [
    (9, 1, [CPU] * 8),         # more than listed
    (6, 4, [CPU] * 8),         # not divisible by model
    (0, 1, [CPU] * 8),         # empty
    (1, 1, None),              # no CUDA device is visible here
    (None, 1, None),           # all visible CUDA devices: none
], ids=["too-many", "indivisible", "empty", "cuda-1", "cuda-all"])
def test_make_mesh_refuses(n, model, devices):
    if devices is None and torch.cuda.is_available():
        n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError):
        P.make_mesh(n, model, devices=devices)


def test_shard_refuses_an_axis_the_data_size_does_not_divide(pmesh):
    with pytest.raises(ValueError, match="does not divide"):
        P.shard(torch.zeros(6), pmesh)
    s = P.shard(torch.arange(8), pmesh)
    assert [t.tolist() for t in s.shards] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert P.shard(s, pmesh) is s
    assert torch.equal(s.gather(), torch.arange(8))


def test_psum_adds_partials_in_shard_order_and_replicates(pmesh):
    parts = [torch.full((3,), float(i)) for i in range(4)]
    before = dict(M.collectives)
    out = P.psum(parts, pmesh)
    assert M.collectives["psum"] == before["psum"] + 1
    assert M.collectives["psum_nccl"] == before["psum_nccl"]
    assert len(out.copies) == 8 and all(c is out.value for c in out.copies)
    assert torch.equal(out.value, torch.full((3,), 6.0))
    assert out.on(CPU) is out.value


def test_collectives_deliver_to_a_device_list(pmesh):
    """``to=`` narrows a psum's, an all-gather's and a replica's devices
    (the FLAC mesh route sends its sums to the ``data`` devices only)."""
    data = pmesh.axis_devices("data")
    out = P.psum([torch.full((2,), float(i)) for i in range(4)], pmesh, data)
    gathered = M.all_gather(P.shard(torch.arange(8), pmesh), pmesh, data)
    rep = P.replicate(torch.arange(3), pmesh, data)
    for r, want in ((out, torch.full((2,), 6.0)), (gathered, torch.arange(8)),
                    (rep, torch.arange(3))):
        assert r.devices == tuple(data) and len(r.copies) == 4
        assert torch.equal(r.value, want)
    assert len(P.psum([torch.ones(1)] * 4, pmesh).copies) == 8


def test_pad_batch_matches_jax():
    rng = np.random.default_rng(2)
    bufs = rng.integers(0, 255, (5, 64)).astype(np.uint8)
    lens = np.full((5,), 64, np.int32)
    for got, want in zip(P.pad_batch(bufs, lens, 4), JPD.pad_batch(bufs, lens, 4)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- K5


K5_CASES = {
    # (seed, L, W, n_live, dtype): live lanes in some shards only
    "int32-values": (21, 64, 96, 50, np.int32),
    "f32-frames": (22, 32, 1024, 21, np.float32),
    "padding-only-shards": (23, 64, 40, 12, np.int32),  # shards 1-3 pad only
}


@pytest.mark.parametrize("case", list(K5_CASES))
def test_window_add_spmd_matches_jax(jmesh, pmesh, case, monkeypatch):
    seed, L, W, n_live, dtype = K5_CASES[case]
    starts, upd, n_out = window_case(np.random.default_rng(seed), L, W,
                                     n_live, dtype=dtype)
    want = np.asarray(JW.window_add_spmd(jnp.asarray(starts), jnp.asarray(upd),
                                         n_out, mesh=jmesh, interpret=True))
    calls = []
    k3 = PW.window_add
    monkeypatch.setattr(PW, "window_add",
                        lambda s, u, n: calls.append(s.shape[0]) or k3(s, u, n))
    before = dict(PW.launches)
    got = PW.window_add_spmd(torch.from_numpy(starts), torch.from_numpy(upd),
                             n_out, mesh=pmesh)
    assert calls == [L // 4] * 4  # K3 once per data shard, on its lanes
    assert PW.launches == before  # the CPU runs the plain twin
    assert isinstance(got, P.Replicated) and len(got.copies) == 8
    assert got.value.dtype == torch.from_numpy(upd).dtype
    np.testing.assert_array_equal(got.value.numpy(), want)
    single = PW.window_add_plain(torch.from_numpy(starts),
                                 torch.from_numpy(upd), n_out)
    assert torch.equal(got.value, single)


# ---------------------------------------------------------------- WAV


def _wav_batch(rng, n_files, frames=512):
    pcm = [np.clip(rng.standard_normal((frames, 2)) * 8000, -32768,
                   32767).astype(np.int16) for _ in range(n_files)]
    rates = [44100] * (n_files - 1) + [48000]  # a minority rate
    return pcm, pack_bytes([make_wav(p, r) for p, r in zip(pcm, rates)])


def _assert_wav_step(jmesh, pmesh, bufs, lens, frames):
    kw = dict(bits=16, channels=2, max_frames=frames, family="wav")
    with jmesh:
        jpcm, jmeta, jrate, jch = JPD.sharded_decode_fn(jmesh, **kw)(
            jnp.asarray(bufs), jnp.asarray(lens))
    pcm, meta, rate, ch = P.sharded_decode_fn(pmesh, **kw)(bufs, lens)
    assert isinstance(pcm, P.Sharded) and len(pcm.shards) == 4
    np.testing.assert_array_equal(pcm.gather().numpy(), np.asarray(jpcm))
    assert sorted(meta) == sorted(jmeta)
    for k in ("err", "n_frames", "sample_rate", "channels"):
        np.testing.assert_array_equal(meta[k].gather().numpy(),
                                      np.asarray(jmeta[k]), err_msg=k)
    assert (int(rate.value), int(ch.value)) == (int(jrate), int(jch))
    assert all(torch.equal(c, rate.value) for c in rate.copies)
    return pcm, meta, rate


def test_sharded_wav_decode_matches_jax(jmesh, pmesh):
    src, (bufs, lens) = _wav_batch(np.random.default_rng(3), 8)
    pcm, meta, rate = _assert_wav_step(jmesh, pmesh, bufs, lens, 512)
    assert int(rate.value) == 44100  # the majority rate
    got = pcm.gather().reshape(8, 512, 2).numpy()
    np.testing.assert_array_equal(np.round(got * 32768).astype(np.int16),
                                  np.stack(src))


def test_uneven_wav_batch_pads_and_masks_like_jax(jmesh, pmesh):
    src, (bufs, lens) = _wav_batch(np.random.default_rng(4), 5)
    bufs, lens, valid = P.pad_batch(bufs, lens, pmesh.shape["data"])
    assert bufs.shape[0] == 8 and valid.sum() == 5
    pcm, meta, rate = _assert_wav_step(jmesh, pmesh, bufs, lens, 512)
    err = meta["err"].gather().numpy()
    assert (err[valid] == 0).all() and (err[~valid] != 0).all()
    assert int(meta["n_frames"].gather()[torch.from_numpy(~valid)].sum()) == 0
    assert int(rate.value) == 44100


def test_sharded_decode_refuses_an_uneven_batch(pmesh):
    _src, (bufs, lens) = _wav_batch(np.random.default_rng(5), 5)
    step = P.sharded_decode_fn(pmesh, bits=16, channels=2, max_frames=512)
    with pytest.raises(ValueError, match="does not divide"):
        step(bufs, lens)


# ---------------------------------------------------------- Layer II, MP3


def test_sharded_layer2_matches_jax(jmesh, pmesh):
    """8 distinct seeded Layer II streams of 3 frames."""
    rng = np.random.default_rng(6)
    blobs = [seeded_writers.layer2_frames(rng, 3, 2) for _ in range(8)]
    ja = [JL12.analyze_l2(b) for b in blobs]
    pa = [L12.analyze_l2(b) for b in blobs]
    arrays = MD.pack_layer12(pa, CPU)  # frames padded to a bucket of 8
    for k, t in zip(("codes", "cls", "sf_idx"), arrays):
        np.testing.assert_array_equal(
            t.numpy()[:, :3], np.stack([getattr(a, k) for a in ja]), err_msg=k)
    kw = dict(channels=2, steps=ja[0].steps_per_frame)
    with jmesh:
        want = np.asarray(JPD.sharded_l12_fn(jmesh, **kw)(
            *(a.numpy() for a in arrays)))
    got = P.sharded_l12_fn(pmesh, **kw)(*arrays)
    assert len(got.shards) == 4
    got = got.gather().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, L12.l12_synthesize(*arrays, **kw).numpy())


@pytest.fixture(scope="module")
def mp3_group():
    """The stereo fixture cut at 8 distinct frame boundaries (a frame-aligned
    prefix is a valid stream), packed by JAX's own lane packer."""
    blob = open(MP3_FIXTURE, "rb").read()
    frames = JFE.find_frames(blob)
    blobs = [blob[:frames[4 + i][0]] for i in range(8)]
    lanes = [JFE.analyze_lanes(b) for b in blobs]
    g_cap = MD._bucket(max(ln.n_granules for ln in lanes))
    m_cap = MD._bucket(max(len(b) for b in blobs), 1024)
    r = JMD._pack_python_lanes(lanes, g_cap, m_cap, 2)
    rate_idx = MD._rate_idx_arr(np.full(8, 44100))
    kw = dict(channels=2, joint_stereo=lanes[0].joint_stereo,
              n_big=MD._n_big(r["big"], r["valid"]), n_c1=144)
    return r, rate_idx, kw, [ln.n_granules for ln in lanes]


def test_sharded_mp3_decode_matches_jax(jmesh, pmesh, mp3_group):
    r, rate_idx, kw, n_gran = mp3_group
    with jmesh:
        want = np.asarray(JPD.sharded_mp3_decode_fn(jmesh, **kw)(
            *JMD.fused_wire_args(r, rate_idx)))
    args = MD.fused_wire_args(r, rate_idx, CPU)
    got = P.sharded_mp3_decode_fn(pmesh, **kw)(*args)
    assert len(got.shards) == 4
    got = got.gather().numpy()
    assert got.shape == want.shape
    for i, g in enumerate(n_gran):  # every file, up to its own length
        n = g * 576 * 2
        rms, bar = scaled_rms(want[i, :n], got[i, :n])
        assert rms < bar, (i, rms, bar)
    single = MDSP.mp3_decode_fused(*args, None, **kw).numpy()
    np.testing.assert_array_equal(got, single)


# ------------------------------------------------------------------ FLAC


@pytest.fixture(scope="module")
def flac_group():
    """8 JAX-encoded stereo files of distinct content, as the JAX package's
    own sharded FLAC test writes them; the sizing rounded to the data size."""
    rng = np.random.default_rng(8)
    S = 1500
    t = np.arange(S) / 44100.0
    blobs = []
    for i in range(8):
        base = np.sin(2 * np.pi * (200.0 + 37.0 * i) * t) * (4000 + 900 * i)
        x = np.stack([base, base * 0.6 + rng.standard_normal(S) * 3], 1)
        ints = np.round(x).astype(np.int64)
        blobs.append(encode_flac(ints.astype(np.float32) / 2.0 ** 15, 44100,
                                 bits=16, blocksize=256))
    sizing = P.round_sizing(JFD.sizing_for([JFF.analyze(b) for b in blobs]), 4)
    return blobs, sizing


def test_sharded_flac_decode_matches_jax_and_single(jmesh, pmesh, flac_group,
                                                    monkeypatch):
    blobs, sizing = flac_group
    jargs, jstatics = JFD.pack_group([JFF.analyze(b) for b in blobs], sizing)
    with jmesh:
        jx = [JPD.sharded_flac_fn(jmesh, window_impl=impl, **jstatics)(*jargs)
              for impl in ("xla", "pallas")]
    args, statics = FD.pack_group([FF.analyze(b) for b in blobs], CPU, sizing)
    calls = {"window_add": 0, "window_add2": 0}
    for mod, name in ((PW, "window_add"), (FV, "window_add2")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name: (
            calls.__setitem__(_n, calls[_n] + 1) or _f(*a)))
    before = dict(M.collectives)
    pcm, ovf = P.sharded_flac_fn(pmesh, **statics)(*args)
    # three K5 calls (two for the values, one for the PCM), K3 per shard
    assert calls == {"window_add": 12, "window_add2": 0}
    assert M.collectives["psum"] - before["psum"] == 4  # K5 x 3 + overflow
    assert len(pcm.shards) == 4 and len(ovf.shards) == 4
    got, got_ovf = pcm.gather().numpy(), ovf.gather().numpy()
    assert not got_ovf.any()
    for jpcm, jovf in jx:
        np.testing.assert_array_equal(got, np.asarray(jpcm))
        np.testing.assert_array_equal(got_ovf, np.asarray(jovf))
    one, one_ovf = FV.flac_decode_batch(*args, **statics)
    np.testing.assert_array_equal(got, one.numpy())
    np.testing.assert_array_equal(got_ovf, one_ovf.numpy())


def test_sharded_flac_outliers_and_overflow_match_single(pmesh):
    """Host-decoded quotient outliers (``dv_*``, added once after the
    values' psum) and an overflowing lane (its file's flag is an OR over
    the shards, a psum): the sharded decode equals the single-device one."""
    rng = np.random.default_rng(10)
    x = rng.integers(-3, 4, (600, 2))
    x[::37, 0] += 20000
    x[5::41, 1] -= 20000
    spiky = flac_writer.encode_file(x, blocksize=256, subframe_kw=dict(
        kind="lpc", lpc_coefs=[1200, -600, 300, -100], lpc_shift=10))
    quiet = flac_writer.encode_file(rng.integers(-40, 40, (512, 2)),
                                    blocksize=256)
    analyses = [FF.analyze(b) for b in [quiet, spiky] * 4]
    assert sum(a.dv_sub.size for a in analyses) > 0
    sizing = P.round_sizing(FD.sizing_for(analyses), 4)
    args, statics = FD.pack_group(analyses, CPU, sizing)
    args = list(args)
    # point one live rice lane of the last file at its end, where the
    # stream's zero padding reads as an all-zero window: q = 32 > Q_CAP
    rl_file, rl_bitpos, rl_count = args[3], args[5].clone(), args[6]
    k = int(torch.nonzero((rl_file == 7) & (rl_count > 0))[0])
    rl_bitpos[k] = args[1][7] + args[2][7] - 32
    args[5] = rl_bitpos
    pcm_s, ovf_s = P.sharded_flac_fn(pmesh, **statics)(*args)
    one, one_ovf = FV.flac_decode_batch(*args, **statics)
    assert one_ovf.tolist() == [False] * 7 + [True]
    np.testing.assert_array_equal(ovf_s.gather().numpy(), one_ovf.numpy())
    np.testing.assert_array_equal(pcm_s.gather().numpy(), one.numpy())


def test_sharded_flac_refuses_an_unrounded_sizing(pmesh, flac_group):
    blobs, sizing = flac_group
    sizing = dict(sizing, Lw=sizing["Lw"] + 1)
    args, statics = FD.pack_group([FF.analyze(b) for b in blobs], CPU, sizing)
    with pytest.raises(ValueError, match="does not divide"):
        P.sharded_flac_fn(pmesh, **statics)(*args)


# ---------------------------------------------------------------- render


#: where each command-allocated voice moves: shard 0 keeps 0-2, shard 1
#: (voices 32-63) gets 3 and 4
SLOT = {0: 0, 1: 5, 2: 17, 3: 40, 4: 63}


def _render_pair():
    """Both packages' states over the same tracks and commands: three loud
    voices of a +0.6 track on voice shard 0 and two of a -0.6 track on
    shard 1, so each shard's mix passes 1 while their sum stays under it;
    one voice sequenced with chance and jitter (the random draws)."""
    S = 600
    names = ["a", "b", "c", "d", "e"]
    tracks = np.stack([np.full((S, 2), 0.6 if n < "d" else -0.6, np.float32)
                       for n in names])
    tracks[:, ::50] *= 0.5  # a texture, so positions show in the mix
    lens, chs = [S] * 5, [2] * 5
    j = JS.empty_state(tracks, lens, chs, out_channels=2)
    p = PS.empty_state(tracks, lens, chs, out_channels=2, device=CPU)
    jreg, preg = JS.HostRegistry(names), PS.HostRegistry(names)
    jproc, pproc = JC.CmdProcessor(jreg, 1000), PC.CmdProcessor(preg, 1000)
    lines = ["load a -t s:60", "seq a -p 4 -s 0,1,2 -c a:0.6 -j a:0.4",
             "start -v a"] + [f"{verb} {n}" for n in names[1:]
                              for verb in ("load", "start -v")]
    for line in lines:
        j = JC.apply(j, jreg, jproc.parse(line))
        p = PC.apply(p, preg, pproc.parse(line))
    # move the voices to their slots, the same permutation in both
    perm = np.arange(64)
    for src, dst in SLOT.items():
        perm[dst], perm[src] = src, dst
    for k in PPR._VOICE_FIELDS:
        j = dataclasses.replace(j, **{k: jnp.asarray(np.asarray(getattr(j, k))[perm])})
        p = dataclasses.replace(p, **{k: getattr(p, k)[torch.from_numpy(perm)]})
    assert int(np.asarray(j.v_used).sum()) == 5
    return j, p


def test_voice_sharded_render_matches_jax(jmesh, pmesh):
    j, p = _render_pair()
    jfn = JPR.sharded_render_fn(jmesh, frames=128, out_channels=2)
    jst = JPR.shard_engine_state(j, jmesh)
    fn = P.sharded_render_fn(pmesh, frames=128, out_channels=2)
    sst = P.shard_engine_state(p, pmesh)
    single = p
    clipped = 0
    for _ in range(3):
        # the trap: each shard's own mix passes 1, so clamping per shard
        # would give another block
        mixes = [PR.render_mix(part, frames=128, out_channels=2)[0]
                 for part in sst.parts]
        per_shard = sum(m.clamp(-1, 1) for m in mixes).clamp(-1, 1)
        with jmesh:
            jblk, jst = jfn(jst)
        blk, sst = fn(sst)
        ref, single = PR.render_block(single, frames=128, out_channels=2)
        assert len(blk.copies) == 8 and all(c is blk.value for c in blk.copies)
        got = blk.value.numpy()
        assert np.abs(got - np.asarray(jblk)).max() <= RENDER_ATOL
        assert np.abs(got - ref.numpy()).max() <= RENDER_ATOL
        clipped += int((np.abs(got - per_shard.numpy()) > 0.1).sum())
        whole = sst.gather()
        for k in ("v_pos", "v_active", "clock"):
            np.testing.assert_array_equal(getattr(whole, k).numpy(),
                                          np.asarray(getattr(jst, k)), err_msg=k)
            assert torch.equal(getattr(whole, k), getattr(single, k)), k
    assert clipped > 0


def test_shard_engine_state_splits_voices_and_gathers_back(pmesh):
    _j, p = _render_pair()
    spec = P.state_shardings(pmesh, p)
    assert {k for k, a in spec.items() if a == "model"} == set(PPR._VOICE_FIELDS)
    sst = P.shard_engine_state(p, pmesh)
    assert len(sst.parts) == 2
    assert sst.parts[0].v_pos.shape == (32,) and sst.parts[1].p_kind.shape[0] == 32
    assert sst.parts[0].tracks is sst.parts[1].tracks
    back = sst.gather()
    for k in spec:
        assert torch.equal(getattr(back, k), getattr(p, k)), k


# ---------------------------------------------------------------- dry run


def test_dryrun_multichip_on_the_cpu_mesh():
    rng = np.random.default_rng(9)
    mp3 = open(MP3_FIXTURE, "rb").read()
    mp3 = mp3[:JFE.find_frames(mp3)[12][0]]
    flac = flac_writer.encode_file(
        (rng.standard_normal((700, 2)) * 3000).astype(np.int64), blocksize=256)
    inputs = {"mp3": mp3, "layer2": seeded_writers.layer2_frames(rng, 3, 2),
              "flac": flac}
    out = P.dryrun_multichip(8, devices=[CPU] * 8, inputs=inputs)
    assert out["mesh"] == {"data": 4, "model": 2}
    assert out["paths"] == ["wav", "mp3", "layer2", "flac", "render"]
    launches = out["launches"]
    assert all(launches[k] == 0 for k in ("mp3_entropy_scan", "window_add",
                                          "window_add2", "window_add_spmd"))
    assert launches["collective_psum"] >= 4 + 3  # FLAC's four, a psum a block


def test_dryrun_multichip_refuses_unknown_inputs():
    with pytest.raises(ValueError, match="unknown inputs"):
        P.dryrun_multichip(8, devices=[CPU] * 8, inputs={"ogg": b""})

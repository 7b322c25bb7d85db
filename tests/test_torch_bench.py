"""PyTorch port: the bench (audio_decoder_tpu_torch/bench.py) and the
threefry draws it needs, against bench.py and ``jax.random`` on the CPU.

Tolerances:

* ``threefry.uniform`` over any range: bit for bit (XLA:CPU computes
  ``floats * (hi - lo) + lo`` as one FMA, and so does the port);
* ``threefry.normal``: max abs ``NORMAL_BAR`` (2e-6) on N(0, 1) samples; the
  port follows XLA's ``erf_inv`` polynomial but its ``log1p`` rounds as
  torch's does (4.8e-7 is the worst seen);
* inputs (WAV blobs, the FLAC source, the WAV batch made on the device, the
  render state's voices): byte for byte or exact;
* decodes: WAV PCM exact, MP3 within the amplitude-scaled RMS 5e-7, audio
  seconds equal; renders within 2e-6 of JAX's ``render_block`` calls
  (tests/test_torch_engine.py's bar) with positions, active flags and clocks
  equal, and positions within 1 ulp a block of JAX's ``render_chain``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as JB
from audio_decoder_tpu.codecs.mpeg import decoder as JMD
from audio_decoder_tpu.engine import render as JR
from audio_decoder_tpu.engine import state as JS
from audio_decoder_tpu.io.assets import Asset as JAsset
from audio_decoder_tpu.parallel.decode import decode_pcm_step as j_decode_pcm_step
from audio_decoder_tpu_torch import bench as PB
from audio_decoder_tpu_torch import cli as PCLI
from audio_decoder_tpu_torch.engine import render as PR
from audio_decoder_tpu_torch.parallel.dryrun import scaled_rms
from audio_decoder_tpu_torch.utils import threefry as TF

CPU = "cpu"
RATE = 44100
NORMAL_BAR = 2e-6
RENDER_BAR = 2e-6
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "iters"}


# ---------------------------------------------------------------------------
# threefry over a range, and normal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(1000.0, 87200.0), (-3.0, 5.5), (0.0, 1.0)])
def test_uniform_over_a_range_equals_jax(lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(12), (100_000,),
                                         jnp.float32, lo, hi))
    got = TF.uniform(TF.prng_key(12, device=CPU), (100_000,), lo, hi).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_normal_within_its_bar_of_jax():
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (8, 4410, 2)))
    got = TF.normal(TF.prng_key(11, device=CPU), (8, 4410, 2))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= NORMAL_BAR


def test_erf_inv_edges():
    """±1 give ±inf, 0 gives 0, and the output is odd (as XLA's)."""
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.5, 0.999], dtype=torch.float32)
    y = TF.erf_inv(x)
    assert y[0] == -np.inf and y[1] == np.inf and y[2] == 0.0
    assert y[3] == -y[4]
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy()[3:])))
    np.testing.assert_allclose(y[3:].numpy(), want, rtol=0, atol=NORMAL_BAR)


# ---------------------------------------------------------------------------
# inputs: byte for byte those of bench.py
# ---------------------------------------------------------------------------


def _bench_flac_music(rng, frames):
    """bench.py:597-603, as it stands there."""
    tgrid = np.arange(frames) / RATE
    m = np.zeros(frames)
    for f0, a in ((110.0, 0.35), (220.5, 0.2), (331.1, 0.12)):
        m += a * np.sin(2 * np.pi * f0 * tgrid) * np.exp(-0.2 * tgrid)
    m += 0.002 * rng.standard_normal(frames)
    return np.clip(np.stack([m, 0.8 * m], 1) * 20000,
                   -32768, 32767).astype(np.float32) / 2.0 ** 15


@pytest.mark.parametrize("music", [False, True])
def test_wav_blob_equals_bench(music):
    want = JB._wav_blob(np.random.default_rng(7), 0.1, RATE, music=music)
    got = PB._wav_blob(np.random.default_rng(7), 0.1, RATE, music=music)
    assert got == want


def test_inputs_draw_in_bench_order():
    """bench.py without LAME draws the template, then the FLAC noise (the
    MP3 blob returns before drawing); the port's main draws the same, so
    the later blobs (the noise WAV files of wav_e2e) match too."""
    seconds, frames = 0.1, 4410
    jrng = np.random.default_rng(7)
    template = JB._wav_blob(jrng, seconds, RATE)
    mus = _bench_flac_music(jrng, frames)
    after = JB._wav_blob(jrng, seconds, RATE)

    prng = np.random.default_rng(7)
    inp = PB.mixed_inputs(prng, n_wav=2, n_mp3=0, seconds=seconds, device=CPU)
    got_mus = PB.flac_music(prng, inp.frames)
    assert got_mus.dtype == np.float32
    np.testing.assert_array_equal(got_mus, mus)
    assert PB._wav_blob(prng, seconds, RATE) == after
    hdr = inp.wav_bufs[0, :44].numpy().tobytes()
    assert hdr == template[:44]
    assert int(inp.wav_lens[0]) == len(template)


def test_device_wav_batch_equals_bench():
    """n = 2, 0.1 s: the port's threefry batch equals bench.py's
    ``_device_wav_batch`` (JAX on the CPU) byte for byte."""
    template = JB._wav_blob(np.random.default_rng(7), 0.1, RATE)
    width = 65536
    want = np.asarray(JB._device_wav_batch(jax, jnp, template[:44], 2, 4410,
                                           2, width))
    got = PB.device_wav_batch(template[:44], 2, 4410, 2, width, device=CPU)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the headline against JAX's decode of the same bytes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed():
    return PB.mixed_inputs(np.random.default_rng(7), n_wav=2, n_mp3=2,
                           seconds=0.25, device=CPU)


def test_run_once_matches_jax(mixed):
    pcm, meta, pieces = PB.decode_mixed(mixed)
    jpcm, jmeta = j_decode_pcm_step(
        jnp.asarray(mixed.wav_bufs.numpy()), jnp.asarray(mixed.wav_lens.numpy()),
        bits=16, channels=2, max_frames=mixed.max_frames, family="wav")
    np.testing.assert_array_equal(pcm.numpy(), np.asarray(jpcm))
    np.testing.assert_array_equal(meta["n_frames"].numpy(),
                                  np.asarray(jmeta["n_frames"]))
    jassets = [JAsset(a.path, a.name, a.ext, a.data) for a in mixed.mp3_assets]
    jpieces = JMD.decode_group(jassets)
    assert [list(i) for i, _ in pieces] == [list(i) for i, _ in jpieces]
    for (_, b), (_, jb) in zip(pieces, jpieces):
        for i in range(b.batch_size):
            got, want = b.file(i).pcm, jb.file(i).pcm
            assert got.shape == want.shape
            rms, bar = scaled_rms(want, got)
            assert rms < bar

    want_secs = float(np.sum(np.asarray(jmeta["n_frames"]))) / RATE
    want_secs += sum(float(jb.audio_seconds()) for _, jb in jpieces)
    assert PB.run_once(mixed) == want_secs
    assert want_secs == pytest.approx(2 * 0.25 + 2 * 10.031020164489746)


def test_gates_pass_and_raise(mixed):
    launches = PB.check_mixed(mixed)
    assert set(launches) == set(PB.KERNELS)
    assert all(n == 0 for n in launches.values())  # the CPU runs the twins
    bad = dataclasses.replace(mixed, wav_bufs=mixed.wav_bufs.clone())
    bad.wav_bufs[1, :4] = 0  # no RIFF: the file gets an error code
    with pytest.raises(RuntimeError, match="WAV file has an error code"):
        PB.check_mixed(bad)

    mus = PB.flac_music(np.random.default_rng(3), 2205)
    assets = PB.flac_assets(mus, 2, device=CPU)
    PB.check_flac(assets, mus, device=CPU)
    with pytest.raises(RuntimeError, match="quantized source"):
        PB.check_flac(assets, mus * np.float32(0.5), device=CPU)


# ---------------------------------------------------------------------------
# the render state and a short render against bench.py's JAX state
# ---------------------------------------------------------------------------


def _jax_render_state(tracks, S):
    """bench.py:642-661 with ``tracks`` ([T, S, 2])."""
    T = tracks.shape[0]
    st = JS.empty_state(tracks, [S] * T, [2] * T, out_channels=2)
    V = JS.MAX_VOICES
    pos = jax.random.uniform(jax.random.PRNGKey(12), (V,),
                             minval=1000.0, maxval=S - 1000.0)
    vel = jnp.where(jnp.arange(V) % 3 == 0, -1.0, 1.0) * (
        0.25 + 1.75 * jax.random.uniform(jax.random.PRNGKey(13), (V,)))
    return dataclasses.replace(
        st, v_used=jnp.ones((V,), bool), v_active=jnp.ones((V,), bool),
        v_track=jnp.arange(V, dtype=jnp.int32) % T,
        v_pos=pos.astype(jnp.float32), v_vel=vel.astype(jnp.float32),
        v_gain=jnp.full((V,), 1.0 / 64, jnp.float32))


def test_render_state_and_chain_match_jax():
    S = 4410
    st = PB.render_state(n_tracks=8, track_frames=S, device=CPU)
    jtracks = jax.random.normal(jax.random.PRNGKey(11), (8, S, 2)) * 0.1
    jst = _jax_render_state(jtracks, S)
    for name in ("v_pos", "v_vel", "v_gain", "v_track", "v_used", "v_active"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)), name)
    assert np.abs(st.tracks.numpy() - np.asarray(jst.tracks)).max() <= 0.1 * NORMAL_BAR

    # the render itself on equal tracks: JAX's state with the port's tracks.
    # The port's chain is its render_block run twice; JAX's render_block
    # rounds the cursor's multiply-add once (an FMA), as the port does, but
    # XLA:CPU compiles render_chain's scan body at depth 2 without the FMA,
    # so JAX's own chain is held to the port's positions within 1 ulp a block
    # (the cursor carries the difference from block to block).
    jst = _jax_render_state(st.tracks.numpy().reshape(8, S, 2), S)
    blks, acts, poss, clocks = PR.render_chain(st, frames=256, out_channels=2,
                                               depth=2)
    assert float(blks.abs().max()) > 0
    cur = jst
    for i in range(2):
        jblk, cur = JR.render_block(cur, frames=256, out_channels=2)
        assert np.abs(blks[i].numpy() - np.asarray(jblk)).max() <= RENDER_BAR
        np.testing.assert_array_equal(acts[i].numpy(), np.asarray(cur.v_active))
        np.testing.assert_array_equal(poss[i].numpy(), np.asarray(cur.v_pos))
        np.testing.assert_array_equal(clocks[i].numpy(), np.asarray(cur.clock))
    jposs = np.asarray(JR.render_chain(jst, frames=256, out_channels=2,
                                       depth=2)[2])
    ulps = np.abs(poss.numpy().view(np.int32).astype(np.int64)
                  - jposs.view(np.int32).astype(np.int64))
    assert (ulps <= np.arange(1, 3)[:, None]).all()


# ---------------------------------------------------------------------------
# the entry points and the extras
# ---------------------------------------------------------------------------


def test_cli_bench_on_the_cpu(monkeypatch, capsys):
    for k, v in {"BENCH_N_WAV": "2", "BENCH_N_MP3": "1", "BENCH_SECONDS": "0.25",
                 "BENCH_MEASURE_S": "0.05", "BENCH_SKIP_EXTRAS": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    assert PCLI.main(["--platform", "cpu", "bench"]) == 0
    out = capsys.readouterr()
    rec = json.loads(out.out.strip().splitlines()[-1])
    assert set(rec) == HEADLINE_KEYS
    assert rec["metric"] == "decode_throughput_mixed"
    assert rec["unit"] == "audio_sec/sec/chip"
    assert rec["value"] > 0 and rec["vs_baseline"] == rec["value"]
    assert rec["iters"] >= 3
    assert "[bench " in out.err and "gate passed" in out.err


def test_bench_without_a_card_raises(monkeypatch):
    """``cuda`` (the default) without a card raises before any work; the
    CLI's --platform wins over BENCH_PLATFORM."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PCLI.main(["bench"])
    monkeypatch.delenv("BENCH_PLATFORM")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PB.main()


def _extra(name):
    rng = np.random.default_rng(7)
    if name == "flac_e2e_x":
        mus = PB.flac_music(rng, 2205)
        return PB.flac_e2e(PB.flac_assets(mus, 2, device=CPU), device=CPU, reps=1)
    if name == "render_x":
        return PB.render(n_tracks=2, track_frames=4410, frames=256, depth=2,
                         reps=1, device=CPU)
    if name == "p50_file_latency_ms":
        return PB.p50_file_latency(rng, seconds=0.05, runs=3, device=CPU)
    if name == "decode_throughput_mixed3":
        inp = PB.mixed_inputs(rng, n_wav=2, n_mp3=1, seconds=0.05, device=CPU)
        mus = PB.flac_music(rng, inp.frames)
        return PB.mixed3(inp, PB.flac_assets(mus, 2, device=CPU), reps=1)
    return PB.wav_e2e(rng, 2, seconds=0.05, device=CPU)


@pytest.mark.parametrize("keys", [("flac_e2e_x",), ("render_x",),
                                  ("p50_file_latency_ms",),
                                  ("decode_throughput_mixed3",),
                                  ("wav_e2e_music_x", "wav_e2e_noise_x")])
def test_each_extra_at_a_tiny_size(keys):
    got = _extra(keys[0])
    assert set(got) == set(keys)
    assert all(v > 0 for v in got.values())

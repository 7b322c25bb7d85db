"""PyTorch port: the engine's render and live loop against the benchmark's
plain reference (``h100bench/reference/engine.py``), on the CPU.

The reference steps every voice one frame at a time in NumPy and float64,
with its own Threefry-2x32 in NumPy uint32, and imports nothing of the
port; the port's ``commands.apply`` makes the states it starts from.  Here
``render_block`` and ``EngineLoop`` (speculating 8 blocks deep) render a
script that uses every verb, chance below 1, jitter above 0, a
reversed voice, a paused group and mono tracks, on seeded random tracks;
each call's blocks must agree with the reference's within float32
round-off, and the renderer's state must equal the reference's.  The loop
without speculation equals the loop with it bit for bit.  The reference's
Threefry is held to the published known answers and to ``utils/threefry``
on edge keys and counters.
"""

import copy

import numpy as np
import pytest
import torch

from audio_decoder_tpu_torch.engine import commands as EC
from audio_decoder_tpu_torch.engine import state as ES
from audio_decoder_tpu_torch.engine.render import render_block
from audio_decoder_tpu_torch.runtime import loop as loop_mod
from audio_decoder_tpu_torch.runtime.loop import PERIOD, EngineLoop
from audio_decoder_tpu_torch.runtime.native import Sink
from audio_decoder_tpu_torch.utils import threefry as TF
from h100bench.reference import engine as R

RATE = 44100
NAMES = ["t0", "t1", "t2", "t3", "t4", "t5"]
MONO = {"t4", "t5"}
#: calls of the live loop: (command lines, blocks rendered after them)
SCRIPT = [
    (["tc ctx s:300", "load t0 -t c:ctx", "load t1 -t s:200", "load t2 -t m:5",
      "load t3 -t b:600", "load t4 -t c:ctx", "load t5 -t s:700",
      "seq t0 -p 8 -s 0,1,3,5 -c a:0.6 -j a:0.4", "seq t1 -p 5 -s 0,2 -c 0:0.5 -j a:0.9",
      "seq t2 -p 3 -s 0,1,2 -c a:0.7", "trem t3 -p 4 -d 0.7", "env t4 -p 2 -d 0.8",
      "seq t4 -p 4 -s 0,3 -c a:0.8 -j a:1.0", "velocity t1 -1.3", "velocity t2 0.77",
      "group g -v t3,t4 -t s:500", "seq g -p 6 -s 0,2,4 -c a:0.9 -j a:0.2",
      "start -t ctx", "start -v t0", "start -v t1", "start -v t2", "start -g g",
      "start -v t5"], 3),
    (["pause -g g"], 2), (["resume -g g"], 3), (["pause -v t0"], 1), (["resume -v t0"], 2),
    (["stop -v t1"], 1), (["start -v t1"], 3), (["unload t2"], 1), (["load t2 -t s:90"], 1),
    (["start -v t2"], 2), (["stop -t ctx"], 2), (["start -t ctx"], 1), (["pause -t ctx"], 1),
    (["resume -t ctx"], 2), (["tc c2 b:300"], 1), (["velocity t5 -0.6"], 1),
    (["start -v t5"], 3), (["trem t0 -t c:c2 -p 3 -d 0.5"], 2), (["start -t c2"], 3),
]


def _tracks(seed: int):
    """Six seeded tracks in a stereo store: noise bursts under a decay, of
    several lengths; t4 and t5 are mono (their second channel empty)."""
    rng = np.random.default_rng([seed, 21])
    S = 3000
    lens = [3000, 2500, 1000, 2999, int(rng.integers(300, 900)), 400]
    pcm = np.zeros((len(NAMES), S, 2), np.float32)
    for i, n in enumerate(lens):
        env = np.exp(-np.arange(n) / rng.uniform(200, 2000))[:, None]
        pcm[i, :n] = rng.uniform(-0.4, 0.4, (n, 2)) * env
        if NAMES[i] in MONO:
            pcm[i, :, 1] = 0.0
    chs = [1 if n in MONO else 2 for n in NAMES]
    return pcm, lens, chs


def _loop(seed: int) -> EngineLoop:
    pcm, lens, chs = _tracks(seed)
    st = ES.empty_state(pcm, lens, chs, out_channels=2, device="cpu")
    return EngineLoop(st, ES.HostRegistry(NAMES), RATE, 2,
                      sink=Sink("default", RATE, 2, realtime=False))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_block_agrees_with_the_reference(seed):
    pcm, lens, chs = _tracks(seed)
    st = ES.empty_state(pcm, lens, chs, out_channels=2, device="cpu")
    reg = ES.HostRegistry(NAMES)
    proc = EC.CmdProcessor(reg, RATE)
    store = pcm.reshape(len(NAMES), -1)
    loud = 0.0
    for lines, n in SCRIPT:
        for line in lines:
            st = EC.apply(st, reg, proc.parse(line))
        want, after = R.render(ES.to_numpy(st), store, n, PERIOD, 2)
        got = []
        for _ in range(n):
            blk, st = render_block(st, frames=PERIOD, out_channels=2)
            got.append(blk.numpy())
        got = np.concatenate(got)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6, lines
        state = ES.to_numpy(st)
        for field in ("v_active", "v_pos", "clock"):
            assert np.array_equal(state[field], after[field]), (lines, field)
        loud = max(loud, float(np.abs(want).max()))
    assert loud > 0.3


@pytest.mark.parametrize("seed", [3, 4])
def test_the_live_loop_agrees_with_the_reference(seed):
    assert loop_mod.SPEC_DEPTH == 8
    loop = _loop(seed)
    store = loop.state.tracks.numpy()
    for lines, n in SCRIPT:
        found = ES.to_numpy(loop.state)
        reg = copy.deepcopy(loop.reg)
        assert all(loop.submit(line) for line in lines)
        got = loop.run_blocks(n, collect=True)
        proc = EC.CmdProcessor(reg, RATE)
        st = ES.from_numpy(found, device="cpu")
        for line in lines:
            st = EC.apply(st, reg, proc.parse(line))
        want, after = R.render(ES.to_numpy(st), store, n, PERIOD, 2)
        assert got.shape == want.shape == (n * PERIOD, 2)
        assert np.abs(got - want).max() <= 1e-6, lines
        # the state the next call starts from is the last sunk block's
        left = ES.to_numpy(loop.state)
        for field in ("v_active", "v_pos", "clock"):
            assert np.array_equal(left[field], after[field]), (lines, field)
    assert not loop.errors


def test_speculation_off_equals_speculation_on_bit_for_bit(monkeypatch):
    runs = {}
    for depth in (0, 8):
        monkeypatch.setattr(loop_mod, "SPEC_DEPTH", depth)
        loop = _loop(5)
        chunks = []
        for lines, n in SCRIPT + [([], 20)]:
            for line in lines:
                loop.submit(line)
            chunks.append(loop.run_blocks(n, collect=True))
        runs[depth] = np.concatenate(chunks)
    assert np.abs(runs[0]).max() > 0.3
    assert np.array_equal(runs[0], runs[8])


KEYS = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0x13198A2E, 0x03707344), (0, 0xB1A57),
        (1 << 31, 1), (0x7FFFFFFF, 0x80000000)]
COUNTERS = np.array([0, 1, 2, 127, 128, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                    np.uint32)


def test_the_references_threefry_gives_the_published_answers():
    # Salmon et al., SC 2011: Random123's known-answer tests for 2x32, 20 rounds
    for key, ctr, want in [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                           ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                            (0x1CB996FC, 0xBB002BE7)),
                           ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                            (0xC4923A9C, 0x483DF7A0))]:
        y0, y1 = R.threefry2x32(key, np.array([ctr[0]], np.uint32), np.array([ctr[1]], np.uint32))
        assert (int(y0[0]), int(y1[0])) == want


@pytest.mark.parametrize("key", KEYS)
def test_the_references_threefry_equals_the_ports(key):
    k = torch.tensor(key, dtype=torch.int64)
    hi, lo = np.meshgrid(COUNTERS, COUNTERS, indexing="ij")
    y0, y1 = R.threefry2x32(key, hi.ravel(), lo.ravel())
    t0, t1 = TF.threefry2x32(k[0], k[1], torch.from_numpy(hi.ravel().astype(np.int64)),
                             torch.from_numpy(lo.ravel().astype(np.int64)))
    assert np.array_equal(y0.astype(np.int64), t0.numpy())
    assert np.array_equal(y1.astype(np.int64), t1.numpy())
    for clock in (0, 7, 128, -1, -(2**31), 2**31 - 1):
        folded = TF.fold_in(k, torch.tensor(clock, dtype=torch.int32))
        assert tuple(int(v) for v in R.fold_in(key, clock)) == tuple(folded.tolist())
        rolls = R.unit_floats(R.bits(R.fold_in(key, clock), 96 * PERIOD))
        assert np.array_equal(rolls, TF.uniform(folded, (96, PERIOD)).numpy().ravel())
    seed = int(TF.randint(TF.fold_in(k, 7), (), 0, (1 << 31) - 1))
    assert R.randint_scalar(R.fold_in(key, 7), 0, (1 << 31) - 1) == seed

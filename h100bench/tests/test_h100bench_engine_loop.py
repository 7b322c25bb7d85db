"""The live-loop cell (``programs/engine_loop.py``) on the CPU at its test
size: a whole run is correct, traced and not; the script is one the engine
accepts; the reference renders with the port's renderer unusable; and each
planted fault turns ``correct`` false through the run's own judge: the
chance roll dropped (every listed step fires), a stale burst handed back,
every command after the opening ignored, triggers one frame late, each call
leaving the state of its last speculated block, the consensus resample
skipped or a frame late, and the control, the reference with its voice mix
and its store rows in bfloat16."""

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from audio_decoder_tpu_torch import cli
from audio_decoder_tpu_torch.dsp import resample as resample_mod
from audio_decoder_tpu_torch.engine import commands as EC
from audio_decoder_tpu_torch.engine import render as render_mod
from audio_decoder_tpu_torch.engine import state as ES
from audio_decoder_tpu_torch.runtime import loop as loop_mod
from audio_decoder_tpu_torch.utils import threefry
from h100bench import run
from h100bench.inputs import live_assets
from h100bench.tests.conftest import small

BENCH = run.load_benchmark()
CELL = "blast-live.p128"
SEED = 2**33 + 101
VERBS = {"load", "start", "pause", "resume", "stop", "unload", "velocity", "group", "tc",
         "seq", "trem", "env"}


def _run(cache, traced=False, **hooks):
    cover, mover = small(CELL)
    return run.run_cell(BENCH, CELL, SEED, 1.0, traced, device="cpu", config_over=cover,
                        mix_over={**mover, "check_calls": 4}, t_start=time.perf_counter(),
                        cache_root=cache, workers=1, **hooks)


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_of_the_live_cell_is_correct(cache, traced):
    r = _run(cache, traced)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["checks"]) == {"command_errors", "bad_blocks", "pcm_max_abs",
                                "state_mismatches", "store_max_abs"}
    assert r["checks"]["pcm_max_abs"]["value"] < 1e-6
    assert r["checks"]["state_mismatches"]["value"] == 0
    assert r["checks"]["store_max_abs"]["value"] < 1e-6
    if traced:   # on the CPU no device event and no event pair: those read nothing
        assert set(r["metrics"]) == {
            "engine_render_us_per_block.live", "engine_fetch_us_per_block.live",
            "engine_apply_us_per_command.live", "engine_syncs_per_block.live",
            "engine_discard_pct.live"}
        assert r["metrics"]["engine_syncs_per_block.live"]["value"] == 0.0
    else:
        assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}


def test_the_script_is_one_the_engine_accepts_with_every_verb():
    from h100bench.programs import engine_loop

    _, config, mix = run.cell_parts(BENCH, CELL)
    names = sorted(f"{k['kind']}{n:02d}" for k, n in live_assets.layout(config))
    script = engine_loop.Script(mix, names, SEED)
    reg = ES.HostRegistry(names)
    proc = EC.CmdProcessor(reg, 44100)
    st = ES.empty_state(np.zeros((len(names), 8, 2), np.float32), [8] * len(names),
                        [2] * len(names), out_channels=2, device="cpu")
    opening = script.opening()
    assert len(opening) < 250          # the ring holds 255
    seen = set()
    for j, line in enumerate(opening + [script.next() for _ in range(400)]):
        seen.add(line.split()[0])
        st = EC.apply(st, reg, proc.parse(line))
        if j >= len(opening):
            assert mix["voices_min"] <= len(reg.voices) <= mix["voices_max"]
    assert seen == VERBS
    assert len(opening) - len(set(opening)) == 0
    seqs = [ln for ln in opening if ln.startswith("seq ")]
    assert all(" -c " in ln for ln in seqs)
    assert sum(" -j " in ln for ln in seqs) * 2 >= len(seqs)


def test_the_reference_renders_with_the_ports_renderer_unusable(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the reference called the port's renderer")

    for name in ("render_block", "render_mix", "render_chain"):
        monkeypatch.setattr(render_mod, name, refuse)
    pcm = np.random.default_rng(5).uniform(-0.3, 0.3, (2, 600, 2)).astype(np.float32)
    st = ES.empty_state(pcm, [600, 500], [2, 1], out_channels=2, device="cpu")
    reg = ES.HostRegistry(["a", "b"])
    lines = ["load a -t s:90", "load b -t s:70", "seq a -p 3 -s 0,2 -c a:0.5 -j a:0.5",
             "velocity b -1", "start -v a", "start -v b"]
    out, left = run.program(run.cell_parts(BENCH, CELL)[1]).reference_call(
        ES.to_numpy(st), reg, lines, 3, 128, 2, 44100, pcm.reshape(2, -1))
    assert out.shape == (384, 2) and np.abs(out).max() > 0.05
    assert int(left["clock"]) == 384 and left["v_active"][:2].all()


# ---- planted faults ------------------------------------------------------------

def _no_roll(monkeypatch):
    """The chance roll dropped: every listed step fires."""
    monkeypatch.setattr(threefry, "uniform",
                        lambda key, shape, *a, **k: torch.zeros(shape, device=key.device))


def _stale(monkeypatch):
    """Each burst hands back the blocks of the last burst of its depth."""
    real_block, real_chain = loop_mod.render_block, loop_mod.render_chain
    last = {}

    def block(st, **kw):
        blk, st2 = real_block(st, **kw)
        out, last[1] = last.get(1, blk), blk
        return out, st2

    def chain(st, **kw):
        blks, *rest = real_chain(st, **kw)
        out, last[kw["depth"]] = last.get(kw["depth"], blks), blks
        return (out, *rest)

    monkeypatch.setattr(loop_mod, "render_block", block)
    monkeypatch.setattr(loop_mod, "render_chain", chain)


def _ignored(monkeypatch):
    """Every command after the opening script (clock 0) is dropped."""
    def apply(st, reg, cmd):
        return st if int(st.clock) > 0 else EC.apply(st, reg, cmd)

    monkeypatch.setattr(loop_mod, "EC", types.SimpleNamespace(
        apply=apply, CmdErr=EC.CmdErr, CmdProcessor=EC.CmdProcessor))


def _late(monkeypatch):
    """Every tempo lane starts a frame later, so every trigger is late."""
    real_block, real_chain = loop_mod.render_block, loop_mod.render_chain

    def block(st, **kw):
        blk, st2 = real_block(dataclasses.replace(st, t_start=st.t_start + 1), **kw)
        return blk, dataclasses.replace(st2, t_start=st.t_start)

    def chain(st, **kw):
        return real_chain(dataclasses.replace(st, t_start=st.t_start + 1), **kw)

    monkeypatch.setattr(loop_mod, "render_block", block)
    monkeypatch.setattr(loop_mod, "render_chain", chain)


@pytest.mark.parametrize("fault", [_no_roll, _stale, _ignored, _late])
def test_a_planted_fault_is_not_correct(cache, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(cache)
    assert r["correct"] is False
    pcm = r["checks"]["pcm_max_abs"]
    assert pcm["value"] > pcm["limit"], (fault.__name__, pcm)


def _handoff(monkeypatch):
    """Each call leaves the loop at the state of its last speculated block,
    not of its last sunk one, and the next call starts there."""
    real = loop_mod.EngineLoop.run_blocks

    def run_blocks(self, n, collect=False):
        out = real(self, n, collect=collect)
        if self._spec:
            self.state = self._spec[-1][1]
        return out

    monkeypatch.setattr(loop_mod.EngineLoop, "run_blocks", run_blocks)


def test_a_fault_in_the_state_handed_to_the_next_call_is_not_correct(cache, monkeypatch):
    _handoff(monkeypatch)
    r = _run(cache)
    assert r["correct"] is False
    assert r["checks"]["state_mismatches"]["value"] > 0
    assert r["checks"]["pcm_max_abs"]["value"] < 1e-6     # each call's blocks still agree


def _unresampled(monkeypatch):
    """The engine keeps every file at its own rate, as the reference program
    plays a folder of mixed rates."""
    real = cli._build_engine
    monkeypatch.setattr(cli, "_build_engine",
                        lambda folder, resample, *a, **k: real(folder, False, *a, **k))


def _resampled_late(monkeypatch):
    """The resampled rows come out one frame late."""
    real = resample_mod.resample_to_consensus

    def late(batch, rate, *a, **k):
        moved = (batch.sample_rate != rate).nonzero().flatten()
        out = real(batch, rate, *a, **k)
        data = out.data.clone()
        data[moved] = torch.roll(data[moved], out.channels, dims=1)
        return dataclasses.replace(out, data=data)

    monkeypatch.setattr(resample_mod, "resample_to_consensus", late)


@pytest.mark.parametrize("fault", [_unresampled, _resampled_late])
def test_a_fault_in_the_track_store_is_not_correct(cache, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(cache)
    assert r["correct"] is False
    store = r["checks"]["store_max_abs"]
    assert store["value"] > store["limit"], (fault.__name__, store)


def test_the_bfloat16_control_is_not_correct(cache):
    r = _run(cache, control=True)
    assert r["correct"] is False
    pcm = r["checks"]["pcm_max_abs"]
    assert pcm["value"] > pcm["limit"] and r["checks"]["command_errors"]["value"] == 0
    store = r["checks"]["store_max_abs"]
    assert store["value"] > store["limit"]

"""The seam between the loop and a program: a configuration that names a
program of its own, here the toy ``programs/sine_blocks.py`` beside these
tests, runs through ``run_cell`` with a mix that holds none of the decode
program's keys, is judged by its own reference, and is read by the same
metric readers as every cell."""

import json
import os
import time

import pytest

from h100bench import run, traffic
from h100bench.tests.conftest import small

BENCH = run.load_benchmark()
HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "toy-sine.blocks"
MIX = {"block_frames": 256, "blocks_per_call": 4, "warmup_calls": 1, "check_calls": 3,
       "trace_skip": 1, "trace_calls": 2}
DECODE_KEYS = ("files_per_call", "rotate_frames", "prepared_calls", "check_files")


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """BENCHMARK.json with the toy's configuration, cell and mix added, and
    ``audio_s_per_s`` and the device's idle share reported in its cell."""
    _, flac, _ = run.cell_parts(BENCH, "librispeech-flac.loader")
    config = {**flac, **small("librispeech-flac.loader")[0], "name": "toy-sine",
              "program": "sine_blocks"}
    path = tmp_path / "toy-sine.json"
    path.write_text(json.dumps(config))
    real = traffic.load_mix
    monkeypatch.setattr(traffic, "load_mix",
                        lambda name: dict(MIX) if name == "toy" else real(name))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy-sine", "source": "none", "file": str(path),
                             "reduced": [], "why": "the loop's tests"})
    bench["workloads"].append({"name": CELL, "config": "toy-sine", "traffic": "toy", "chips": 1,
                               "why": "a program that is no decode"})
    for name in ("audio_s_per_s", "device_idle_pct.loader"):
        next(m for m in bench["end_to_end"] + bench["per_layer"]
             if m["name"] == name)["workloads"].append(CELL)
    return bench


def _run(bench, cache, traced=False, **hooks):
    return run.run_cell(bench, CELL, 2**35 + 3, 0.2, traced, device="cpu",
                        t_start=time.perf_counter(), cache_root=cache, workers=1,
                        programs=os.path.join(HERE, "programs"), **hooks)


@pytest.mark.parametrize("traced", [False, True])
def test_a_program_named_by_its_configuration_runs_through_the_loop(toy, cache, traced,
                                                                    monkeypatch):
    assert not any(key in traffic.load_mix("toy") for key in DECODE_KEYS)
    seen = []
    real = run.reader

    def keeping(name):
        read = real(name)

        def f(r):
            seen.append(r)
            return read(r)
        return f

    monkeypatch.setattr(run, "reader", keeping)
    r = _run(toy, cache, traced)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r) == want + (["breakdown", "checks"] if traced else ["checks"])
    assert r["correct"] is True and r["failed"] == 0 and list(r["checks"]) == ["max_abs"]
    call_s = MIX["block_frames"] * MIX["blocks_per_call"] / 16000
    ran = seen[0]
    assert ran.audio_s == pytest.approx(r["attempted"] * call_s)
    if traced:
        assert ran.trace.calls == 2 and ran.trace.audio_s == pytest.approx(2 * call_s)
        assert ran.trace.files == [[], []]
        assert set(r["device"]) >= {"busy_s", "window_s"}
    else:
        assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}
        assert r["metrics"]["audio_s_per_s"]["value"] == pytest.approx(ran.audio_s / ran.wall_s)


def test_a_fault_in_the_toy_programs_output_is_not_correct(toy, cache):
    def click(pcm):
        pcm = pcm.clone()
        pcm[100, 0] += 0.25
        return pcm

    r = _run(toy, cache, alter=click)
    assert r["correct"] is False
    assert r["checks"]["max_abs"]["value"] > r["checks"]["max_abs"]["limit"]


def test_a_program_that_is_not_there_is_refused():
    with pytest.raises(FileNotFoundError):
        run.program({"program": "sine_blocks"})
    assert run.program({}).__name__ == "h100bench.programs.decode"
    assert run.program({"program": "sine_blocks"}, os.path.join(HERE, "programs")).pieces(
        {}, MIX) == []

"""The harness: BENCHMARK.json against the contract's rules, every piece
found by name, the result line's keys, and the exits without a card."""

import json
import math
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from h100bench import run, traffic
from h100bench.tests.conftest import ROOT, SMALL, small_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = run.load_benchmark()


def test_benchmark_json_follows_the_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["paths"] == ["h100bench"] and 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "-m", "h100bench.run"]
    assert all(len(c) <= 200 for c in BENCH["command"])
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100bench/") and NAME.match(c["name"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and all(k in cfg for k in c["reduced"])
        names.add(c["name"])
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        cells.add(w["name"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    # at most a quarter of the cells, rounded down, on four cards; one always may
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and NAME.match(m["name"])
        for w in m["workloads"]:
            # every listed cell reports the metric the layer moves
            assert any(e["name"] == m["moves"] and w in e.get("workloads", [w])
                       for e in BENCH["end_to_end"])
    for cell in cells:
        c = next(w for w in BENCH["workloads"] if w["name"] == cell)
        assert len(run.cell_metrics(BENCH, c, False)) >= 2
        assert len(run.cell_metrics(BENCH, c, True)) >= 1


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_is_found_by_name(cell):
    c, config, mix = run.cell_parts(BENCH, cell)
    assert os.path.exists(os.path.join(ROOT, "h100bench", "inputs", f"{config['maker']}.py"))
    assert os.path.exists(os.path.join(SMALL, f"{cell}.json"))
    assert all(key in mix for key in ("warmup_calls", "check_calls", "trace_skip", "trace_calls"))
    for piece in run.program(config).pieces(config, mix):
        assert os.path.exists(os.path.join(ROOT, piece)), piece
    for m in run.cell_metrics(BENCH, c, False) + run.cell_metrics(BENCH, c, True):
        assert callable(run.reader(m["name"]))


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["librispeech-flac.loader", "fma-mp3.single"])
def test_the_result_line_has_the_contract_keys(cell, traced, cache):
    r = small_run(BENCH, cell, cache, traced)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if traced else ["checks"]
    assert list(r) == want
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert all(len(r["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))
    else:
        assert set(r["metrics"]) == {m["name"] for m in run.cell_metrics(
            BENCH, next(w for w in BENCH["workloads"] if w["name"] == cell), False)}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


def test_without_a_card_it_exits_nonzero_and_prints_nothing():
    p = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", "fma-mp3.single",
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_jax_loaded_after_the_window_refuses_the_result(monkeypatch, cache, capsys):
    """A reader (or anything after the window) that loads a module named jax
    leaves no result line: the look comes just before the line."""
    real = run.reader

    def loading(name):
        read = real(name)

        def f(r):
            sys.modules.setdefault("jax", type(sys)("jax"))
            return read(r)
        return f

    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.setattr(run, "reader", loading)
    try:
        result = small_run(BENCH, "librispeech-flac.loader", cache)
        assert "jax" in sys.modules
        capsys.readouterr()
        assert run.emit(result) == 3
        out = capsys.readouterr()
        assert out.out == "" and "jax" in out.err
    finally:
        sys.modules.pop("jax", None)
    assert run.emit(result) == 0 and json.loads(capsys.readouterr().out)["correct"] is True


def test_the_schedule_shuffles_without_repeats_and_repeats_by_seed():
    inputs = SimpleNamespace(blobs=[bytes([i]) * 8 for i in range(12)],
                             info=[{"frame_offsets": [0, 2, 4, 6]} for _ in range(12)])
    mix = {"files_per_call": 4}
    a, b = traffic.Schedule(mix, inputs, 7), traffic.Schedule(mix, inputs, 7)
    assert [a.files(k) for k in range(6)] == [b.files(k) for k in range(6)]
    assert sorted(sum((a.files(k) for k in range(3)), [])) == list(range(12))
    assert a.files(3) == a.files(0) and a.blobs(1) == [inputs.blobs[i] for i in a.files(1)]
    assert [a.files(k) for k in range(3)] != [traffic.Schedule(mix, inputs, 8).files(k)
                                              for k in range(3)]


def test_rotated_copies_keep_the_frames_and_never_repeat_bytes():
    frames = [bytes([f]) * (3 + f % 2) for f in range(40)]
    blob = b"".join(frames)
    offsets = list(np.cumsum([0] + [len(f) for f in frames[:-1]]))
    inputs = SimpleNamespace(blobs=[blob, blob[::-1]], info=[{"frame_offsets": offsets}] * 2)
    mix = {"files_per_call": 1, "rotate_frames": True, "prepared_calls": 6}
    s = traffic.Schedule(mix, inputs, 2**40 + 1)
    seen = [s.blobs(k)[0] for k in range(6)]
    assert len(set(seen)) == 6 and s.blobs(6) == s.blobs(0) and s.files(7) == s.files(1)
    for k in range(6):
        if s.files(k) == [0]:   # frame f of file 0 is f's byte, 3 or 4 times
            at = offsets[seen[k][0]]
            assert seen[k] == blob[at:] + blob[:at]


def test_the_reservoir_keeps_a_seeded_uniform_sample():
    picks = []
    for seed in range(400):
        r = traffic.Reservoir(2, seed)
        for k in range(10):
            r.offer(k, k)
        assert len(r.kept) == 2
        picks += list(r.kept)
    counts = [picks.count(k) for k in range(10)]
    assert min(counts) > 40 and max(counts) < 125 and math.isclose(sum(counts), 800)

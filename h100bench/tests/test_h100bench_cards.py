"""A cell on several cards: each device event keeps its card, busy time and
idle gaps are read per card and averaged, one card reads as the single
timeline did, and the loop hands the program every card and reads every
card's sync and peak.  The toy program ``programs/sine_blocks.py`` deals
its blocks to the cards: on the CPU, to CPU "cards"; on the card (marker
``cuda``), to every card there is, or twice to one."""

import bisect
import json
import os
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest

from h100bench import run, traffic
from h100bench import trace as trace_mod
from h100bench.inputs import Inputs
from h100bench.tests.conftest import small
from h100bench.trace import Trace

BENCH = run.load_benchmark()
HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "toy-sine.cards"
MIX = {"block_frames": 256, "blocks_per_call": 4, "warmup_calls": 1, "check_calls": 3,
       "trace_skip": 1, "trace_calls": 2}


# the single timeline of every device event, as the harness read it before
# events kept their cards: the one-card readings are held to it to the digit
def _timeline_busy(tr):
    out = []
    for _, a, b in sorted(tr.device, key=lambda e: e[1]):
        a, b = max(a, tr.start), min(b, tr.end)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _timeline_busy_s(tr):
    return sum(b - a for a, b in _timeline_busy(tr)) / 1e6


def _timeline_idle_gaps(tr, n=10):
    busy = _timeline_busy(tr)
    edges = [tr.start] + [x for ab in busy for x in ab] + [tr.end]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    spans = sorted(tr.ranges, key=lambda r: r[1])
    starts = [s for _, s, _ in spans]
    tot = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name, best = "host", -np.inf
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            rn, rs, re = spans[j]
            if re >= mid and rs > best:
                name, best = rn, rs
                break
        tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _timeline_top_ops(tr, n=10):
    tot = {}
    for name, a, b in tr.device:
        tot[name[:160]] = tot.get(name[:160], 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _inputs():
    return Inputs(names=["a", "b"], ext="flac", blobs=[b"", b""],
                  info=[{"frames": 10}, {"frames": 30}], sample_rate=16000, channels=1)


def test_busy_and_idle_are_read_per_card_and_averaged():
    device = [("k", 10.0, 30.0, 0), ("k", 20.0, 40.0, 1),   # overlap on two cards: not merged
              ("k", 25.0, 35.0, 0),                         # overlap on one card: merged
              ("window_add_main<float, 64>", 60.0, 70.0, 1)]
    ranges = [("h100bench.call", 0.0, 100.0), ("flac.walk", 40.0, 60.0)]
    tr = Trace(device=device, ranges=ranges, start=0.0, end=100.0, calls=1, files=[[0, 1]],
               audio_s=2.0, cards=(0, 1))
    assert tr.busy(0) == [(10.0, 35.0)] and tr.busy(1) == [(20.0, 40.0), (60.0, 70.0)]
    assert tr.busy_s_per_card == pytest.approx([25e-6, 30e-6])
    assert tr.busy_s == pytest.approx(27.5e-6)
    r = SimpleNamespace(trace=tr, inputs=_inputs())
    assert run.reader("device_idle_pct.loader")(r) == pytest.approx(72.5)
    # card 0 idle 0-10, 35-100 (midpoints in the call, the call, 67.5 the call);
    # card 1 idle 0-20, 40-60 (the walk), 70-100: each halved
    gaps = dict(tr.idle_gaps())
    assert gaps["flac.walk"] == pytest.approx(20e-6 / 2)
    assert gaps["h100bench.call"] == pytest.approx((10 + 65 + 20 + 30) * 1e-6 / 2)
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)
    # counts and kernel times sum over the cards
    assert run.reader("device_ops_per_audio_s.loader")(r) == pytest.approx(4 / 2.0)
    assert tr.kernel_s(lambda name: name == "k") == pytest.approx(50e-6)
    assert dict(tr.top_ops())["k"] == pytest.approx(50e-6)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_one_card_reads_what_the_single_timeline_read(seed):
    rng = random.Random(seed)
    names = ["k_a", "Memcpy HtoD (Pageable -> Device)", "window_add_main<float, 64>",
             "window_add2_main<int>", "mp3_synth_kernel", "flac_predict_kernel"]
    plain = []
    for _ in range(400):
        a = rng.uniform(-50.0, 10_000.0)
        plain.append((rng.choice(names), a, a + rng.expovariate(1 / 30.0)))
    ranges = []
    for _ in range(60):
        a = rng.uniform(0.0, 9_000.0)
        ranges.append((rng.choice(["h100bench.call", "flac.walk", "flac.h2d", "mp3.wire"]),
                       a, a + rng.uniform(1.0, 800.0)))
    common = dict(ranges=ranges, start=0.0, end=9_500.0, calls=3, files=[[0], [1], [0, 1]],
                  audio_s=3.5)
    old = SimpleNamespace(device=plain, **common)
    tr = Trace(device=[(*e, 0) for e in plain], **common)
    assert tr.busy(0) == _timeline_busy(old)
    assert tr.busy_s == _timeline_busy_s(old) and tr.busy_s_per_card == [tr.busy_s]
    assert tr.idle_gaps() == _timeline_idle_gaps(old)
    assert tr.top_ops() == _timeline_top_ops(old)
    r = SimpleNamespace(trace=tr, inputs=_inputs())
    assert run.reader("device_idle_pct.loader")(r) == 100.0 * (1.0 - _timeline_busy_s(old)
                                                              / tr.window_s)
    for name in ("k3_roofline_pct", "k4_roofline_pct", "device_ops_per_audio_s.loader",
                 "device_ops_per_request.single"):
        old_r = SimpleNamespace(trace=Trace(device=[(*e, 0) for e in plain], **common),
                                inputs=_inputs())
        assert run.reader(name)(r) == run.reader(name)(old_r)


def test_from_profile_keeps_each_events_card():
    from torch.autograd import DeviceType

    def ev(name, a, b, kind, index=0, user=False):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                               device_type=kind, device_index=index, is_user_annotation=user)

    events = [ev("h100bench.stretch", 0.0, 100.0, DeviceType.CPU, user=True),
              ev("decode.call", 1.0, 90.0, DeviceType.CPU, user=True),
              ev("decode.call", 1.0, 90.0, DeviceType.CUDA, 1, user=True),   # a range, no work
              ev("k", 5.0, 15.0, DeviceType.CUDA, 0), ev("k", 5.0, 25.0, DeviceType.CUDA, 3),
              ev("aten::add", 2.0, 3.0, DeviceType.CPU)]
    prof = SimpleNamespace(events=lambda: events)
    tr = trace_mod.from_profile(prof, 1, [[]], 1.0, (0, 3))
    assert tr.device == [("k", 5.0, 15.0, 0), ("k", 5.0, 25.0, 3)]
    assert tr.ranges == [("decode.call", 1.0, 90.0)] and tr.cards == (0, 3)
    assert tr.busy_s_per_card == pytest.approx([10e-6, 20e-6])


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """BENCHMARK.json with a toy cell on two cards that drives
    ``programs/sine_blocks.py``, ``audio_s_per_s`` and the idle share reported."""
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
    bench["workloads"].append({"name": CELL, "config": "toy-sine", "traffic": "toy", "chips": 2,
                               "why": "a program on several cards"})
    for name in ("audio_s_per_s", "device_idle_pct.loader"):
        next(m for m in bench["end_to_end"] + bench["per_layer"]
             if m["name"] == name)["workloads"].append(CELL)
    return bench


def _run(bench, cache, traced, device, cards=None):
    return run.run_cell(bench, CELL, 2**35 + 7, 0.2, traced, device=device, cards=cards,
                        t_start=time.perf_counter(), cache_root=cache, workers=1,
                        programs=os.path.join(HERE, "programs"))


def _keeping_records(monkeypatch):
    seen = []
    real = run.reader

    def keeping(name):
        read = real(name)

        def f(r):
            seen.append(r)
            return read(r)
        return f

    monkeypatch.setattr(run, "reader", keeping)
    return seen


@pytest.mark.parametrize("traced", [False, True])
def test_a_two_card_run_hands_the_program_both_cards_and_reads_each(toy, cache, traced,
                                                                    monkeypatch):
    synced, peaked = [], []
    monkeypatch.setattr(run, "sync_card", synced.append)
    monkeypatch.setattr(run, "card_peak",
                        lambda card: peaked.append(card) or 1000 * len(peaked) + 1)
    real = trace_mod.from_profile

    def two_cards(prof, calls, files, audio_s, cards):
        assert cards == (0, 0)                      # two CPU "cards", one device index
        tr = real(prof, calls, files, audio_s, cards)
        tr.device += [("k", tr.start + 1.0, tr.start + 3.0, 0),
                      ("k", tr.start + 2.0, tr.start + 6.0, 1)]
        tr.cards = (0, 1)
        return tr

    monkeypatch.setattr(trace_mod, "from_profile", two_cards)
    seen = _keeping_records(monkeypatch)
    r = _run(toy, cache, traced, "cpu")
    assert synced == ["cpu", "cpu"] and peaked == ["cpu", "cpu"]   # once per card
    assert r["correct"] is True and r["device"]["count"] == 2
    assert r["device"]["memory_peak_bytes_per_card"] == [1001, 2001]
    assert r["device"]["memory_peak_bytes"] == 2001
    assert all(rec.cards == ["cpu", "cpu", "cpu", "cpu"] for rec in seen[0].calls)
    if traced:
        assert r["device"]["busy_s_per_card"] == pytest.approx([2e-6, 4e-6])
        assert r["device"]["busy_s"] == pytest.approx(3e-6)
    else:
        assert "busy_s_per_card" not in r["device"]


class _Stop(Exception):
    pass


def test_a_one_card_cell_gets_its_device_alone(monkeypatch):
    got = []

    def start(*a, **k):
        got.append((a, k))
        raise _Stop

    monkeypatch.setattr(run, "program", lambda config, where: SimpleNamespace(start=start))
    monkeypatch.setattr(run.pool, "load", lambda config, root, workers: (_inputs(), False))
    with pytest.raises(_Stop):
        run.run_cell(BENCH, "fma-mp3.single", 1, 0.1, False, device="cpu")
    assert got[0][0][4] == "cpu" and got[0][1] == {}          # no ``cards``, as before
    assert run.cell_cards("cuda", 1) == ["cuda"]
    assert run.cell_cards("cuda", 4) == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert run.cell_cards("cpu", 4) == ["cpu"] * 4


@pytest.mark.cuda
def test_on_the_card_each_card_reports_its_peak_and_busy_time(toy, cache):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n = torch.cuda.device_count()
    cards = [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0", "cuda:0"]
    r = _run(toy, cache, True, "cuda", cards)
    dev = r["device"]
    print(json.dumps({"cards": cards, "device": dev}))
    assert r["correct"] is True and dev["count"] == len(cards) and dev["platform"] == "gpu"
    assert len(dev["memory_peak_bytes_per_card"]) == len(cards) == len(dev["busy_s_per_card"])
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_per_card"]) > 0
    assert all(b > 0 for b in dev["busy_s_per_card"])
    assert dev["busy_s"] == pytest.approx(sum(dev["busy_s_per_card"]) / len(cards))

"""The reader of ``engine_graph_pct.live``: the program tracer's
``engine.graph_replay`` items over its ``engine.burst`` items, in %; nothing
where the program keeps no replay counter (an earlier version, or a loop off
the card) or rendered nothing."""

from collections import defaultdict
from types import SimpleNamespace

import pytest

from audio_decoder_tpu_torch.utils import trace
from h100bench import run

NAME = "engine_graph_pct.live"


@pytest.fixture
def stats(monkeypatch):
    """The program tracer's counters, fresh for the test."""
    fresh = defaultdict(trace.StageStat)
    monkeypatch.setattr(trace.TRACE, "stats", fresh)
    return fresh


def _count(stats, name, calls, items):
    stats[name] = trace.StageStat(calls=calls, items=items)


def test_the_share_of_blocks_a_replay_rendered(stats):
    _count(stats, "engine.burst", 12, 90.0)
    _count(stats, "engine.graph_replay", 12, 90.0)
    _count(stats, "engine.graph_capture", 4, 0.0)
    assert run.reader(NAME)(SimpleNamespace(trace=None)) == 100.0
    _count(stats, "engine.graph_replay", 9, 45.0)
    assert run.reader(NAME)(SimpleNamespace(trace=None)) == pytest.approx(50.0)


def test_no_replay_counter_or_no_burst_reads_none(stats):
    _count(stats, "engine.burst", 12, 90.0)
    assert run.reader(NAME)(SimpleNamespace(trace=None)) is None   # the parent, or the CPU
    stats.clear()
    _count(stats, "engine.graph_replay", 1, 8.0)
    assert run.reader(NAME)(SimpleNamespace(trace=None)) is None

"""The readers of the program's own spans and counters (``h100bench/program.py``
and the metrics that use it): on a hand-made trace and a reset tracer, on a
program that keeps none of them, and in a traced CPU run of the MP3 cells."""

from types import SimpleNamespace

import pytest

from h100bench import program, run
from h100bench.tests.conftest import small_run
from h100bench.trace import Trace

BENCH = run.load_benchmark()
SPAN_READERS = ("mp3_walk_ms", "mp3_wire_ms", "decode_assembly_ms", "flac_walk_ms")
DEVICE_READERS = ("mp3_requantize_device_ms", "mp3_stereo_device_ms", "mp3_imdct_device_ms")
COUNTER_READERS = ("host_syncs_per_call", "h2d_mb_per_call")


@pytest.fixture
def tracer():
    from audio_decoder_tpu_torch.utils.trace import TRACE

    TRACE.reset()
    yield TRACE
    TRACE.reset()


def _run(ranges, calls=2):
    tr = Trace(device=[], ranges=ranges, start=0.0, end=1e6, calls=calls,
               files=[[0]] * calls, audio_s=1.0)
    return SimpleNamespace(trace=tr)


class _Event:
    def __init__(self, ms=0.0):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return self.ms


def test_the_span_readers_sum_their_ranges_per_call():
    r = _run([("h100bench.call", 0.0, 9e5), ("decode.call.7", 1.0, 8e5),
              ("decode.route", 2.0, 1002.0), ("mp3.walk", 1e3, 5e3), ("mp3.walk", 6e3, 8e3),
              ("mp3.wire", 8e3, 9e3), ("decode.assemble", 7e5, 7.5e5),
              ("flac.walk", 1e4, 3e4)])
    # times in microseconds; 2 calls
    assert run.reader("mp3_walk_ms.loader")(r) == pytest.approx(3.0)
    assert run.reader("mp3_wire_ms.single")(r) == pytest.approx(0.5)
    assert run.reader("decode_assembly_ms.single")(r) == pytest.approx((1e3 + 5e4) / 2e3)
    assert run.reader("flac_walk_ms.loader")(r) == pytest.approx(10.0)
    bare = _run([("h100bench.call", 0.0, 9e5)])
    for stem in SPAN_READERS:
        assert run.reader(stem)(bare) is None
        assert run.reader(stem)(SimpleNamespace(trace=None)) is None


def test_the_counter_readers_divide_by_the_processs_calls(tracer):
    r = _run([])
    for stem in COUNTER_READERS:
        assert run.reader(stem)(r) is None      # no decode call counted yet
    tracer.stats["decode.call"].calls = 4
    assert run.reader("host_syncs_per_call.single")(r) == 0.0
    tracer.count("sync")
    for _ in range(99):
        tracer.count("sync")
    tracer.count("h2d", 6e6)
    tracer.count("h2d", 2e6)
    assert run.reader("host_syncs_per_call.loader")(r) == pytest.approx(25.0)
    assert run.reader("h2d_mb_per_call.loader")(r) == pytest.approx(2.0)


def test_the_device_readers_resolve_the_event_pairs_per_traced_call(tracer):
    r = _run([], calls=4)
    for stem in DEVICE_READERS:
        assert run.reader(stem)(r) is None      # no pairs: a CPU run
    tracer.events["mp3.imdct"] += [(_Event(3.0), _Event()), (_Event(5.0), _Event())]
    tracer.events["mp3.stereo"].append((_Event(2.0), _Event()))
    assert run.reader("mp3_imdct_device_ms.loader")(r) == pytest.approx(2.0)
    assert run.reader("mp3_stereo_device_ms.loader")(r) == pytest.approx(0.5)
    assert run.reader("mp3_requantize_device_ms.loader")(r) is None
    # resolved once, read again
    assert run.reader("mp3_imdct_device_ms.loader")(r) == pytest.approx(2.0)


def test_a_program_without_spans_or_counters_reads_none(monkeypatch):
    monkeypatch.setattr(program, "_tracer", lambda: SimpleNamespace(stats={}))
    r = _run([("h100bench.call", 0.0, 9e5)])
    for stem in SPAN_READERS + DEVICE_READERS + COUNTER_READERS:
        assert run.reader(stem)(r) is None, stem
    monkeypatch.setattr(program, "_tracer", lambda: None)
    for stem in DEVICE_READERS + COUNTER_READERS:
        assert run.reader(stem)(r) is None, stem


@pytest.mark.parametrize("cell", ["fma-mp3.single", "fma-mp3.loader"])
def test_a_traced_cpu_run_reports_the_span_and_counter_metrics(cell, cache, tracer):
    r = small_run(BENCH, cell, cache, traced=True)
    assert r["correct"] is True
    split = cell.split(".")[1]
    for stem in ("mp3_walk_ms", "mp3_wire_ms", "decode_assembly_ms"):
        assert r["metrics"][f"{stem}.{split}"]["value"] > 0, stem
    assert r["metrics"][f"host_syncs_per_call.{split}"]["value"] == 0.0   # the CPU never syncs
    assert r["metrics"][f"h2d_mb_per_call.{split}"]["value"] > 0
    # the device readers find no CUDA events on the CPU
    assert not any("device_ms" in name for name in r["metrics"])
    # the idle gaps fall in the program's spans, not in the harness's call
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps and all(not name.startswith("h100bench.") for name in gaps)

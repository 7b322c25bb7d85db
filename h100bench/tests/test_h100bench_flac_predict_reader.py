"""The reader of ``flac_predict_device_ms.loader``: the device time of the
program's ``flac.predict`` spans per traced call, from its CUDA event
pairs, and nothing where the program recorded none."""

from types import SimpleNamespace

import pytest

from h100bench import program, run
from h100bench.trace import Trace

NAME = "flac_predict_device_ms.loader"


@pytest.fixture
def tracer():
    from audio_decoder_tpu_torch.utils.trace import TRACE

    TRACE.reset()
    yield TRACE
    TRACE.reset()


class _Event:
    def __init__(self, ms=0.0):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return self.ms


def _run(calls):
    tr = Trace(device=[], ranges=[("flac.predict", 1.0, 2.0)], start=0.0, end=1e6,
               calls=calls, files=[[0]] * calls, audio_s=1.0)
    return SimpleNamespace(trace=tr)


def test_event_pairs_give_the_device_time_per_traced_call(tracer):
    tracer.events["flac.predict"] += [(_Event(0.125), _Event()), (_Event(0.375), _Event())]
    tracer.events["flac.rice_scan"].append((_Event(9.0), _Event()))
    assert run.reader(NAME)(_run(calls=2)) == pytest.approx(0.25)


def test_a_run_without_event_pairs_reads_none(tracer, monkeypatch):
    assert run.reader(NAME)(_run(calls=2)) is None      # a CPU run, or the parent's span
    assert run.reader(NAME)(SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(program, "_tracer", lambda: SimpleNamespace(stats={}))
    assert run.reader(NAME)(_run(calls=2)) is None      # a program without device_ms

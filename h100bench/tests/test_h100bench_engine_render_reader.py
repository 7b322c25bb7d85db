"""The reader of ``engine_render_device_us_per_block.live``: the union of the
device events each ``engine.render.<depth>`` range launched, from its start
to the end of the ``engine.fetch`` after it, the fetch's device-to-host copy
left out, over the blocks issued; nothing where the stretch holds no such
range or no device event."""

from types import SimpleNamespace

import pytest

from h100bench import engine_spans, run
from h100bench.trace import Trace

NAME = "engine_render_device_us_per_block.live"
COPY = "Memcpy DtoH (Device -> Pageable)"


def _run(ranges, device):
    tr = Trace(device=[(*e, 0) for e in device], ranges=ranges, start=0.0, end=1000.0, calls=1, files=[[]],
               audio_s=1.0)
    return SimpleNamespace(trace=tr)


def test_the_render_owns_its_launches_up_to_the_fetchs_end():
    ranges = [("engine.apply", 0.0, 10.0), ("engine.render.1", 10.0, 60.0),
              ("engine.fetch", 60.0, 90.0), ("engine.sink", 90.0, 92.0),
              ("engine.render.2", 100.0, 300.0), ("engine.fetch", 300.0, 340.0),
              ("engine.status", 400.0, 410.0)]
    device = [("apply_kernel", 5.0, 12.0),        # launched before the render began
              ("k", 20.0, 25.0), ("k", 24.0, 30.0), ("k", 70.0, 80.0),   # the last in the fetch
              (COPY, 85.0, 88.0),
              ("k", 150.0, 160.0), ("Memcpy HtoD (Pageable -> Device)", 170.0, 171.0),
              (COPY, 330.0, 333.0),
              ("status_kernel", 395.0, 396.0), (COPY, 405.0, 406.0)]
    r = _run(ranges, device)
    assert engine_spans.render_device_us(r.trace) == (10.0 + 10.0 + 10.0 + 1.0, 6.0)
    assert run.reader(NAME)(r) == pytest.approx(31.0 / 3)


def test_a_stretch_without_render_ranges_or_device_events_reads_none():
    ranges = [("engine.render.1", 10.0, 60.0), ("engine.fetch", 60.0, 90.0)]
    assert run.reader(NAME)(_run(ranges, [])) is None            # a CPU run
    assert run.reader(NAME)(_run([("h100bench.call", 0.0, 90.0)], [("k", 1.0, 2.0)])) is None
    assert run.reader(NAME)(SimpleNamespace(trace=None)) is None

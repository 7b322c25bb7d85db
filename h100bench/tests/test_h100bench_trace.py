"""The trace reductions on a hand-made trace: busy time as a union, idle
gaps by the innermost host range, and the readers on top of them."""

from types import SimpleNamespace

import pytest

from h100bench import run
from h100bench.inputs import Inputs
from h100bench.trace import Trace


def _trace():
    device = [("k_a", 10.0, 20.0, 0), ("memcpy", 15.0, 25.0, 0),   # overlap: counted once
              ("window_add2_main<int>", 40.0, 44.0, 0), ("window_add_main<float, 64>", 50.0, 52.0, 0),
              ("k_b", 95.0, 130.0, 0)]                           # cut at the stretch's end
    ranges = [("h100bench.call", 0.0, 100.0), ("flac.rice_scan", 26.0, 39.0),
              ("flac.predict", 60.0, 90.0)]
    return Trace(device=device, ranges=ranges, start=0.0, end=100.0, calls=2,
                 files=[[0], [1]], audio_s=4.0)


def test_busy_is_the_union_of_the_device_intervals():
    tr = _trace()
    assert tr.busy(0) == [(10.0, 25.0), (40.0, 44.0), (50.0, 52.0), (95.0, 100.0)]
    assert tr.busy_s == pytest.approx(26e-6) and tr.window_s == pytest.approx(100e-6)


def test_idle_gaps_go_to_the_innermost_open_range():
    gaps = dict(_trace().idle_gaps())
    # 0-10 and 44-50 and 52-60 sit in the call only; 25-40 in the rice scan
    # (midpoint 32.5); 52-95 has its midpoint 73.5 in the predictor
    assert gaps["flac.rice_scan"] == pytest.approx(15e-6)
    assert gaps["flac.predict"] == pytest.approx(43e-6)
    assert gaps["h100bench.call"] == pytest.approx(16e-6)


def test_the_readers_read_the_trace():
    tr = _trace()
    r = SimpleNamespace(trace=tr, inputs=Inputs(names=["a", "b"], ext="flac", blobs=[b"", b""],
                                                 info=[{"frames": 10}, {"frames": 30}],
                                                 sample_rate=16000, channels=1))
    assert run.reader("device_idle_pct.loader")(r) == pytest.approx(74.0)
    assert run.reader("device_ops_per_audio_s.loader")(r) == pytest.approx(5 / 4.0)
    assert run.reader("device_ops_per_request.single")(r) == pytest.approx(2.5)
    assert run.reader("flac_rice_scan_ms.loader")(r) == pytest.approx(13e-6 / 2 * 1e3)
    assert run.reader("flac_predict_ms.loader")(r) == pytest.approx(30e-6 / 2 * 1e3)
    k3 = 8 * 40 / 3.35e12 / 2e-6 * 100
    assert run.reader("k3_roofline_pct")(r) == pytest.approx(k3)
    assert run.reader("k4_roofline_pct")(r) == pytest.approx(8 * 40 / 3.35e12 / 4e-6 * 100)
    assert run.reader("k1_roofline_pct")(r) is None and run.reader("k2_roofline_pct")(r) is None


def test_a_run_without_a_trace_reads_no_layer():
    r = SimpleNamespace(trace=None)
    for name in ("device_idle_pct.single", "k1_roofline_pct", "flac_predict_ms.loader"):
        assert run.reader(name)(r) is None

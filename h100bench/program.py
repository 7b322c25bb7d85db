"""The program's own spans and counters, as the per-layer metrics read them.

The program opens profiler ranges inside ``decode_assets`` (``decode.call``,
``decode.route``, ``mp3.walk``, ``flac.walk``, ...), which the traced
stretch holds beside the harness's own, and keeps counters and device times
in its tracer, ``audio_decoder_tpu_torch.utils.trace.TRACE``: ``sync`` (host
syncs), ``h2d`` (host-to-device copies, items in bytes), ``decode.call``
(calls of ``decode_assets``) and ``TRACE.device_ms(span)``.  A program that
has none of them (an earlier version) leaves each reader None.
"""

from __future__ import annotations


def host_ms(run, *names: str) -> float | None:
    """Host milliseconds per traced call inside the program's ranges
    ``names``, summed; None where the stretch holds none of them."""
    tr = run.trace
    if tr is None or not any(n in names for n, _, _ in tr.ranges):
        return None
    return sum(tr.range_s(n) for n in names) / tr.calls * 1e3


def _tracer():
    try:
        from audio_decoder_tpu_torch.utils.trace import TRACE
    except ImportError:
        return None
    return TRACE


def per_call(counter: str, field: str) -> float | None:
    """The counter's ``calls`` or ``items`` over the process's calls of
    ``decode_assets`` (the harness runs one cell per process); None where
    the program counts no calls."""
    trace = _tracer()
    calls = getattr(trace, "stats", {}).get("decode.call")
    if calls is None or calls.calls == 0:
        return None
    stat = trace.stats.get(counter)
    return (getattr(stat, field) if stat is not None else 0.0) / calls.calls


def device_ms(run, name: str) -> float | None:
    """Device milliseconds per traced call inside the span ``name``, from
    the CUDA event pairs the program records under a profiler; None where
    it recorded none (on the CPU, or in a program without them)."""
    read = getattr(_tracer(), "device_ms", None)
    tr = run.trace
    if read is None or tr is None:
        return None
    ms = read(name)
    return None if ms is None else ms / tr.calls

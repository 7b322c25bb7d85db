"""The live loop's spans and counters, as the per-layer metrics read them.

The port's ``EngineLoop.run_blocks`` opens profiler ranges ``engine.apply``,
``engine.render.<depth>`` (a block or a burst of ``depth`` blocks issued),
``engine.fetch``, ``engine.sink`` and ``engine.status``, records CUDA event
pairs on ``engine.render`` under a profiler (``TRACE.device_ms``), and
counts ``engine.block``, ``engine.burst``, ``engine.discard`` and
``engine.command`` beside ``sync``.  The live program's records carry each
counter's change over the call.  A program without them (an earlier
version) leaves every reader None.

The render's device time comes from the trace's device events, not from
the event pairs: while the host issues a burst's launches more slowly than
the card runs them, a pair around the burst spans the stream's idle gaps
and reads the host's pace.  Each ``engine.render.<depth>`` range owns the
device events that start between its own start and the end of the
``engine.fetch`` range after it.  The host issues nothing else there but
the fetch's device-to-host copy, and the fetch waits for the burst's last
work, so those events are the burst's work and the fetch's copy.
"""

from __future__ import annotations

import bisect

RENDER = "engine.render."


def rendered(tr) -> int | None:
    """Blocks issued in the traced stretch: the depths of its
    ``engine.render.<depth>`` ranges; None where it holds none."""
    if tr is None:
        return None
    n = sum(int(name[len(RENDER):]) for name, _, _ in tr.ranges if name.startswith(RENDER))
    return n or None


def range_us(tr, name: str) -> float:
    """Host microseconds in the stretch's ranges ``name`` or ``name.<...>``."""
    return sum(b - a for n, a, b in tr.ranges if n == name or n.startswith(name + "."))


def per_block(run, name: str) -> float | None:
    """Host microseconds in the ranges ``name`` per block issued in the stretch."""
    blocks = rendered(run.trace)
    return None if blocks is None else range_us(run.trace, name) / blocks


def counted(run, counter: str, field: int) -> float:
    """A counter's calls (``field`` 0) or items (1) over the window's calls."""
    return float(sum(getattr(r, "counts", {}).get(counter, (0, 0.0))[field]
                     for r in run.calls))


def _is_fetch_copy(name: str) -> bool:
    """A device-to-host copy (the profiler names it ``Memcpy DtoH (...)``)."""
    return "DtoH" in name


def _union_us(spans: list[tuple[float, float]]) -> float:
    total, reach = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def render_device_us(tr) -> tuple[float, float] | None:
    """(device µs of the bursts' work, device µs of their fetches' copies)
    over the stretch, each the union of its events' intervals; None where
    the stretch holds no ``engine.render.<depth>`` range."""
    if tr is None:
        return None
    renders = sorted((a, b) for n, a, b in tr.ranges if n.startswith(RENDER))
    if not renders:
        return None
    fetches = sorted((a, b) for n, a, b in tr.ranges if n == "engine.fetch")
    fetch_starts = [a for a, _ in fetches]
    events = sorted((a, b, n) for n, a, b, _ in tr.device)
    starts = [a for a, _, _ in events]
    work, copies = [], []
    for a, b in renders:
        j = bisect.bisect_left(fetch_starts, b)
        end = fetches[j][1] if j < len(fetches) else tr.end
        for ea, eb, name in events[bisect.bisect_left(starts, a):bisect.bisect_right(starts, end)]:
            ea, eb = max(ea, tr.start), min(eb, tr.end)
            if eb > ea:
                (copies if _is_fetch_copy(name) else work).append((ea, eb))
    return _union_us(work), _union_us(copies)

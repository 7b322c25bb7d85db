"""Stage timers and throughput counters.

``TRACE.stage(name)`` times a region on the host clock and
``TRACE.add(name, items)`` counts a stage-defined unit (the registry adds
decoded audio-seconds under ``decode/<family>``).  CUDA work is
asynchronous: a stage's time covers the device work only where the region
itself waits for it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class StageStat:
    calls: int = 0
    seconds: float = 0.0
    items: float = 0.0  # stage-defined unit (audio-sec, files, bytes…)

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


class Tracer:
    """Per-stage wall timers + counters."""

    def __init__(self):
        self.stats: dict[str, StageStat] = defaultdict(StageStat)

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stats[name]
            s.calls += 1
            s.seconds += dt
            s.items += items

    def add(self, name: str, items: float) -> None:
        self.stats[name].items += items

    def report(self) -> str:
        lines = []
        for name in sorted(self.stats):
            s = self.stats[name]
            rate = f" ({s.rate:,.1f}/s)" if s.items else ""
            lines.append(
                f"{name}: {s.calls} calls, {s.seconds * 1e3:,.1f} ms{rate}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.stats.clear()


#: process-wide tracer the decode layer reports into
TRACE = Tracer()

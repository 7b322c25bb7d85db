"""From a torch.profiler trace of a stretch of the window to what the
per-layer metrics read: device intervals, host ranges and their union.

Each device event (kernel, copy, memset) keeps the card it ran on.  A
card's busy time is the union of its events' intervals, so nothing counts
twice, and events of two cards that overlap are two cards' work.  The busy
time and the idle gaps of a run on several cards are the means over its
cards; the counts of device events and the kernels' times sum over them.
The stretch is the ``h100bench.stretch`` range the harness opens around
the profiled calls.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np


@dataclasses.dataclass
class Trace:
    """What the profiler saw over the stretch (times in microseconds)."""

    device: list[tuple[str, float, float, int]]   # (name, start, end, card)
    ranges: list[tuple[str, float, float]]        # user ranges on the host
    start: float
    end: float
    calls: int                                    # decode calls in the stretch
    files: list[list[int]]                        # each call's pool indices
    audio_s: float                                # audio-seconds decoded in it
    cards: tuple[int, ...] = (0,)                 # the cell's cards, by device index

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy(self, card: int) -> list[tuple[float, float]]:
        """The card's busy intervals, merged, inside the stretch."""
        out: list[list[float]] = []
        for _, a, b, _ in sorted((e for e in self.device if e[3] == card), key=lambda e: e[1]):
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s_per_card(self) -> list[float]:
        return [sum(b - a for a, b in self.busy(card)) / 1e6 for card in self.cards]

    @property
    def busy_s(self) -> float:
        """The cards' mean busy seconds."""
        return sum(self.busy_s_per_card) / len(self.cards)

    def kernel_s(self, match) -> float:
        """Device seconds of the events whose name ``match`` accepts."""
        return sum(b - a for n, a, b, _ in self.device if match(n)) / 1e6

    def range_s(self, name: str) -> float:
        return sum(b - a for n, a, b in self.ranges if n == name) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        """The device operations that took most time, names cut to 160
        characters (templated kernel names run to thousands)."""
        tot: dict[str, float] = {}
        for name, a, b, _ in self.device:
            tot[name[:160]] = tot.get(name[:160], 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle device time, summed by the innermost host range open at each
        gap's midpoint ("host" where none is), each card's gaps, averaged
        over the cards."""
        spans = sorted(self.ranges, key=lambda r: r[1])
        starts = [s for _, s, _ in spans]
        tot: dict[str, float] = {}
        for card in self.cards:
            busy = self.busy(card)
            edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
            gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
            for a, b in gaps:
                mid = 0.5 * (a + b)
                name, best = "host", -np.inf
                # the innermost open range is the latest-starting one holding mid
                for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                    rn, rs, re = spans[j]
                    if re >= mid and rs > best:
                        name, best = rn, rs
                        break
                tot[name] = tot.get(name, 0.0) + (b - a) / 1e6 / len(self.cards)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def from_profile(prof, calls: int, files: list[list[int]], audio_s: float,
                 cards: tuple[int, ...] = (0,)) -> Trace:
    """The stretch of ``prof``; ``cards`` are the device indices of the
    cell's cards, and each device event keeps its own (``device_index``)."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    # host ranges also appear on the device's timeline: they are no work
    host_ranges = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    device, ranges = [], []
    start = end = None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and e.name not in host_ranges:
                device.append((e.name, a, b, e.device_index))
        elif getattr(e, "is_user_annotation", False):
            if e.name == "h100bench.stretch":
                start, end = a, b
            else:
                ranges.append((e.name, a, b))
    if start is None:
        raise RuntimeError("the profile holds no h100bench.stretch range")
    return Trace(device=device, ranges=ranges, start=start, end=end,
                 calls=calls, files=files, audio_s=audio_s, cards=tuple(cards))

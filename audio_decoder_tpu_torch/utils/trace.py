"""Spans, counters and the decode layer's tracer ``TRACE``.

``span(name, device=None)`` times one region of the program:

* always, its host wall time goes to ``TRACE.stats[name]`` (what
  ``cli decode --stats`` prints);
* only while a torch profiler records, it also opens
  ``record_function(name)``, so the region lands on the profiler's clock
  beside the device events, and, for a CUDA ``device``, records a timing
  event pair on the current stream around it.  ``TRACE.device_ms(name)``
  resolves the pairs when read, after the work; nothing is resolved during
  a call.

With no profiler a span costs one flag check and the stat.  Names are
dotted (``decode.call``, ``mp3.walk``, ``flac.rice_scan``, ...).

Counters, kept in ``TRACE.stats`` beside the spans:

* ``h2d``: every host-to-device copy of the decode routes goes through
  ``to_device(array, device)``: calls are copies, items are bytes;
* ``sync``: host syncs.  A blocking copy to a CUDA device is one, and so is
  every device-to-host fetch, which goes through ``to_host(tensor)``.

``TRACE.add(name, items)`` counts a stage-defined unit: each family's
``decode_group`` adds its decoded audio-seconds under ``decode.<family>``,
from the host metadata it holds.  CUDA work is asynchronous: a span's host
time covers the device work only where the region itself waits for it.
``profile_to(log_dir)`` records a torch.profiler trace of a region, device
time included where a card is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from time import perf_counter as _clock

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function


@dataclasses.dataclass(slots=True)
class StageStat:
    calls: int = 0
    seconds: float = 0.0
    items: float = 0.0  # stage-defined unit (audio-sec, files, bytes…)

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


class Tracer:
    """Per-stage host wall times and counters, and the device time of the
    spans that recorded CUDA events."""

    def __init__(self):
        self.stats: dict[str, StageStat] = defaultdict(StageStat)
        #: unresolved (start, end) CUDA event pairs by span name
        self.events: dict[str, list] = defaultdict(list)
        self._device_ms: dict[str, float] = {}

    def add(self, name: str, items: float) -> None:
        self.stats[name].items += items

    def count(self, name: str, items: float = 0.0) -> None:
        """One more call of the counter ``name``, carrying ``items``."""
        s = self.stats[name]
        s.calls += 1
        s.items += items

    def device_ms(self, name: str) -> float | None:
        """Device milliseconds inside the span ``name`` over every call that
        recorded events (calls under a profiler, on a CUDA device); None if
        none did.  Waits for the recorded work to finish."""
        pairs = self.events.pop(name, [])
        if pairs:
            ms = 0.0
            for start, end in pairs:
                end.synchronize()
                ms += start.elapsed_time(end)
            self._device_ms[name] = self._device_ms.get(name, 0.0) + ms
        return self._device_ms.get(name)

    def report(self) -> str:
        lines = []
        for name in sorted(self.stats):
            s = self.stats[name]
            line = f"{name}: {s.calls} calls"
            if s.seconds > 0:
                line += f", {s.seconds * 1e3:,.1f} ms"
            if s.items:
                line += f", {s.items:,.3f} items"
                if s.seconds > 0:
                    line += f" ({s.rate:,.1f}/s)"
            lines.append(line)
        return "\n".join(lines)

    def reset(self) -> None:
        self.stats.clear()
        self.events.clear()
        self._device_ms.clear()


#: process-wide tracer the decode layer reports into
TRACE = Tracer()


class span:
    """``with span(name, device=None, label=None):`` time a region into
    ``TRACE`` (module docstring).  ``label`` names the profiler range where
    it differs from the stat's name (``decode.call`` numbers its calls)."""

    __slots__ = ("name", "device", "label", "_t0", "_range", "_start")

    def __init__(self, name: str, device=None, label: str | None = None):
        self.name = name
        self.device = device
        self.label = label
        self._range = self._start = None

    def __enter__(self):
        # the flag torch.profiler sets on entry and clears on exit
        if _autograd_profiler._is_profiler_enabled:
            self._range = record_function(self.label or self.name)
            self._range.__enter__()
            dev = self.device
            if dev is not None and torch.device(dev).type == "cuda":
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record(torch.cuda.current_stream(dev))
        self._t0 = _clock()
        return self

    def __exit__(self, et, ev, tb):
        dt = _clock() - self._t0
        s = TRACE.stats[self.name]
        s.calls += 1
        s.seconds += dt
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            TRACE.events[self.name].append((self._start, end))
            self._start = None
        if self._range is not None:
            self._range.__exit__(et, ev, tb)
            self._range = None
        return False


def to_device(array, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(array, dtype, device)`` of a host array, counted
    under ``h2d`` (one copy, its bytes) and, on a CUDA device, under
    ``sync``: a copy from pageable host memory blocks the host."""
    t = torch.as_tensor(array, dtype=dtype, device=device)
    nbytes = t.numel() * t.element_size()
    TRACE.count("h2d", nbytes)
    if nbytes and t.device.type == "cuda":
        TRACE.count("sync")
    return t


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array; a fetch from a CUDA device is counted
    under ``sync``."""
    if t.device.type == "cuda" and t.numel():
        TRACE.count("sync")
    return t.cpu().numpy()


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Capture a torch.profiler trace around a region into ``log_dir`` (a
    Chrome trace, ``*.pt.trace.json``): host activity, and the card's
    kernels where CUDA is available."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield

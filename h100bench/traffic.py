"""The closed-loop traffic generator: which files each call decodes.

A traffic mix is a data file, ``mixes/<traffic>.json``, over the pool of
files the configuration's maker makes (``pool.py``):

* ``files_per_call``: files handed to one decode call, drawn without
  repeats along one seeded permutation of the pool (a loader's shuffle);
  the permutation starts again once the pool is used up;
* ``rotate_frames``: each file a call gets is its pool file rotated by a
  seeded number of whole frames (for codecs whose frames stand alone), so
  that no two calls hand over the same bytes; the rotated copies of
  ``prepared_calls`` calls are made in set-up, and later calls take them
  again in turn;
* ``warmup_calls``: the first calls of the schedule, run in set-up; the
  window goes on from the next;
* ``check_calls``, ``check_files``: calls whose output is kept for the
  comparison, drawn from the seed over the window's calls, and how many of
  each one's files (drawn from the seed) are held to the reference;
* ``trace_skip``, ``trace_calls``: with ``--trace 1``, the calls of the
  window that the profiler records;
* ``torch_threads`` (optional): the caller's intra-op threads, as a
  serving process sets them.

One caller in one process sends each call when the last has returned.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "mixes", f"{name}.json")) as f:
        return json.load(f)


class Schedule:
    """Call k's pool indices and bytes, for any k, from the mix and the seed."""

    def __init__(self, mix: dict, inputs, seed: int):
        self.per_call = int(mix["files_per_call"])
        self.inputs = inputs
        self.order = np.random.default_rng([seed, 1]).permutation(len(inputs.blobs))
        self.prepared: list[list[bytes]] | None = None
        if mix.get("rotate_frames"):
            n = int(mix["prepared_calls"])
            rng = np.random.default_rng([seed, 4])
            self.prepared = [[rotate(inputs.blobs[i], inputs.info[i]["frame_offsets"], rng)
                              for i in self._draw(k)] for k in range(n)]

    def _draw(self, k: int) -> list[int]:
        n = len(self.order)
        return [int(self.order[(k * self.per_call + j) % n]) for j in range(self.per_call)]

    def files(self, k: int) -> list[int]:
        return self._draw(k if self.prepared is None else k % len(self.prepared))

    def blobs(self, k: int) -> list[bytes]:
        if self.prepared is None:
            return [self.inputs.blobs[i] for i in self.files(k)]
        return self.prepared[k % len(self.prepared)]


def rotate(blob: bytes, offsets: list[int], rng: np.random.Generator) -> bytes:
    """The stream's frames from a seeded one to the end, then the rest."""
    at = offsets[int(rng.integers(len(offsets)))]
    return blob[at:] + blob[:at]


class Reservoir:
    """A seeded uniform sample of ``size`` calls out of however many come."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 3])
        self.kept: dict[int, object] = {}
        self.seen = 0

    def offer(self, k: int, item) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept[k] = item
            return
        j = int(self.rng.integers(self.seen))
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            self.kept[k] = item

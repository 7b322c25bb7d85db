"""The decode program: the port's ``decode_assets`` on host bytes, as a
loader hands it files.  A configuration that names no program drives it.

Its mix keys (``traffic.py``): ``files_per_call``, ``rotate_frames`` with
``prepared_calls``, and ``check_files``.  ``start`` lays out the seeded
schedule and makes the rotated copies; call k hands the schedule's files
to ``decode_assets`` as ``Asset``s and fetches the batch's metadata and a
NaN flag of its last PCM column.  Its record is a ``check.Call``; of a
kept batch the seeded rows (``check.rows_to_check``) come to the host, and
``check.judge`` holds every call and those rows to the configuration's
reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from audio_decoder_tpu_torch.codecs.registry import decode_assets
from audio_decoder_tpu_torch.io.assets import Asset
from h100bench import check, traffic


class Call(check.Call):
    """A call of the window with the audio-seconds its fetch reports."""

    @property
    def audio_s(self) -> float:
        """Valid frames over the sample rate, files without an error code."""
        ok = self.meta[3] == 0
        return float((self.meta[2][ok] / np.maximum(self.meta[0][ok], 1)).sum())


def _fetch(batch) -> np.ndarray:
    """The call's host fetch: its metadata and a NaN flag of the last PCM
    column, so that it waits for the device work that wrote the PCM."""
    nan = torch.isnan(batch.data[:, -1]).to(torch.int32)
    rows = [batch.sample_rate, batch.num_channels, batch.valid_frames, batch.err, nan]
    return torch.stack([r.to(torch.int32) for r in rows]).cpu().numpy().astype(np.int64)


def pieces(config: dict, mix: dict) -> list[str]:
    if int(mix["files_per_call"]) < 1:
        raise ValueError("a decode call needs files_per_call >= 1")
    ref = config["check"]["reference"]
    if ref == "source":   # the maker's truth
        return [f"h100bench/inputs/{config['maker']}.py"]
    return [f"h100bench/reference/{ref}.py"]


def start(config: dict, mix: dict, inputs, seed: int, device: str, decode=None) -> Session:
    """``decode`` stands in for ``decode_assets`` (the tests break it)."""
    return Session(config, mix, inputs, seed, device, decode)


class Session:
    def __init__(self, config, mix, inputs, seed, device, decode):
        self.decode = decode or decode_assets
        self.config, self.mix, self.inputs, self.seed, self.device = (
            config, mix, inputs, seed, device)
        self.schedule = traffic.Schedule(mix, inputs, seed)
        self.pool_assets = [Asset(path=f"{n}.{inputs.ext}", name=n, ext=inputs.ext, data=b)
                            for n, b in zip(inputs.names, inputs.blobs)]
        self.prepared = None
        if self.schedule.prepared is not None:
            self.prepared = [[Asset(path=f"{inputs.names[i]}.{inputs.ext}",
                                    name=inputs.names[i], ext=inputs.ext, data=b)
                              for i, b in zip(self.schedule.files(k), blobs)]
                             for k, blobs in enumerate(self.schedule.prepared)]

    def assets_of(self, k: int):
        if self.prepared is None:
            return [self.pool_assets[i] for i in self.schedule.files(k)]
        return self.prepared[k % len(self.prepared)]

    def call(self, k: int):
        assets = self.assets_of(k)
        t0 = time.perf_counter()
        batch = self.decode(assets, device=self.device)
        with record_function("h100bench.fetch"):
            meta = _fetch(batch)
        return Call(k, self.schedule.files(k), tuple(batch.names), tuple(batch.formats), meta,
                    time.perf_counter() - t0), batch

    def to_host(self, record: Call, batch):
        rows = check.rows_to_check(self.mix, self.seed, record.k)
        return batch.data[rows].cpu().numpy(), batch.channels, rows

    def close(self) -> None:
        """Nothing of the program outlives a call but the kept batches,
        which the loop lets go."""

    def judge(self, records: list[Call], kept: dict, workers: int):
        return check.judge(self.config, self.inputs, records, kept, self.schedule.blobs,
                           workers)

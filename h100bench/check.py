"""The comparison that decides ``correct``.

Every call of the window is held to what its files must give: its names
in call order, format, sample rate, channel count, frame count, error code
0 and no NaN in the fetched column (``bad_files``, limit 0).  The PCM of a
seeded sample of files (``check_files`` of each of ``check_calls`` calls
kept by a seeded draw) is held to the configuration's reference, file by
file over the valid frames:

* ``exact``: the source samples the maker encoded (its ``truth``), scaled
  by 2^-(bits-1); ``bad_samples`` counts those that differ (limit 0);
* ``rel_rms``: the reference decoder ``reference/<name>.py`` run on the
  bytes the call was handed; ``pcm_rel_rms`` is the worst RMS of the
  difference over any block of ``block_frames`` frames (an MP3 frame's
  1,152), relative to the RMS of the reference's whole file, so that one
  wrong frame or click shows however long the file (limit from the
  configuration).

The references run in worker processes once the window has closed.
Nothing of the program is used: the references work from the bytes or the
source samples the benchmark made.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import pool


@dataclasses.dataclass
class Call:
    """One decode call of the window, as the host saw it."""

    k: int            # the call's place in the schedule
    files: list[int]  # pool indices
    names: tuple
    formats: tuple
    meta: np.ndarray  # int [5, files]: rate, channels, frames, err, NaN flag
    seconds: float


def rows_to_check(mix: dict, seed: int, k: int) -> list[int]:
    """The seeded choice of call k's files whose PCM is compared."""
    n = int(mix["files_per_call"])
    pick = np.random.default_rng([seed, 5, k]).permutation(n)[:int(mix["check_files"])]
    return sorted(int(r) for r in pick)


def want_meta(inputs, i: int) -> np.ndarray:
    return np.array([inputs.sample_rate, inputs.channels, inputs.frames(i), 0, 0])


def reference_tasks(config: dict, files: list[tuple[int, bytes]]) -> list[tuple]:
    """One task for ``pool.parallel`` per (pool index, bytes handed over)."""
    ref = config["check"]["reference"]
    if ref == "source":
        module = f"h100bench.inputs.{config['maker']}"
        return [(module, "truth", (config, i)) for i, _ in files]
    return [(f"h100bench.reference.{ref}", "decode", (blob,)) for _, blob in files]


def reference_pcm(config: dict, out) -> np.ndarray:
    """A reference task's result as float64 PCM [frames, channels]."""
    if config["check"]["reference"] == "source":
        return out / 2.0 ** (int(config["bits"]) - 1)
    return out[0]


def rel_rms(got: np.ndarray, want: np.ndarray, block: int) -> float:
    """The worst block's RMS of ``got - want`` over the RMS of ``want``
    (both [frames, channels]); inf where either is not finite."""
    d = np.zeros((-(-len(want) // block) * block, want.shape[1]))
    d[:len(want)] = got - want
    worst = np.sqrt((d.reshape(-1, block * want.shape[1]) ** 2).mean(axis=1)).max()
    rel = float(worst / np.sqrt(np.mean(want ** 2)))
    return rel if np.isfinite(rel) else np.inf


def judge(config: dict, inputs, calls: list[Call], kept: dict, blobs_of, workers: int):
    """(checks {name: (value, limit)}, failed call count).  ``kept[p]`` is
    the PCM of the compared rows of ``calls[p]``, fetched after the window:
    (float32 [rows, frames * storage channels] interleaved, storage
    channels, the rows).  ``blobs_of(k)`` gives the bytes call k was
    handed."""
    check = config["check"]
    failed: set[int] = set()
    bad_files = 0
    for p, c in enumerate(calls):
        if len(c.names) != len(c.files) or c.meta.shape[1] != len(c.files):
            bad = np.ones(len(c.files), bool)
        else:
            want = np.stack([want_meta(inputs, i) for i in c.files], axis=1)
            bad = (want != c.meta).any(axis=0)
            bad |= np.array([inputs.names[i] != n for i, n in zip(c.files, c.names)])
            bad |= np.array([f != inputs.ext for f in c.formats])
        if bad.any():
            failed.add(p)
            bad_files += int(bad.sum())
    checks = {"bad_files": (bad_files, 0)}

    compared = [(p, j, row) for p, (_, _, rows) in sorted(kept.items())
                for j, row in enumerate(rows)]
    files = [(calls[p].files[row], blobs_of(calls[p].k)[row]) for p, _, row in compared]
    refs = [reference_pcm(config, r)
            for r in pool.parallel(reference_tasks(config, files), workers)]
    worst, bad_samples = 0.0, 0
    for (p, j, _), want in zip(compared, refs):
        data, storage, _ = kept[p]
        frames, ch = want.shape
        got = None
        if j < data.shape[0] and data.shape[1] >= frames * storage and storage >= ch:
            got = data[j, :frames * storage].reshape(frames, storage)[:, :ch].astype(np.float64)
        if check["pcm"] == "exact":
            n_bad = want.size if got is None else int(np.count_nonzero(got != want))
            bad_samples += n_bad
            wrong = n_bad > 0
        else:
            rel = np.inf if got is None else rel_rms(got, want, int(check["block_frames"]))
            worst = max(worst, rel)
            wrong = rel > check["limit"]
        if wrong:
            failed.add(p)
    if check["pcm"] == "exact":
        checks["bad_samples"] = (bad_samples, 0)
    else:
        checks["pcm_rel_rms"] = (worst, check["limit"])
    return checks, len(failed)

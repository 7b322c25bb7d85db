"""The controls of ``correct``: the reference put in the program's place at
the precision below the one the configuration states, judged by the run's
own comparison (``check.judge``).  A sound comparison finds them wrong.

    python3 -m h100bench.control --workload <cell> --seeds 1,2,3

* MP3 (float32 PCM): the reference decoder with every stage stored in
  bfloat16;
* FLAC (lossless 16-bit): the reference decoder with the predictor summed
  in float32.

For each seed it takes the files a run of the cell compares (the first
``check_calls`` calls of the window, ``check_files`` of each, handed over
as the run hands them), decodes them with the control, hands that PCM to
``check.judge`` as the calls' output, and prints ``correct`` and each
number beside its limit.  The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import check, pool, traffic
from . import run as harness
from .reference import flac, mp3


def bf16(x: np.ndarray) -> np.ndarray:
    """Round to bfloat16 (nearest, ties to even), back in float64."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return u.view(np.float32).astype(np.float64)


def mp3_bf16(blob: bytes) -> np.ndarray:
    return mp3.decode(blob, rounding=bf16)[0]


def flac_f32(blob: bytes) -> np.ndarray:
    return flac.decode_many([blob], predict="float32")[0] / 32768.0


CONTROLS = {"mp3": "mp3_bf16", "source": "flac_f32"}


def judged(config: dict, mix: dict, inputs, seed: int, workers: int) -> dict:
    """The control in the program's place for the compared files of one
    run of the cell: ``correct``, the checks and how many files."""
    schedule = traffic.Schedule(mix, inputs, seed)
    warmup = int(mix["warmup_calls"])
    calls, kept, tasks = [], {}, []
    for p in range(int(mix["check_calls"])):
        k = warmup + p
        files = schedule.files(k)
        meta = np.stack([check.want_meta(inputs, i) for i in files], axis=1)
        calls.append(check.Call(k, files, tuple(inputs.names[i] for i in files),
                                (inputs.ext,) * len(files), meta, 0.0))
        rows = check.rows_to_check(mix, seed, k)
        kept[p] = rows
        blobs = schedule.blobs(k)
        tasks += [("h100bench.control", CONTROLS[config["check"]["reference"]], (blobs[r],))
                  for r in rows]
    pcm = iter(pool.parallel(tasks, workers))
    outputs = {}
    for p, rows in kept.items():
        got = [next(pcm) for _ in rows]
        width = max(g.size for g in got)
        data = np.zeros((len(rows), width), np.float32)
        for j, g in enumerate(got):
            data[j, :g.size] = g.reshape(-1)
        outputs[p] = (data, inputs.channels, rows)
    checks, failed = check.judge(config, inputs, calls, outputs, schedule.blobs, workers)
    return {"correct": all(v <= lim for v, lim in checks.values()) and failed == 0,
            "files": sum(len(r) for r in kept.values()),
            "checks": {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell, config, mix = harness.cell_parts(bench, args.workload)
    inputs, _ = pool.load(config, harness.CACHE, harness.WORKERS)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = {"workload": cell["name"], "seed": seed,
               **judged(config, mix, inputs, seed, harness.WORKERS)}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Host cost of the port's span helper (``utils/trace.span``) against a bare
``torch.profiler.record_function``: microseconds per enter and exit with no
profiler recording, and under a CPU profiler.  Prints one JSON line, with
the card's name and power limit where ``nvidia-smi`` answers.

Usage:
  python3 tools/torch_span_cost.py [--n 200000] [--reps 5]

Each figure is the least of ``--reps`` runs of ``--n`` enters in a loop,
less the cost of the bare loop; ``empty_with_us`` is a ``with`` statement
around a context manager that does nothing, for scale.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from audio_decoder_tpu_torch.utils.trace import TRACE, span  # noqa: E402


def per_enter_us(make, n: int, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            with make("cost.probe"):
                pass
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e6


def loop_us(n: int, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    class Nothing:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    loop = loop_us(args.n, args.reps)
    out = {"loop_us": loop, "empty_with_us": per_enter_us(Nothing, args.n, args.reps) - loop}
    out["span_off_us"] = per_enter_us(span, args.n, args.reps) - loop
    out["record_function_off_us"] = per_enter_us(
        record_function, args.n, args.reps) - loop
    n_on = max(1, args.n // 20)
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_on_us"] = per_enter_us(span, n_on, 1) - loop
        out["record_function_on_us"] = per_enter_us(
            record_function, n_on, 1) - loop
    TRACE.reset()
    try:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except OSError:
        out["card"] = None
    out["python"] = sys.version.split()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One benchmark cell, run as ``python3 -m h100bench.run`` runs it, and then
what the program's own tracer (``utils/trace.TRACE``) kept over the run.

Prints the run's result line (as the benchmark does, last on stdout), and
before it one JSON line ``{"spans": ...}`` with: each span's host
milliseconds per call over every call of the run (warm-up included);
the share of ``decode.call``'s host time that its direct children cover
(``decode.route``, ``decode.<family>``, ``decode.assemble``); the
counters per call (for FLAC, the device chunks, the rice kernel's
launches and lanes and the predictor kernel's launches and subframes);
and, with ``--trace 1``, each device-timed span's device milliseconds per
traced call beside the trace's device busy time and wall per traced
call.

Usage (from the root of a checkout, on the card):
  python3 tools/torch_span_report.py --workload fma-mp3.loader --seed 7 \\
      --seconds 30 --trace 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100bench import run  # noqa: E402

DEVICE_TIMED = ("mp3.entropy", "mp3.requantize", "mp3.stereo", "mp3.imdct", "mp3.synth",
                "flac.rice_scan", "flac.predict")
OWN = ("decode.call", "decode.route", "decode.assemble")


def span_report(trace, result: dict, traced_calls: int) -> dict:
    stats = trace.stats
    calls = stats["decode.call"].calls
    per_call = {name: s.seconds / calls * 1e3 for name, s in sorted(stats.items())
                if s.seconds > 0}
    children = [n for n in stats if n.startswith("decode.") and n != "decode.call"]
    out = {"calls": calls, "host_ms_per_call": per_call,
           "children": sorted(children),
           "children_share": sum(stats[n].seconds for n in children)
           / stats["decode.call"].seconds,
           "sync_per_call": stats["sync"].calls / calls if "sync" in stats else 0.0,
           "h2d_copies_per_call": stats["h2d"].calls / calls if "h2d" in stats else 0.0,
           "h2d_mb_per_call": stats["h2d"].items / calls / 1e6 if "h2d" in stats else 0.0}
    if "flac.window_add2" in stats:
        # one rice and one predictor kernel launch per FLAC device chunk (one
        # K4 call each)
        out["flac_chunks_per_call"] = stats["flac.window_add2"].calls / calls
        rice = stats.get("flac.rice_kernel")
        out["rice_kernel_launches_per_call"] = rice.calls / calls if rice else 0.0
        out["rice_kernel_lanes_per_call"] = rice.items / calls if rice else 0.0
        pred = stats.get("flac.predict_kernel")
        out["predict_kernel_launches_per_call"] = pred.calls / calls if pred else 0.0
        out["predict_kernel_subframes_per_call"] = pred.items / calls if pred else 0.0
    if "busy_s" in result["device"]:
        device = {n: trace.device_ms(n) for n in DEVICE_TIMED}
        out["device_ms_per_traced_call"] = {
            n: (None if v is None else v / traced_calls) for n, v in device.items()}
        out["device_ms_timed_sum"] = sum(v for v in out["device_ms_per_traced_call"].values()
                                         if v is not None)
        out["busy_ms_per_traced_call"] = result["device"]["busy_s"] / traced_calls * 1e3
        out["wall_ms_per_traced_call"] = result["device"]["window_s"] / traced_calls * 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    bench = run.load_benchmark()
    import torch

    # as run.main does before the cell: CUDA's start stays out of the calls
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    result = run.run_cell(bench, args.workload, args.seed % (1 << 64), args.seconds,
                          bool(args.trace), t_start=T_START)
    from audio_decoder_tpu_torch.utils.trace import TRACE

    _, _, mix = run.cell_parts(bench, args.workload)
    print(json.dumps({"spans": span_report(TRACE, result, int(mix["trace_calls"]))}))
    print(f"card: {run.card_line()}", file=sys.stderr)
    return run.emit(result)


if __name__ == "__main__":
    sys.exit(main())

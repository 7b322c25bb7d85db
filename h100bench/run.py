"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
mix come from ``BENCHMARK.json``; the configuration's maker makes the pool
of files (``inputs/``, kept by ``pool.py``), the configuration names the
program its calls drive (``programs/<name>.py``, ``decode`` where it names
none), and each metric is read by ``metrics/<name>.py`` (or
``metrics/<name up to its first dot>.py``).  The program under test, the
port, is entered only through that program module; the loop here knows no
program.

A cell runs on the ``chips`` cards it names, ``cuda:0`` onwards, all
handed to its program (``programs/__init__.py``); ``memory_peak_bytes`` is
the fullest card's peak, and the result line's ``device`` also lists each
card's peak and, traced, each card's busy seconds.

Set-up (``setup_s``) runs from the start of this process: imports, CUDA
initialisation, the pool of files (made on a checkout's first run, read
after), the program's session (its libraries, built into the port's own
``build/`` on a checkout's first run, and whatever it lays out in
advance), and the warm-up calls.  Then calls go back to back, each ending
in a host fetch, until ``--seconds`` have passed.  With ``--trace 1`` the
profiler records the mix's stretch of calls and the per-layer metrics are
printed instead of the end-to-end ones.  Once the window has closed, the
program's kept outputs are held to its reference, and the line is printed
only if no JAX module has been loaded in the process by then.

The loop reads these keys of a mix; a program reads its own:

* ``warmup_calls``: the first calls of the schedule, run in set-up; the
  window goes on from the next;
* ``check_calls``: calls whose output is kept for the comparison, drawn
  from the seed over the window's calls;
* ``trace_skip``, ``trace_calls``: with ``--trace 1``, the calls of the
  window that the profiler records;
* ``torch_threads`` (optional): the caller's intra-op threads, as a
  serving process sets them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from . import pool, traffic  # noqa: E402
from . import trace as trace_mod  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
PROGRAMS = os.path.join(HERE, "programs")
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".h100bench_cache")
WORKERS = min(8, os.cpu_count() or 1)
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_decoder_tpu")


def set_cache_dirs() -> None:
    """Every kernel and build cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_parts(bench: dict, workload: str):
    """(cell, configuration file's contents, mix)."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    return cell, config, traffic.load_mix(cell["traffic"])


def cell_metrics(bench: dict, cell: dict, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with a trace its per-layer ones."""
    pool = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in pool if cell["name"] in m.get("workloads", [cell["name"]])]


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module   # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def reader(name: str):
    """``metrics/<name>.py``, else ``metrics/<name up to its first dot>.py``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return _module(path, f"h100bench.metrics.{stem}").read
    raise FileNotFoundError(f"no reader for metric {name!r}")


def program(config: dict, where: str = PROGRAMS):
    """The module ``<where>/<the configuration's program>.py``."""
    name = config.get("program", "decode")
    path = os.path.join(where, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no program {name!r} in {where}")
    return _module(path, f"h100bench.programs.{name}")


def cell_cards(device: str, chips: int) -> list[str]:
    """The cards a cell's program gets: ``device`` alone for one card;
    ``cuda:0`` to ``cuda:<chips-1>`` for more, or on the CPU (the tests)
    ``chips`` times the CPU."""
    import torch

    if chips == 1:
        return [device]
    if torch.device(device).type == "cuda":
        return [f"cuda:{i}" for i in range(chips)]
    return [device] * chips


def card_index(card: str) -> int:
    """The card's device index, as the profiler's device events give it
    (``cuda`` alone is card 0: the harness makes no other card current)."""
    import torch

    return torch.device(card).index or 0


def sync_card(card: str) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(card).type == "cuda":
        torch.cuda.synchronize(card)


def card_peak(card: str) -> int:
    """The card's peak of allocated bytes in this process (0 on the CPU)."""
    import torch

    return torch.cuda.max_memory_allocated(card) if torch.device(card).type == "cuda" else 0


def free_card(card: str) -> None:
    """Release the card's cached, unused memory blocks."""
    import torch

    if torch.device(card).type == "cuda":
        with torch.cuda.device(card):
            torch.cuda.empty_cache()


def run_cell(bench: dict, workload: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", cards: list[str] | None = None, t_start: float = T_START,
             cache_root: str = CACHE, workers: int = WORKERS, config_over: dict | None = None,
             mix_over: dict | None = None, programs: str = PROGRAMS, **hooks) -> dict:
    """One run of a cell: the result line's object.  The program gets the
    cell's cards (``cell_cards``; ``cards`` overrides them, as a test hands
    one card twice).  The tests shrink the cell (``config_over``,
    ``mix_over``), run it on the CPU, take the program from another
    directory (``programs``) and break it underneath (``hooks``, which go
    to the program's ``start``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cell, config, mix = cell_parts(bench, workload)
    config = {**config, **(config_over or {})}
    mix = {**mix, **(mix_over or {})}
    prog = program(config, programs)
    cards = list(cards or cell_cards(device, int(cell["chips"])))
    on_card = torch.device(cards[0]).type == "cuda"
    if "torch_threads" in mix:
        torch.set_num_threads(int(mix["torch_threads"]))

    t0 = time.perf_counter()
    inputs, made = pool.load(config, cache_root, workers)
    pool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if len(cards) > 1:
        hooks = {**hooks, "cards": cards}
    session = prog.start(config, mix, inputs, seed, cards[0], **hooks)
    start_s = time.perf_counter() - t0

    warmup = int(mix["warmup_calls"])
    t0 = time.perf_counter()
    for k in range(warmup):
        session.call(k)
    for card in cards:
        sync_card(card)
    warm_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: pool of {len(inputs.blobs)} files "
          f"{'made' if made else 'read'} in {pool_s:.3f} s, {config.get('program', 'decode')} "
          f"session in {start_s:.3f} s, warm-up {warm_s:.3f} s", file=sys.stderr)

    records, latencies = [], []
    kept = traffic.Reservoir(int(mix["check_calls"]), seed)
    skip, n_traced = int(mix["trace_skip"]), int(mix["trace_calls"])
    prof = stretch = None
    traced_calls: list[int] = []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    t_window = time.perf_counter()
    t_end = t_window
    p = 0
    while True:
        if traced and p == skip:
            prof = profile(activities=acts)
            prof.__enter__()
            stretch = record_function("h100bench.stretch")
            stretch.__enter__()
        t0 = time.perf_counter()
        with record_function("h100bench.call"):
            record, output = session.call(warmup + p)
        t_end = time.perf_counter()
        records.append(record)
        latencies.append(t_end - t0)
        kept.offer(p, output)
        del output
        if stretch is not None:
            traced_calls.append(p)
            if len(traced_calls) == n_traced:
                stretch.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                stretch = None
        p += 1
        if t_end - t_window >= seconds and (not traced or len(traced_calls) == n_traced):
            break
    wall_s = t_end - t_window
    peaks = [card_peak(card) for card in cards]

    # the program's state goes before the references run
    outputs = {q: session.to_host(records[q], out) for q, out in kept.kept.items()}
    kept.kept.clear()
    session.close()
    for card in cards:
        free_card(card)

    tr = None
    if traced:
        tr = trace_mod.from_profile(prof, len(traced_calls),
                                    [records[j].files for j in traced_calls],
                                    sum(records[j].audio_s for j in traced_calls),
                                    tuple(card_index(card) for card in cards))

    t0 = time.perf_counter()
    checks, failed = session.judge(records, outputs, workers)
    judge_s = time.perf_counter() - t0
    run = SimpleNamespace(setup_s=setup_s, wall_s=wall_s, calls=records,
                          audio_s=sum(r.audio_s for r in records),
                          latencies=np.array(latencies),
                          trace=tr, inputs=inputs, config=config, cell=cell)
    metrics = {}
    for m in cell_metrics(bench, cell, traced):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(cards[0]) if on_card else "cpu",
           "count": len(cards), "memory_peak_bytes": int(max(peaks)),
           "memory_peak_bytes_per_card": [int(p) for p in peaks]}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s, busy_s_per_card=tr.busy_s_per_card)
    result = {"correct": all(v <= lim for v, lim in checks.values()) and failed == 0,
              "attempted": len(records), "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    q = np.percentile(run.latencies, [0, 25, 50, 75, 100]) * 1e3
    print(f"window {wall_s:.3f} s, {len(records)} calls, {run.audio_s:.3f} audio-s, "
          f"{len(outputs)} kept calls judged in {judge_s:.3f} s; "
          "call ms min/q1/median/q3/max " + "/".join(f"{v:.2f}" for v in q)
          + "; first calls ms " + " ".join(f"{s * 1e3:.2f}" for s in latencies[:5]),
          file=sys.stderr)
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result


def forbidden_modules() -> list[str]:
    """JAX, its relatives or the JAX package, by whole top-level name, in
    this process."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    bench = load_benchmark()
    chips = next(w for w in bench["workloads"] if w["name"] == args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed % (1 << 64), args.seconds,
                      bool(args.trace))
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return emit(result)


def emit(result: dict) -> int:
    """Print the result line, last, unless JAX or the JAX package has been
    loaded in this process by then: then exit 3 with no result."""
    found = forbidden_modules()
    if found:
        print(f"loaded in the process: {', '.join(found)}; no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

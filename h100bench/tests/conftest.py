"""Shared helpers of the benchmark's own tests (CPU; the ``cuda`` ones
decide inside the test whether a card is there)."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: each cell cut to a size a CPU test holds: (config overrides, mix overrides)
SMALL = {
    "fma-mp3.loader": ({"pool_files": 3, "clip_seconds": 1.0},
                       {"files_per_call": 2, "prepared_calls": 4, "check_calls": 2,
                        "check_files": 2, "trace_calls": 1}),
    "librispeech-flac.loader": ({"pool_files": 6, "mean_length_s": 1.5, "min_length_s": 0.5,
                                 "max_length_s": 3.0},
                                {"files_per_call": 2, "check_calls": 2, "check_files": 2}),
    "fma-mp3.single": ({"pool_files": 2, "clip_seconds": 1.0},
                       {"prepared_calls": 3, "warmup_calls": 1, "check_calls": 2,
                        "trace_skip": 1, "trace_calls": 1}),
}


@pytest.fixture(scope="session")
def cache(tmp_path_factory):
    """A pool cache for the tests' small pools, outside the checkout."""
    return str(tmp_path_factory.mktemp("h100bench_cache"))


def small_run(bench, cell, cache, traced=False, seed=2**33 + 11, **kw):
    from h100bench import run

    cover, mover = SMALL[cell]
    cover = {**cover, **kw.pop("config_over", {})}
    mover = {**mover, **kw.pop("mix_over", {})}
    return run.run_cell(bench, cell, seed, 0.2, traced, device="cpu", config_over=cover,
                        mix_over=mover, t_start=time.perf_counter(), cache_root=cache,
                        workers=1, **kw)

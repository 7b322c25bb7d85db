"""Shared helpers of the benchmark's own tests (CPU; the ``cuda`` ones
decide inside the test whether a card is there)."""

import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "small")


def small(cell: str) -> tuple[dict, dict]:
    """The cell cut to a size a CPU test holds, ``small/<cell>.json``:
    (configuration overrides, mix overrides)."""
    with open(os.path.join(SMALL, f"{cell}.json")) as f:
        cut = json.load(f)
    return cut["config"], cut["mix"]


def program_cells(bench: dict, name: str) -> list[str]:
    """The cells whose configuration drives the program ``name``."""
    from h100bench import run

    return [w["name"] for w in bench["workloads"]
            if run.cell_parts(bench, w["name"])[1].get("program", "decode") == name]


@pytest.fixture(scope="session")
def cache(tmp_path_factory):
    """A pool cache for the tests' small pools, outside the checkout."""
    return str(tmp_path_factory.mktemp("h100bench_cache"))


def small_run(bench, cell, cache, traced=False, seed=2**33 + 11, **kw):
    from h100bench import run

    cover, mover = small(cell)
    cover = {**cover, **kw.pop("config_over", {})}
    mover = {**mover, **kw.pop("mix_over", {})}
    return run.run_cell(bench, cell, seed, 0.2, traced, device="cpu", config_over=cover,
                        mix_over=mover, t_start=time.perf_counter(), cache_root=cache,
                        workers=1, **kw)

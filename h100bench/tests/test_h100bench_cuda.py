"""On the card: each cell run whole, short, as the benchmark's command
runs it.  Skips where no card is (decided inside the test).

    python -m pytest h100bench/tests -m cuda -q
"""

import json
import os
import subprocess
import sys

import pytest

from h100bench.run import load_benchmark
from h100bench.tests.conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in load_benchmark()["workloads"]])
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    chips = next(w["chips"] for w in load_benchmark()["workloads"] if w["name"] == cell)
    if torch.cuda.device_count() < chips:
        pytest.skip(f"the cell needs {chips} cards")
    p = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", cell,
                        "--seed", str(2**32 + 17), "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200,
                       env=os.environ.copy())
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu", r

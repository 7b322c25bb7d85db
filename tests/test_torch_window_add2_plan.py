"""PyTorch port, K4 (``csrc/window_add2.cu``): the wrapper's host-side
sizing and its failure paths, on the CPU.

The kernel's plan runs on the card, so here a numpy re-count of it —
each tile's lane run of each set by ``searchsorted`` on the running
maximum of the starts, and its units of ``UNIT_WORK2`` lane-elements — is
held against the workspace and grid that ``plan_sizes`` derives from the
shapes alone: the heavy tiles' units must fit the bound the kernel gets.
A lane counts at least ``ROW_WORK2`` lane-elements (each row costs every
thread of a block a step, however narrow it is).
"""

import os
import re

import numpy as np
import pytest
import torch

from audio_decoder_tpu_torch.ops import window_add as PW
from audio_decoder_tpu_torch.utils import build

from .test_torch_cuda import window_case

CU = os.path.join(os.path.dirname(PW.__file__), os.pardir, "csrc",
                  "window_add2.cu")


def _units(sets, n_out):
    """Per tile, its units as the plan counts them (numpy)."""
    T, U = PW.TILE2, PW.UNIT_WORK2
    t0 = np.arange(-(-n_out // T), dtype=np.int64) * T
    work = np.zeros_like(t0)
    lanes = np.zeros_like(t0)
    for starts, W in sets:
        if len(starts) == 0 or W == 0:
            continue
        s = np.maximum.accumulate(starts.astype(np.int64))
        n = np.searchsorted(s, t0 + T) - np.searchsorted(s, t0 - W + 1)
        work += n * max(min(W, T), PW.ROW_WORK2)
        lanes += n
    return np.maximum(np.minimum(-(-work // U), np.maximum(lanes, 1)), 1)


def _pile_up(rng, L, W, n_live):
    """Starts of the FLAC packers' layout: live lanes tiling the output,
    then padding lanes at start 0 (re-pointed onto the last live start)."""
    counts = rng.integers(W // 2, W + 1, size=n_live)
    starts = np.zeros(L, np.int64)
    starts[1:n_live] = np.cumsum(counts)[:-1]
    return starts.astype(np.int32), int(counts.sum()) + W


SHAPES = [
    # (seed, La, Wa, live a, Lb, Wb, live b): the 16-file FLAC group's
    # shapes (10,400 padding rice lanes), a pile-up in set b, wide lanes
    (0, 65536, 256, 55136, 4096, 8, 3456),
    (1, 3000, 256, 300, 2000, 8, 40),
    (2, 200, 8200, 150, 64, 3, 60),
    (3, 4000, 4096, 100, 0, 8, 0),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"seed{s[0]}")
def test_plan_sizes_cover_the_plan(shape):
    seed, La, Wa, na, Lb, Wb, nb = shape
    rng = np.random.default_rng(seed)
    sa, xa = _pile_up(rng, La, Wa, na)
    sb, xb = _pile_up(rng, Lb, Wb, nb)
    for n_out in (max(xa, xb), max(xa, xb) // 2 + 1):
        plan = PW.plan_sizes(La, Wa, Lb, Wb, n_out)
        units = _units([(sa, Wa), (sb, Wb)], n_out)
        assert plan.nt == len(units)
        heavy_units = int(units[units > 1].sum())
        assert heavy_units <= plan.heavy
        offsets = plan.offsets
        assert all(o % 256 == 0 for o in offsets)
        assert list(offsets) == sorted(offsets)
        assert -(-(La + Lb) // plan.chunk) <= PW.MAX_CHUNKS
        scratch = plan.nbytes - offsets[-1]
        assert scratch >= plan.heavy * PW.TILE2 * 4
        assert offsets[1] >= (La + Lb) * 4
        if seed == 0 and n_out == xa:  # the group's pile-up: a wave or more
            assert units.max() >= 132


def test_plan_sizes_cover_random_contract_inputs():
    rng = np.random.default_rng(9)
    for _ in range(20):
        W = int(rng.choice([3, 8, 96, 256, 520, 4096, 5000]))
        L = int(rng.integers(1, 3000))
        starts, _upd, n_out = window_case(rng, L, 1, int(rng.integers(0, L + 1)))
        starts = (starts.astype(np.int64) * rng.integers(1, W + 1)).astype(np.int32)
        n_out = int(starts.max()) + W + int(rng.integers(0, 9000))
        plan = PW.plan_sizes(L, W, 0, 8, n_out)
        units = _units([(starts, W)], n_out)
        assert int(units[units > 1].sum()) <= plan.heavy


def test_constants_match_the_kernel_source():
    src = open(CU).read()

    def const(name):
        return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);",
                             src).group(1))

    assert const("kTile") == PW.TILE2
    assert const("kUnitWork") == PW.UNIT_WORK2
    assert const("kThreads") == PW.ROW_WORK2
    assert "constexpr int kRowWork = kThreads;" in src
    assert const("kRunChunk") == PW.RUN_CHUNK
    assert const("kMaxChunks") == PW.MAX_CHUNKS
    names = re.search(r"void\* const ws\[\d+\] = \{(.*?)\};", src, re.S).group(1)
    assert [n.strip() for n in names.split(",")] == [n for n, _ in PW.WS_PARTS]


def test_wrapper_raises_on_a_launch_or_build_error(monkeypatch):
    """No fallback: a CUDA error from the launch raises, and so does a
    library that cannot be built."""
    s = torch.zeros(4, dtype=torch.int32)
    u = torch.zeros((4, 8), dtype=torch.int32)

    class Failing:
        @staticmethod
        def window_add2_launch(*args):
            return 700

    before = PW.launches["window_add2"]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        PW._window_add2_cuda([(s, u), (s, u)], 16, lib=Failing, stream=0)
    assert PW.launches["window_add2"] == before

    def no_nvcc():
        raise build.BuildError("nvcc not found")

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    with pytest.raises(build.BuildError):
        PW._window_add2_cuda([(s, u), (s, u)], 16, stream=0)

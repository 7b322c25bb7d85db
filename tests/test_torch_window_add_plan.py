"""PyTorch port, K3 (``csrc/window_add.cu``): the wrapper's host-side
sizing and its failure paths, on the CPU.

The kernel's plan runs on the card, so here a numpy re-count of it — each
output tile's lane run by ``searchsorted`` on the running maximum of the
starts, and its units of ``UNIT_WORK1`` lane-elements, a lane counting at
least ``ROW_WORK1`` — is held against the workspace and grid that
``plan_sizes1`` derives from the shapes alone: the heavy tiles' units must
fit the bound the kernel gets.  At the 16-file FLAC group's shapes the
re-count also pins the tiles the kernel's design rests on: one-row tiles,
tiles with no lane, and two pile-up tiles of 321 rows.
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
                  "window_add.cu")


def _lanes_per_tile(starts, W, n_out):
    """Per output tile of TILE1 elements, the lanes that overlap it."""
    T = PW.TILE1
    t0 = np.arange(-(-n_out // T), dtype=np.int64) * T
    if len(starts) == 0 or W == 0:
        return np.zeros_like(t0)
    s = np.maximum.accumulate(starts.astype(np.int64))
    return np.searchsorted(s, t0 + T) - np.searchsorted(s, t0 - W + 1)


def _units(starts, W, n_out):
    """Per tile, its units as the plan counts them (numpy)."""
    n = _lanes_per_tile(starts, W, n_out)
    work = n * max(min(W, PW.TILE1), PW.ROW_WORK1)
    return np.maximum(np.minimum(-(-work // PW.UNIT_WORK1), np.maximum(n, 1)), 1)


def _check_layout(plan, L):
    """The workspace's parts: in order, 256-byte aligned, each as large as
    the kernel reads it."""
    sizes = {"sorted": L, "cmax": -(-L // plan.chunk), "recs": plan.nt,
             "tcnt": plan.nt, "heavy_total": 1, "unit_tile": plan.heavy,
             "gcnt": plan.heavy, "scratch": plan.heavy * PW.TILE1}
    ends = list(plan.offsets[1:]) + [plan.nbytes]
    for (name, size), at, end in zip(PW.WS_PARTS1, plan.offsets, ends):
        assert at % 256 == 0, name
        assert end - at >= sizes[name] * size, name
    assert -(-L // plan.chunk) <= PW.MAX_CHUNKS
    assert plan.chunk >= PW.RUN_CHUNK and plan.chunk & (plan.chunk - 1) == 0


def _flac_group_starts():
    """K3's starts at the 16-file FLAC group, as the device program builds
    them: 108 stereo frames of 4096 samples per file at file * 2 * smax +
    2 * frame start (smax = 524,288), then 320 padding rows at start 0."""
    smax, ch, nmax = 524288, 2, 4096
    live = [f * smax * ch + k * nmax * ch for f in range(16) for k in range(108)]
    starts = np.zeros(2048, np.int32)
    starts[: len(live)] = live
    return starts, nmax * ch, 16 * smax * ch + nmax * ch


def test_plan_sizes1_at_the_flac_group():
    starts, W, n_out = _flac_group_starts()
    assert (len(starts), W, n_out) == (2048, 8192, 16_785_408)
    plan = PW.plan_sizes1(len(starts), W, n_out)
    n = _lanes_per_tile(starts, W, n_out)
    assert plan.nt == len(n) == 4098
    rows, tiles = np.unique(n, return_counts=True)
    assert dict(zip(rows.tolist(), tiles.tolist())) == {0: 642, 1: 3454, 321: 2}
    units = _units(starts, W, n_out)
    assert units[n <= 1].max() == 1  # a one-row tile is one unit
    assert units.max() == 41  # each pile-up tile: 41 units of 8 rows
    assert int(units[units > 1].sum()) == 82 <= plan.heavy
    assert (plan.heavy, plan.chunk) == (1538, PW.RUN_CHUNK)
    _check_layout(plan, len(starts))
    assert plan.nbytes == plan.offsets[-1] + plan.heavy * PW.TILE1 * 4


def _pile_up(rng, L, W, n_live, unaligned):
    """Live lanes tiling the output (starts at multiples of W, or at random
    counts apart), then padding lanes at start 0."""
    counts = (rng.integers(W // 2, W + 1, size=n_live) if unaligned
              else np.full(n_live, W))
    starts = np.zeros(L, np.int64)
    starts[1:n_live] = np.cumsum(counts)[:-1]
    return starts.astype(np.int32), int(counts.sum()) + W


SHAPES = [
    # (seed, L, W, live, unaligned): FLAC's mono and stereo frame rows, a
    # pile-up of narrow rows, rows wider than two tiles, a width that is not
    # a multiple of 4, a row exactly one tile wide
    (0, 1024, 4096, 900, True),
    (1, 2048, 8192, 1728, False),
    (2, 3000, 8, 200, True),
    (3, 300, 9000, 20, True),
    (4, 600, 4097, 40, True),
    (5, 700, 4096, 699, False),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"seed{s[0]}")
def test_plan_sizes1_cover_the_plan(shape):
    seed, L, W, n_live, unaligned = shape
    rng = np.random.default_rng(seed)
    starts, x = _pile_up(rng, L, W, n_live, unaligned)
    for n_out in (x, x // 2 + 3, x + 3 * PW.TILE1 + 1):
        plan = PW.plan_sizes1(L, W, n_out)
        units = _units(starts, W, n_out)
        assert plan.nt == len(units)
        assert int(units[units > 1].sum()) <= plan.heavy
        _check_layout(plan, L)


@pytest.mark.parametrize("L,W,n_out", [
    (0, 8192, 4099),        # no lanes: every tile writes zeros
    (6, 8192, 0),           # n_out = 0: no tile
    (5, 0, 100),            # empty rows
    (40, 1, 7),             # one-element rows, a part of a tile
    (1, 4096, 4096),        # one row, one tile
    (PW.MAX_CHUNKS * PW.RUN_CHUNK + 1, 4, 3),  # starts past the chunk limit
])
def test_plan_sizes1_edges(L, W, n_out):
    plan = PW.plan_sizes1(L, W, n_out)
    assert plan.nt == -(-n_out // PW.TILE1)
    _check_layout(plan, L)
    if L > PW.MAX_CHUNKS * PW.RUN_CHUNK:
        assert plan.chunk == 2 * PW.RUN_CHUNK


def test_plan_sizes1_cover_random_contract_inputs():
    rng = np.random.default_rng(19)
    for _ in range(20):
        W = int(rng.choice([3, 8, 96, 1024, 4095, 4096, 8192, 9000]))
        L = int(rng.integers(1, 3000))
        starts, _upd, n_out = window_case(rng, L, 1, int(rng.integers(0, L + 1)))
        starts = (starts.astype(np.int64) * rng.integers(1, W + 1)).astype(np.int32)
        n_out = int(starts.max()) + W + int(rng.integers(0, 9000))
        plan = PW.plan_sizes1(L, W, n_out)
        units = _units(starts, W, n_out)
        assert int(units[units > 1].sum()) <= plan.heavy


def test_constants_match_the_kernel_source():
    src = open(CU).read()

    def const(name):
        return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);",
                             src).group(1))

    assert const("kTile") == PW.TILE1
    assert const("kUnitWork") == PW.UNIT_WORK1
    assert "constexpr int kRowWork = kTile / 4;" in src
    assert PW.ROW_WORK1 == PW.TILE1 // 4
    assert const("kRunChunk") == PW.RUN_CHUNK
    assert const("kMaxChunks") == PW.MAX_CHUNKS
    names = re.search(r"void\* const ws\[\d+\] = \{(.*?)\};", src, re.S).group(1)
    assert [n.strip() for n in names.split(",")] == [n for n, _ in PW.WS_PARTS1]


class _Failing:
    calls = 0

    @classmethod
    def window_add_launch(cls, *args):
        cls.calls += 1
        return 700  # cudaErrorIllegalAddress


def test_wrapper_raises_on_a_launch_or_build_error(monkeypatch):
    """No fallback: a CUDA error from the launch raises and counts no
    launch, and so does a library that cannot be built."""
    s = torch.zeros(4, dtype=torch.int32)
    u = torch.zeros((4, 8), dtype=torch.float32)
    before = PW.launches["window_add"]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        PW._window_add1_cuda(s, u, 16, lib=_Failing, stream=0)
    assert PW.launches["window_add"] == before

    def no_nvcc():
        raise build.BuildError("nvcc not found")

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    with pytest.raises(build.BuildError):
        PW._window_add1_cuda(s, u, 16, stream=0)


@pytest.mark.parametrize("bad,match", [
    ("starts-int64", "int32"),
    ("upd-float64", "int32 or float32"),
    ("upd-1d", r"\[L, W\]"),
    ("rows-mismatch", r"\[L, W\]"),
    ("not-contiguous", "contiguous"),
    ("n-out-negative", "n_out"),
    ("n-out-2-31", "n_out"),
])
def test_wrapper_checks_its_inputs_before_launching(bad, match):
    s = torch.zeros(4, dtype=torch.int32)
    u = torch.zeros((4, 8), dtype=torch.int32)
    n_out = 16
    if bad == "starts-int64":
        s = s.to(torch.int64)
    elif bad == "upd-float64":
        u = u.to(torch.float64)
    elif bad == "upd-1d":
        u = u.reshape(-1)
    elif bad == "rows-mismatch":
        u = u[:3]
    elif bad == "not-contiguous":
        u = torch.zeros((8, 4), dtype=torch.int32).t()
    elif bad == "n-out-negative":
        n_out = -1
    else:
        n_out = 2**31
    calls = _Failing.calls
    with pytest.raises(ValueError, match=match):
        PW._window_add1_cuda(s, u, n_out, lib=_Failing, stream=0)
    assert _Failing.calls == calls

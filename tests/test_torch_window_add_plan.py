"""PyTorch port, K3 and K5 (``csrc/window_add.cu``): the wrappers'
host-side sizing and their failure paths, on the CPU.

The kernel's plan runs on the card, so here a numpy re-count of it — each
output tile's lane run by ``searchsorted`` on the running maximum of the
starts, and its units of ``UNIT_WORK1`` lane-elements, a lane counting at
least ``ROW_WORK1`` — is held against the workspace and grid that
``plan_sizes1`` derives from the shapes alone: the heavy tiles' units must
fit the bound the kernel gets.  At the 16-file FLAC group's shapes the
re-count also pins the tiles the kernel's design rests on: one-row tiles,
tiles with no lane, and two pile-up tiles of 321 rows.  For K5 (several
lane sets, one per data shard) the re-count searches each set's own running
maximum, as the kernel's plan does, and is itself held against a brute-force
overlap count.
"""

import os
import re

import numpy as np
import pytest
import torch

from audio_decoder_tpu_torch.ops import window_add as PW
from audio_decoder_tpu_torch.utils import build

from .test_torch_cuda import spmd_shards, window_case

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


# ------------------------------------------------- K5: several lane sets


def _spmd_runs(shards, W, n_out):
    """The K5 plan's per-set binary search, in numpy: per output tile of
    TILE1 elements and per lane set, the run [lo, hi) of the set's lanes
    whose window overlaps the tile, by ``searchsorted`` on the set's own
    running maximum.  Returns int64 [nt, sets, 2]."""
    T = PW.TILE1
    t0 = np.arange(-(-n_out // T), dtype=np.int64) * T
    runs = np.zeros((len(t0), len(shards), 2), np.int64)
    for k, st in enumerate(shards):
        if len(st) and W:
            s = np.maximum.accumulate(st.astype(np.int64))
            runs[:, k, 0] = np.searchsorted(s, t0 - W + 1)
            runs[:, k, 1] = np.searchsorted(s, t0 + T)
    return runs


def _spmd_units(runs, W):
    """Per tile, its lanes over all sets and its units as the plan counts
    them."""
    n = (runs[:, :, 1] - runs[:, :, 0]).sum(1)
    work = n * max(min(W, PW.TILE1), PW.ROW_WORK1)
    return n, np.maximum(np.minimum(-(-work // PW.UNIT_WORK1),
                                    np.maximum(n, 1)), 1)


def _check_spmd_layout(plan, lengths):
    sizes = {"sorted": sum(lengths),
             "cmax": sum(-(-L // plan.chunk) for L in lengths),
             "recs": plan.nt, "tcnt": plan.nt, "heavy_total": 1,
             "unit_tile": plan.heavy, "gcnt": plan.heavy,
             "scratch": plan.heavy * PW.TILE1, "runs": plan.nt * len(lengths)}
    ends = list(plan.offsets[1:]) + [plan.nbytes]
    for (name, size), at, end in zip(PW.WS_PARTS_SPMD, plan.offsets, ends):
        assert at % 256 == 0, name
        assert end - at >= sizes[name] * size, name
    assert sizes["cmax"] <= PW.MAX_CHUNKS
    assert plan.chunk >= PW.RUN_CHUNK and plan.chunk & (plan.chunk - 1) == 0


def test_spmd_runs_model_matches_a_brute_force_overlap():
    """The model of the per-set search gives, for every tile and set,
    exactly the lanes whose re-pointed window overlaps the tile: shards
    out of order, a padding-only shard, a start below the lane before it."""
    rng = np.random.default_rng(23)
    shards, n_out = spmd_shards(rng, [40, 40, 40], 5000, [30, 0, 40],
                                order=[2, 0, 1])
    starts = [st.copy() for st, _ in shards]
    starts[2][7] = starts[2][6] - 11
    W = 5000
    runs = _spmd_runs(starts, W, n_out)
    for k, st in enumerate(starts):
        s = np.maximum.accumulate(st.astype(np.int64))
        for t in range(runs.shape[0]):
            t0 = t * PW.TILE1
            hit = np.nonzero((s < t0 + PW.TILE1) & (s + W > t0))[0]
            lo, hi = runs[t, k]
            assert hit.tolist() == list(range(lo, hi)), (t, k)


def test_plan_sizes_spmd_at_the_flac_group():
    """K5 at the 16-file FLAC group's PCM rows over 4 data shards of 512:
    the tiles K3 sees on the whole group (642 without a lane, 3,454 of one
    row, 2 pile-ups of 321), none of them with rows of two shards; the
    heavy units fit the bound; the values calls' shapes size too."""
    starts, W, n_out = _flac_group_starts()
    shards = [starts[i * 512:(i + 1) * 512] for i in range(4)]
    plan = PW.plan_sizes_spmd((512,) * 4, W, n_out)
    runs = _spmd_runs(shards, W, n_out)
    n, units = _spmd_units(runs, W)
    assert plan.nt == len(n) == 4098
    rows, tiles = np.unique(n, return_counts=True)
    assert dict(zip(rows.tolist(), tiles.tolist())) == {0: 642, 1: 3454, 321: 2}
    sets_hit = ((runs[:, :, 1] - runs[:, :, 0]) > 0).sum(1)
    assert sets_hit.max() == 1
    assert int(units[units > 1].sum()) == 82 <= plan.heavy
    assert (plan.heavy, plan.chunk) == (PW.plan_sizes1(2048, W, n_out).heavy,
                                        PW.RUN_CHUNK)
    _check_spmd_layout(plan, (512,) * 4)
    for lengths, w in (((16384,) * 4, 256), ((1024,) * 4, 8)):
        vals = PW.plan_sizes_spmd(lengths, w, 4_207_616)
        assert vals.nt == -(-4_207_616 // PW.TILE1)
        _check_spmd_layout(vals, lengths)


@pytest.mark.parametrize("seed", range(6))
def test_plan_sizes_spmd_cover_the_plan(seed):
    """Random shards under the contract (1 to 8 sets, out of order, some
    padding-only, narrow to wide rows): the heavy tiles' units fit the
    bound that ``plan_sizes_spmd`` derives from the shapes alone, also
    with the padding pile-ups of every shard on one tile."""
    rng = np.random.default_rng(seed)
    S = int(rng.integers(1, 9))
    W = int(rng.choice([3, 8, 256, 4095, 8192, 9000]))
    lanes = [int(x) for x in rng.integers(0, 700, size=S)]
    live = [int(rng.integers(0, L + 1)) for L in lanes]
    shards, n_out = spmd_shards(rng, lanes, W, live,
                                order=rng.permutation(S).tolist())
    starts = [st for st, _ in shards]
    for n in (n_out, n_out // 2 + 3, 4099):
        plan = PW.plan_sizes_spmd(tuple(lanes), W, n)
        _, units = _spmd_units(_spmd_runs(starts, W, n), W)
        assert plan.nt == len(units)
        assert int(units[units > 1].sum()) <= plan.heavy
        _check_spmd_layout(plan, lanes)
    piled = [np.zeros(L, np.int32) for L in lanes]  # every lane on start 0
    _, units = _spmd_units(_spmd_runs(piled, W, 4099), W)
    assert int(units[units > 1].sum()) <= PW.plan_sizes_spmd(
        tuple(lanes), W, 4099).heavy


def test_spmd_constants_match_the_kernel_source():
    src = open(CU).read()
    assert int(re.search(r"constexpr int kMaxSets = (\d+);", src).group(1)) \
        == PW.MAX_SETS
    arrays = re.findall(r"void\* const ws\[\d+\] = \{(.*?)\};", src, re.S)
    assert [n.strip() for n in arrays[-1].split(",")] == [
        n for n, _ in PW.WS_PARTS_SPMD]


class _FailingSpmd:
    calls = 0

    @classmethod
    def window_add_spmd_launch(cls, *args):
        cls.calls += 1
        return 700  # cudaErrorIllegalAddress


def test_spmd_wrapper_raises_on_a_launch_or_build_error(monkeypatch):
    """No fallback for K5 either: a CUDA error raises and counts no launch,
    and so does a library that cannot be built."""
    sets = [(torch.zeros(4, dtype=torch.int32),
             torch.zeros((4, 8), dtype=torch.float32))] * 3
    before = PW.launches["window_add_spmd_kernel"]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        PW._window_add_spmd_cuda(sets, 16, lib=_FailingSpmd, stream=0)
    assert PW.launches["window_add_spmd_kernel"] == before

    def no_nvcc():
        raise build.BuildError("nvcc not found")

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    with pytest.raises(build.BuildError):
        PW._window_add_spmd_cuda(sets, 16, stream=0)


@pytest.mark.parametrize("bad,match", [
    ("widths", "one width"),
    ("dtypes", "one dtype"),
    ("starts-int64", "int32"),
    ("not-contiguous", "contiguous"),
    ("too-many-sets", "lane sets"),
    ("n-out-negative", "n_out"),
])
def test_spmd_wrapper_checks_its_inputs_before_launching(bad, match):
    s = torch.zeros(4, dtype=torch.int32)
    u = torch.zeros((4, 8), dtype=torch.int32)
    sets, n_out = [(s, u), (s, u)], 16
    if bad == "widths":
        sets[1] = (s, torch.zeros((4, 12), dtype=torch.int32))
    elif bad == "dtypes":
        sets[1] = (s, u.float())
    elif bad == "starts-int64":
        sets[1] = (s.long(), u)
    elif bad == "not-contiguous":
        sets[1] = (s, torch.zeros((8, 4), dtype=torch.int32).t())
    elif bad == "too-many-sets":
        sets = [(s, u)] * (PW.MAX_SETS + 1)
    else:
        n_out = -1
    calls = _FailingSpmd.calls
    with pytest.raises(ValueError, match=match):
        PW._window_add_spmd_cuda(sets, n_out, lib=_FailingSpmd, stream=0)
    assert _FailingSpmd.calls == calls

"""Contiguous-window scatter-add: CUDA kernel wrappers and plain twins.

``window_add(starts, upd, n_out)`` computes ``out[starts[l] + i] +=
upd[l, i]`` into a flat ``[n_out]`` array (int32 or float32), dropping
what falls past ``n_out``; ``window_add2`` does the same for two lane
sets of different window widths into one output.  They are the ports of
the JAX package's Pallas kernels ``ops/window_add.py::window_add`` (K3)
and ``window_add2`` (K4), which FLAC uses to assemble its values and its
PCM.

The contract is the TPU kernels': starts non-decreasing over the live
lanes; padding lanes carry zero updates and may sit at the tail with
start 0.  Every start is re-pointed through a running maximum, so a
padding lane adds its zeros at the last live start.  In FLAC the live
windows tile the output, so every output element gets at most one
nonzero term and the result is exact in int32 and in float32.

For CUDA tensors the wrappers launch their kernels (built with nvcc for
sm_90a at first use) on the current stream, without synchronising, each
with one host call: ``window_add`` the three kernels of
``csrc/window_add.cu``, ``window_add2`` the three kernels of
``csrc/window_add2.cu``, each over one workspace sized here from the shapes
alone (``plan_sizes1``, ``plan_sizes``).  A failed launch raises; nothing
falls back.  For CPU tensors they run the plain twins.  Any other device
raises.  ``launches`` counts wrapper calls that launched their kernels.

``window_add_spmd`` is the port of the mesh-sharded ``window_add_spmd``
(K5): on each card one launch of ``csrc/window_add.cu``'s kernels over
every data shard there (each shard one lane set, in its own allocation or
not; the workspace from ``plan_sizes_spmd``), which writes each output
element once; only the per-card results meet in ``psum``
(parallel/mesh.py), which adds nothing on one card.
``window_add_spmd_plain`` is its plain twin.  K3 is the one-set case of
the same kernels.
"""

from __future__ import annotations

import ctypes as C
import functools
from typing import NamedTuple

import torch

from ..utils import build

#: times each CUDA kernel was launched in this process
#: (``window_add_spmd``: wrapper calls that launched on a card;
#: ``window_add_spmd_kernel``: its launches, one per card)
launches = {"window_add": 0, "window_add2": 0, "window_add_spmd": 0,
            "window_add_spmd_kernel": 0}


#: window_add.cu's output tile, the lane-elements of one unit of work and
#: the least work a lane counts (checked against the library when it loads)
TILE1 = 4096
UNIT_WORK1 = 32768
ROW_WORK1 = 1024
#: window_add.cu's workspace, in order: (name, element bytes)
WS_PARTS1 = (("sorted", 4), ("cmax", 4), ("recs", 16), ("tcnt", 4),
             ("heavy_total", 4), ("unit_tile", 4), ("gcnt", 4), ("scratch", 4))
#: K5's workspace: K3's, then each tile's run per lane set
WS_PARTS_SPMD = WS_PARTS1 + (("runs", 8),)
#: lane sets (data shards on one card) one K5 launch takes
MAX_SETS = 64


def _declare(lib: C.CDLL) -> None:
    p, i, ll = C.c_void_p, C.c_int, C.c_longlong
    lib.window_add_tile.restype = i
    lib.window_add_tile.argtypes = []
    lib.window_add_unit_work.restype = ll
    lib.window_add_unit_work.argtypes = []
    lib.window_add_launch.restype = i
    lib.window_add_launch.argtypes = ([p, i, p, i, ll, i, p]
                                      + [p] * len(WS_PARTS1) + [i, i, p])
    lib.window_add_spmd_launch.restype = i
    lib.window_add_spmd_launch.argtypes = (
        [i, C.POINTER(p), C.POINTER(p), C.POINTER(i), i, ll, i, p]
        + [p] * len(WS_PARTS_SPMD) + [i, i, p])
    lib.window_add_max_sets.restype = i
    lib.window_add_max_sets.argtypes = []
    lib.window_add_blocks_per_sm.restype = i
    lib.window_add_blocks_per_sm.argtypes = []
    got = (lib.window_add_tile(), lib.window_add_unit_work(),
           lib.window_add_max_sets())
    if got != (TILE1, UNIT_WORK1, MAX_SETS):
        raise build.BuildError(f"window_add: the library's tile, unit and "
                               f"sets {got} differ from ({TILE1}, "
                               f"{UNIT_WORK1}, {MAX_SETS})")


#: window_add2.cu's output tile, the lane-elements of one unit of work and
#: the least work a lane counts (checked against the library when it loads)
TILE2 = 4096
UNIT_WORK2 = 16384
ROW_WORK2 = 256
#: starts per running-max chunk (doubled until at most MAX_CHUNKS chunks)
RUN_CHUNK = 2048
MAX_CHUNKS = 4096
#: window_add2.cu's workspace, in order: (name, element bytes)
WS_PARTS = (("sorted", 4), ("cmax", 4), ("ranges", 16), ("tile_off", 4),
            ("tcnt", 4), ("heavy_total", 4), ("unit_tile", 4), ("gcnt", 4),
            ("part_range", 8), ("scratch", 4))


def _declare2(lib: C.CDLL) -> None:
    p, i, ll = C.c_void_p, C.c_int, C.c_longlong
    lib.window_add2_tile.restype = i
    lib.window_add2_tile.argtypes = []
    lib.window_add2_unit_work.restype = ll
    lib.window_add2_unit_work.argtypes = []
    lib.window_add2_launch.restype = i
    lib.window_add2_launch.argtypes = ([p, i, p, i, p, i, p, i, ll, i, p]
                                       + [p] * len(WS_PARTS) + [i, i, p])
    lib.window_add2_blocks_per_sm.restype = i
    lib.window_add2_blocks_per_sm.argtypes = []
    got = (lib.window_add2_tile(), lib.window_add2_unit_work())
    if got != (TILE2, UNIT_WORK2):
        raise build.BuildError(f"window_add2: the library's tile and unit "
                               f"{got} differ from ({TILE2}, {UNIT_WORK2})")


def load_library() -> C.CDLL:
    """Build (first use) and load K3's and K5's kernel library."""
    return build.load_cuda_kernels("window_add", _declare)


def load_library2() -> C.CDLL:
    """Build (first use) and load K4's kernel library."""
    return build.load_cuda_kernels("window_add2", _declare2)


class Plan(NamedTuple):
    nt: int        # output tiles
    heavy: int     # bound on the heavy tiles' units (scratch tiles)
    chunk: int     # starts per running-max chunk
    offsets: tuple  # byte offset of each workspace part
    nbytes: int    # the workspace's bytes


def _chunk(*lengths: int) -> int:
    """Starts per running-max chunk: a power of two, doubled until the
    lane sets have at most MAX_CHUNKS chunks in all."""
    chunk = RUN_CHUNK
    while sum(-(-n // chunk) for n in lengths) > MAX_CHUNKS:
        chunk *= 2
    return chunk


def _heavy_bound(sets, tile: int, row_work: int, unit_work: int) -> int:
    """Bound on the units of all heavy tiles.  The plan counts a tile's work
    as its lanes times max(min(W, tile), row_work); a lane overlaps at most
    ceil((W - 1) / tile) + 1 tiles, so the work of all tiles is at most
    ``spread``.  A heavy tile (work w > unit_work) takes ceil(w / unit_work)
    < 2w / unit_work units, each with a scratch tile."""
    spread = sum(L * (-(-(W - 1) // tile) + 1) * max(min(W, tile), row_work)
                 for L, W in sets if W)
    return 2 * (spread // unit_work) + 2


def _layout(nt: int, heavy: int, chunk: int, parts, counts: dict) -> Plan:
    """The workspace's parts in order, each 256-byte aligned."""
    offsets, at = [], 0
    for name, size in parts:
        offsets.append(at)
        at += -(-counts[name] * size // 256) * 256
    return Plan(nt, heavy, chunk, tuple(offsets), at)


@functools.lru_cache(maxsize=64)
def plan_sizes1(L: int, W: int, n_out: int) -> Plan:
    """window_add.cu's grid and workspace (K3, one lane set) from the
    shapes alone: ``heavy`` scratch tiles of TILE1 elements for the heavy
    tiles' unit partials."""
    nt = -(-n_out // TILE1)
    heavy = _heavy_bound([(L, W)], TILE1, ROW_WORK1, UNIT_WORK1)
    chunk = _chunk(L)
    counts = {"sorted": L, "cmax": -(-L // chunk), "recs": nt, "tcnt": nt,
              "heavy_total": 1, "unit_tile": heavy, "gcnt": heavy,
              "scratch": heavy * TILE1}
    return _layout(nt, heavy, chunk, WS_PARTS1, counts)


@functools.lru_cache(maxsize=64)
def plan_sizes_spmd(lengths: tuple, W: int, n_out: int) -> Plan:
    """window_add.cu's grid and workspace for K5's lane sets of ``lengths``
    lanes each (one width): K3's sizing over all the sets' lanes, plus
    each tile's run per set."""
    nt = -(-n_out // TILE1)
    heavy = _heavy_bound([(L, W) for L in lengths], TILE1, ROW_WORK1,
                         UNIT_WORK1)
    chunk = _chunk(*lengths)
    counts = {"sorted": sum(lengths),
              "cmax": sum(-(-L // chunk) for L in lengths), "recs": nt,
              "tcnt": nt, "heavy_total": 1, "unit_tile": heavy,
              "gcnt": heavy, "scratch": heavy * TILE1,
              "runs": nt * len(lengths)}
    return _layout(nt, heavy, chunk, WS_PARTS_SPMD, counts)


@functools.lru_cache(maxsize=64)
def plan_sizes(La: int, Wa: int, Lb: int, Wb: int, n_out: int) -> Plan:
    """window_add2.cu's grid and workspace (K4, two lane sets) from the
    shapes alone: ``heavy`` scratch tiles of TILE2 elements for the heavy
    tiles' unit partials."""
    nt = -(-n_out // TILE2)
    heavy = _heavy_bound([(La, Wa), (Lb, Wb)], TILE2, ROW_WORK2, UNIT_WORK2)
    chunk = _chunk(La, Lb)
    counts = {"sorted": La + Lb, "cmax": -(-La // chunk) + -(-Lb // chunk),
              "ranges": nt, "tile_off": nt, "tcnt": nt, "heavy_total": 1,
              "unit_tile": heavy, "gcnt": heavy, "part_range": heavy,
              "scratch": heavy * TILE2}
    return _layout(nt, heavy, chunk, WS_PARTS, counts)


def _scatter_plain(out: torch.Tensor, starts: torch.Tensor,
                   upd: torch.Tensor) -> None:
    """Add every lane's window into ``out`` (one spare slot at its end
    takes what falls past the output), in lane order."""
    n = out.shape[0] - 1
    L, W = upd.shape
    if L == 0 or W == 0:
        return
    s = torch.cummax(starts.to(torch.int64), 0).values
    idx = s[:, None] + torch.arange(W, dtype=torch.int64, device=upd.device)
    out.index_add_(0, idx.clamp_(max=n).reshape(-1), upd.reshape(-1))


def window_add_plain(starts: torch.Tensor, upd: torch.Tensor,
                     n_out: int) -> torch.Tensor:
    """Plain torch K3: ``index_add_`` of every window, truncated to n_out."""
    out = torch.zeros((n_out + 1,), dtype=upd.dtype, device=upd.device)
    _scatter_plain(out, starts, upd)
    return out[:n_out]


def window_add2_plain(starts_a: torch.Tensor, upd_a: torch.Tensor,
                      starts_b: torch.Tensor, upd_b: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """Plain torch K4: set a's windows, then set b's, into one output."""
    out = torch.zeros((n_out + 1,), dtype=upd_a.dtype, device=upd_a.device)
    _scatter_plain(out, starts_a, upd_a)
    _scatter_plain(out, starts_b, upd_b)
    return out[:n_out]


def _check_set(name: str, starts, upd, dev, dtype) -> None:
    if starts.dtype != torch.int32 or starts.dim() != 1:
        raise ValueError(f"{name}: starts must be int32 [L], got {starts.dtype} "
                         f"{tuple(starts.shape)}")
    if upd.dim() != 2 or upd.shape[0] != starts.shape[0]:
        raise ValueError(f"{name}: upd must be [L, W] with L = "
                         f"{starts.shape[0]}, got {tuple(upd.shape)}")
    if upd.dtype != dtype or dtype not in (torch.int32, torch.float32):
        raise ValueError(f"{name}: upd must be int32 or float32 (one dtype for "
                         f"both sets), got {upd.dtype}")
    for t in (starts, upd):
        if t.device != dev:
            raise ValueError(f"{name}: inputs must share one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _card(dev: torch.device):
    """Make the tensors' card current for a launch (a ctypes launch runs on
    the current card); no-op for the CPU tensors of the wrappers' tests."""
    return torch.cuda.device(dev if dev.type == "cuda" else -1)


def _window_add1_cuda(starts: torch.Tensor, upd: torch.Tensor, n_out: int,
                      lib=None, stream=None) -> torch.Tensor:
    """Launch ``csrc/window_add.cu`` (or ``lib``, a library with its
    interface) for one lane set on ``stream`` (default: the current one)."""
    dev = upd.device
    _check_set("window_add", starts, upd, dev, upd.dtype)
    if not 0 <= n_out < 2**31:
        raise ValueError(f"window_add: n_out must be in [0, 2^31), got {n_out}")
    lib = lib or load_library()
    L, W = upd.shape
    plan = plan_sizes1(L, W, n_out)
    ws = torch.empty((plan.nbytes,), dtype=torch.uint8, device=dev)
    out = torch.empty((n_out,), dtype=upd.dtype, device=dev)
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    base = ws.data_ptr()
    with _card(dev):
        rc = lib.window_add_launch(
            starts.data_ptr(), L, upd.data_ptr(), W, n_out,
            int(upd.dtype == torch.float32), out.data_ptr(),
            *[base + o for o in plan.offsets], plan.chunk, plan.heavy, stream)
    if rc != 0:
        raise RuntimeError(f"window_add launch failed: CUDA error {rc}")
    launches["window_add"] += 1
    return out


def _window_add_spmd_cuda(sets, n_out: int, lib=None,
                          stream=None) -> torch.Tensor:
    """Launch ``csrc/window_add.cu``'s K5 (or ``lib``, a library with its
    interface) once for the lane sets ``sets`` [(starts, upd), ...] of one
    card (each set one data shard, in its own allocation or not) on
    ``stream`` (default: the current one): their sum, written once."""
    dev, dtype = sets[0][1].device, sets[0][1].dtype
    W = sets[0][1].shape[-1]
    for s, u in sets:  # one test per set; _check_set names a fault
        if not (s.dtype == torch.int32 and u.dtype == dtype and s.dim() == 1
                and u.dim() == 2 and u.shape[0] == s.shape[0]
                and u.shape[1] == W and s.device == dev and u.device == dev
                and s.is_contiguous() and u.is_contiguous()):
            _check_set("window_add_spmd", s, u, dev, dtype)
            raise ValueError(f"window_add_spmd: one width for every set, got "
                             f"{[tuple(v.shape) for _, v in sets]}")
    if dtype not in (torch.int32, torch.float32):
        _check_set("window_add_spmd", *sets[0], dev, dtype)
    if not 1 <= len(sets) <= MAX_SETS:
        raise ValueError(f"window_add_spmd: 1 to {MAX_SETS} lane sets per "
                         f"card, got {len(sets)}")
    if not 0 <= n_out < 2**31:
        raise ValueError(f"window_add_spmd: n_out must be in [0, 2^31), got "
                         f"{n_out}")
    lib = lib or load_library()
    lengths = tuple(int(s.shape[0]) for s, _ in sets)
    plan = plan_sizes_spmd(lengths, W, n_out)
    ws = torch.empty((plan.nbytes,), dtype=torch.uint8, device=dev)
    out = torch.empty((n_out,), dtype=dtype, device=dev)
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    n = len(sets)
    starts = (C.c_void_p * n)(*[s.data_ptr() for s, _ in sets])
    upd = (C.c_void_p * n)(*[u.data_ptr() for _, u in sets])
    lens = (C.c_int * n)(*lengths)
    base = ws.data_ptr()
    with _card(dev):
        rc = lib.window_add_spmd_launch(
            n, starts, upd, lens, W, n_out, int(dtype == torch.float32),
            out.data_ptr(), *[base + o for o in plan.offsets], plan.chunk,
            plan.heavy, stream)
    if rc != 0:
        raise RuntimeError(f"window_add_spmd launch failed: CUDA error {rc}")
    launches["window_add_spmd_kernel"] += 1
    return out


def _window_add2_cuda(sets, n_out: int, lib=None, stream=None) -> torch.Tensor:
    """Launch ``csrc/window_add2.cu`` (or ``lib``, a library with its
    interface) for two lane sets on ``stream`` (default: the current one)."""
    dev, dtype = sets[0][1].device, sets[0][1].dtype
    for s, u in sets:
        _check_set("window_add2", s, u, dev, dtype)
    if not 0 <= n_out < 2**31:
        raise ValueError(f"window_add2: n_out must be in [0, 2^31), got {n_out}")
    lib = lib or load_library2()
    (sa, ua), (sb, ub) = sets
    plan = plan_sizes(sa.shape[0], ua.shape[1], sb.shape[0], ub.shape[1], n_out)
    ws = torch.empty((plan.nbytes,), dtype=torch.uint8, device=dev)
    out = torch.empty((n_out,), dtype=dtype, device=dev)
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    base = ws.data_ptr()
    with _card(dev):
        rc = lib.window_add2_launch(
            sa.data_ptr(), sa.shape[0], ua.data_ptr(), ua.shape[1],
            sb.data_ptr(), sb.shape[0], ub.data_ptr(), ub.shape[1], n_out,
            int(dtype == torch.float32), out.data_ptr(),
            *[base + o for o in plan.offsets], plan.chunk, plan.heavy,
            stream)
    if rc != 0:
        raise RuntimeError(f"window_add2 launch failed: CUDA error {rc}")
    launches["window_add2"] += 1
    return out


def _dispatch(name: str, plain, sets, n_out: int, cuda) -> torch.Tensor:
    dev = sets[0][1].device
    if dev.type == "cpu":
        return plain(*[t for s in sets for t in s], n_out)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return cuda(sets, n_out)


def window_add(starts: torch.Tensor, upd: torch.Tensor,
               n_out: int) -> torch.Tensor:
    """``out[starts[l] + i] += upd[l, i]`` → flat ``[n_out]`` (K3)."""
    return _dispatch("window_add", window_add_plain, [(starts, upd)], n_out,
                     lambda sets, n: _window_add1_cuda(*sets[0], n))


def window_add2(starts_a: torch.Tensor, upd_a: torch.Tensor,
                starts_b: torch.Tensor, upd_b: torch.Tensor,
                n_out: int) -> torch.Tensor:
    """Two lane sets into one ``[n_out]`` output, each element written once
    (K4); equal to ``window_add(a) + window_add(b)`` under the contract."""
    return _dispatch("window_add2", window_add2_plain,
                     [(starts_a, upd_a), (starts_b, upd_b)], n_out,
                     _window_add2_cuda)


def window_add_spmd_plain(shard_starts, shard_upd, n_out: int) -> torch.Tensor:
    """Plain torch K5: ``window_add_plain`` of each shard, summed in shard
    order (the JAX package's psum of full-size partials)."""
    out = None
    for s, u in zip(shard_starts, shard_upd):
        part = window_add_plain(s, u, n_out)
        out = part if out is None else out + part
    return out


def window_add_spmd(starts, upd, n_out: int, *, mesh, axis: str = "data",
                    to=None):
    """Mesh-sharded ``window_add`` (K5): lane-sharded inputs → the
    ``[n_out]`` sum replicated on every device of ``to`` (default: every
    mesh device), a ``Replicated``.

    ``starts``/``upd`` are ``Sharded`` over ``axis`` (or whole tensors,
    cut here).  K3's contract must hold per shard only; a shard of padding
    lanes only adds zeros.  The shards that share a device are summed
    there in shard order: on a card by one K5 launch over all of them, on
    the CPU by the plain twin.  The per-device sums then meet in one
    ``psum``, which adds only across cards.  In FLAC the live windows tile
    the output, so each element gets one nonzero term and the sum is
    exact."""
    from ..parallel import mesh as M

    s, u = M.shard(starts, mesh, axis), M.shard(upd, mesh, axis)
    per_device: dict = {}
    for a, b in zip(s.shards, u.shards):
        per_device.setdefault(b.device, []).append((a, b))
    sums = []
    for dev, sets in per_device.items():
        if dev.type == "cpu":
            sums.append(window_add_spmd_plain(*zip(*sets), n_out))
        elif dev.type == "cuda":
            sums.append(_window_add_spmd_cuda(sets, n_out))
        else:
            raise ValueError(f"window_add_spmd: unsupported device {dev}")
    out = M.psum(sums, mesh, to)
    if any(d.type == "cuda" for d in per_device):
        launches["window_add_spmd"] += 1
    return out

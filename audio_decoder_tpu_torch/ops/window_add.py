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
sm_90a at first use) on the current stream, without synchronising:
``window_add`` the plan and main kernels of ``csrc/window_add.cu``,
``window_add2`` the three kernels of ``csrc/window_add2.cu`` over one
workspace sized here from the shapes (``plan_sizes``).  For CPU tensors
they run the plain twins.  Any other device raises.  ``launches`` counts
wrapper calls that launched their kernels.
"""

from __future__ import annotations

import ctypes as C
import functools
from typing import NamedTuple

import torch

from ..utils import build

#: times each CUDA kernel was launched in this process
launches = {"window_add": 0, "window_add2": 0}


def _declare(lib: C.CDLL) -> None:
    p, i = C.c_void_p, C.c_int
    lib.window_add_tile.restype = i
    lib.window_add_tile.argtypes = []
    lib.window_add_unit_work.restype = C.c_longlong
    lib.window_add_unit_work.argtypes = []
    lib.window_add_plan_launch.restype = i
    lib.window_add_plan_launch.argtypes = [p, i, i, p, i, i, i, p, p, p, p, p, p]
    for fn in (lib.window_add_i32, lib.window_add_f32):
        fn.restype = i
        fn.argtypes = [p, p, i, p, p, i, p, p, i, C.c_longlong, i, p, p, p, p, p]


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
    """Build (first use) and load K3's kernel library."""
    return build.load_cuda_kernels("window_add", _declare)


def load_library2() -> C.CDLL:
    """Build (first use) and load K4's kernel library."""
    return build.load_cuda_kernels("window_add2", _declare2)


class Plan(NamedTuple):
    nt: int        # output tiles
    heavy: int     # bound on the heavy tiles' units (scratch tiles)
    chunk: int     # starts per running-max chunk
    offsets: tuple  # byte offset of each WS_PARTS part in the workspace
    nbytes: int    # the workspace's bytes


@functools.lru_cache(maxsize=64)
def plan_sizes(La: int, Wa: int, Lb: int, Wb: int, n_out: int) -> Plan:
    """window_add2.cu's grid and workspace from the shapes alone.

    The plan counts a tile's work as its lanes times max(min(W, TILE2),
    ROW_WORK2); a lane overlaps at most ceil((W - 1) / TILE2) + 1 tiles,
    so the work of all tiles is at most ``spread``.  A heavy tile (work
    w > UNIT_WORK2) takes ceil(w / UNIT_WORK2) < 2w / UNIT_WORK2 units,
    each with a scratch tile: ``heavy`` bounds the units of all heavy
    tiles.  Workspace parts are 256-byte aligned."""
    nt = -(-n_out // TILE2)
    spread = sum(L * (-(-(W - 1) // TILE2) + 1) * max(min(W, TILE2), ROW_WORK2)
                 for L, W in ((La, Wa), (Lb, Wb)) if W)
    heavy = 2 * (spread // UNIT_WORK2) + 2
    chunk = RUN_CHUNK  # a power of two
    while -(-La // chunk) + -(-Lb // chunk) > MAX_CHUNKS:
        chunk *= 2
    counts = {"sorted": La + Lb, "cmax": -(-La // chunk) + -(-Lb // chunk),
              "ranges": nt, "tile_off": nt, "tcnt": nt, "heavy_total": 1,
              "unit_tile": heavy, "gcnt": heavy, "part_range": heavy,
              "scratch": heavy * TILE2}
    offsets, at = [], 0
    for name, size in WS_PARTS:
        offsets.append(at)
        at += -(-counts[name] * size // 256) * 256
    return Plan(nt, heavy, chunk, tuple(offsets), at)


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


def _window_add_cuda(name: str, sets, n_out: int, lib=None) -> torch.Tensor:
    """Launch the plan and main kernels of ``csrc/window_add.cu`` (or of
    ``lib``, a library with its interface) for one or two lane sets: K3,
    and K4 as its first design (tools/torch_kernel_ab.py)."""
    dev, dtype = sets[0][1].device, sets[0][1].dtype
    for s, u in sets:
        _check_set(name, s, u, dev, dtype)
    if not 0 <= n_out < 2**31:
        raise ValueError(f"{name}: n_out must be in [0, 2^31), got {n_out}")
    lib = lib or load_library()
    tile, unit_work = lib.window_add_tile(), lib.window_add_unit_work()
    if len(sets) == 1:  # K3: set b is empty
        sets = sets + [(sets[0][0][:0], sets[0][1][:0])]
    (sa, ua), (sb, ub) = sets
    La, Lb = sa.shape[0], sb.shape[0]
    nt = -(-n_out // tile)
    # the plan counts a tile's work as its lanes times min(W, tile); a lane
    # overlaps at most m tiles, so the work of all tiles is at most
    # `spread`.  A tile of work w > unit_work takes ceil(w / unit_work) < 2w
    # / unit_work blocks, each with a scratch tile: `heavy` bounds them.
    spread = sum(u.shape[0] * (-(-(u.shape[1] - 1) // tile) + 1)
                 * min(u.shape[1], tile) for u in (ua, ub) if u.shape[1])
    heavy = 2 * (spread // unit_work) + 2
    # the running maximum of the starts (the tail padding lanes re-pointed)
    sorted_ab = torch.empty((La + Lb,), dtype=torch.int32, device=dev)
    ranges = torch.empty((max(nt, 1), 4), dtype=torch.int32, device=dev)
    counts = torch.empty((nt + 1,), dtype=torch.int32, device=dev)
    counters = torch.empty((max(nt, 1),), dtype=torch.int32, device=dev)
    out = torch.empty((n_out,), dtype=dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.window_add_plan_launch(
        sa.data_ptr(), La, ua.shape[1], sb.data_ptr(), Lb, ub.shape[1], nt,
        sorted_ab.data_ptr(), sorted_ab[La:].data_ptr(), ranges.data_ptr(),
        counts.data_ptr(), counters.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} plan launch failed: CUDA error {rc}")
    slot_off = torch.cumsum(counts, dim=0, dtype=torch.int32)
    scratch = torch.empty((heavy, tile), dtype=dtype, device=dev)
    part_range = torch.empty((heavy, 2), dtype=torch.int32, device=dev)
    fn = lib.window_add_i32 if dtype == torch.int32 else lib.window_add_f32
    rc = fn(sorted_ab.data_ptr(), ua.data_ptr(), ua.shape[1],
            sorted_ab[La:].data_ptr(), ub.data_ptr(), ub.shape[1],
            ranges.data_ptr(), slot_off.data_ptr(), nt, n_out, heavy,
            out.data_ptr(), scratch.data_ptr(), part_range.data_ptr(),
            counters.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches[name] += 1
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
    rc = lib.window_add2_launch(
        sa.data_ptr(), sa.shape[0], ua.data_ptr(), ua.shape[1], sb.data_ptr(),
        sb.shape[0], ub.data_ptr(), ub.shape[1], n_out,
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
                     lambda sets, n: _window_add_cuda("window_add", sets, n))


def window_add2(starts_a: torch.Tensor, upd_a: torch.Tensor,
                starts_b: torch.Tensor, upd_b: torch.Tensor,
                n_out: int) -> torch.Tensor:
    """Two lane sets into one ``[n_out]`` output, each element written once
    (K4); equal to ``window_add(a) + window_add(b)`` under the contract."""
    return _dispatch("window_add2", window_add2_plain,
                     [(starts_a, upd_a), (starts_b, upd_b)], n_out,
                     _window_add2_cuda)

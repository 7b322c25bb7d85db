"""Time versions of the PyTorch port's CUDA kernels against each other.

Runs on one NVIDIA GPU, on the inputs ``chip_smoke.py`` gives the kernels:
the three entropy-scan (K1) launches of the 16-file stereo MP3 group's
buckets, the synthesis (K2) of the same group's subband samples, and the
FLAC value assembly (K4) and PCM assembly (K3) of the 16-file FLAC group.
Each version is a ``.cu`` source with the plain C interface of
``audio_decoder_tpu_torch/csrc/mp3_entropy.cu`` (K1), ``mp3_synth.cu``
(K2), ``window_add2.cu`` (K4) or ``window_add.cu`` (K3), built here with
the port's nvcc flags.  A version's tables or interface are named after a
colon:

* K1 ``two_level`` (the default): the interface of the source in the tree
  (``huffman_device``'s two-level table, its first-level bases and the
  count1 table); ``flat``: the first design's interface (the flat prefix
  LUT and its bases, the count1 threshold constants);
* K2 ``folded`` (the default): ``synth_kernel.fold_synth_n(SYNTH_N)``;
  ``full``: SYNTH_N itself (the first design's);
* K4 ``ws`` (the default): ``window_add2.cu``'s three launches over one
  workspace; ``plan``: the first design's interface (the first
  ``window_add.cu``, for both K3 and K4: its plan launch, ``torch.cumsum``,
  then its main kernel, launched by this tool's own copy of that sequence,
  ``first_design_call``);
* K3 ``ws`` (the default): ``window_add.cu``'s three launches over one
  workspace; ``k3only``: the same launches from a ``window_add.cu`` that
  holds K3 alone (the register-tiled design before K5 shared its
  kernels, ``git show 9ad55ba:audio_decoder_tpu_torch/csrc/window_add.cu``);
  ``plan``: the first design as above, one lane set; ``ws2``: a
  ``window_add2.cu`` source called with set b empty.

Every version is first held against the plain twin (K1 exactly, K2 within
atol 1e-4 / rtol 1e-5), then timed with CUDA events in turns (the versions
in order, then in reverse, ``--rounds`` times), each turn the mean of
``--reps`` back-to-back calls, which cannot go below the calls' host time;
then its kernel's device time per launch is read from torch.profiler over
``--reps`` calls.  K4 versions are held exactly against
``window_add2_plain`` on the group's inputs and on parts of them (the
lanes before the zero tails of padding lanes, each set's zero tail alone,
no lanes); each is timed by CUDA events on the whole group and on the
lanes before the zero tails, and every kernel of a call (K4 is one
wrapper call of up to four kernels) is listed with its device time per
call on each part.  With ``--k4``, K3 (``window_add``) is timed in the
same call, and so is a yardstick of the card's memory: a copy of set a's
updates.  K3 versions (``--k3``) are held exactly against
``window_add_plain`` on the group's PCM inputs and on probes of them (the
one-row tiles alone: the live frames packed end to end; the pile-up tiles
alone: the last live frame and the padding rows on one start; no lanes),
timed by CUDA events in turns on the group beside one ``index_add_`` call
of the same sum and a copy of the updates, with every kernel's device time
per call on each probe; the tiles' lane counts are printed first.  Prints
one line per version with its turns and device time, in milliseconds per
launch, beside the card's name and power limit, and writes them to
``kernel_ab.json`` in chip_smoke.py's output directory (``OUT_DIR``).

Usage (the first design's sources are in git history):
  git show cf3a5a4:audio_decoder_tpu_torch/csrc/mp3_entropy.cu > build/ab/k1_pr1.cu
  git show cf3a5a4:audio_decoder_tpu_torch/csrc/mp3_synth.cu > build/ab/k2_pr1.cu
  git show 727c5f2:audio_decoder_tpu_torch/csrc/window_add.cu > build/ab/window_add_first.cu
  python tools/torch_kernel_ab.py \\
      --k1 pr1=build/ab/k1_pr1.cu:flat \\
      --k1 new=audio_decoder_tpu_torch/csrc/mp3_entropy.cu \\
      --k2 pr1=build/ab/k2_pr1.cu:full \\
      --k2 new=audio_decoder_tpu_torch/csrc/mp3_synth.cu \\
      --k4 first=build/ab/window_add_first.cu:plan \\
      --k4 new=audio_decoder_tpu_torch/csrc/window_add2.cu \\
      --k3 first=build/ab/window_add_first.cu:plan \\
      --k3 k4=audio_decoder_tpu_torch/csrc/window_add2.cu:ws2 \\
      --k3 new=audio_decoder_tpu_torch/csrc/window_add.cu
"""

from __future__ import annotations

import argparse
import ctypes as C
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from audio_decoder_tpu_torch.codecs.mpeg import dsp  # noqa: E402
from audio_decoder_tpu_torch.codecs.mpeg import huffman_device as HD  # noqa: E402
from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel as HK  # noqa: E402
from audio_decoder_tpu_torch.ops import synth_kernel as SK  # noqa: E402
from audio_decoder_tpu_torch.ops import window_add as PW  # noqa: E402
from audio_decoder_tpu_torch.utils import build  # noqa: E402

TABLES = {"k1": ("two_level", "flat"), "k2": ("folded", "full"),
          "k4": ("ws", "plan"), "k3": ("ws", "plan", "ws2", "k3only")}


def parse_version(kernel: str, spec: str) -> tuple[str, str, str]:
    """``NAME=PATH[:TABLES]`` → (name, absolute path, tables)."""
    name, _, rest = spec.partition("=")
    path, _, tables = rest.partition(":")
    tables = tables or TABLES[kernel][0]
    if not name or not path or tables not in TABLES[kernel]:
        raise SystemExit(f"bad --{kernel} {spec!r}: want NAME=PATH[:"
                         f"{'|'.join(TABLES[kernel])}]")
    return name, os.path.abspath(path), tables


def _declare_flat(lib: C.CDLL) -> None:
    """The first K1 design's interface."""
    fn = lib.mp3_entropy_scan
    p, i = C.c_void_p, C.c_int
    fn.argtypes = ([p, i, i] + [p] * 10 + [p] * 6 + [i] * 5
                   + [C.c_longlong] * 3 + [p] * 4)
    fn.restype = C.c_int


def _declare_k3_only(lib: C.CDLL) -> None:
    """The interface of a ``window_add.cu`` that holds K3 alone (before K5
    shared its kernels): K3's launch, tile and unit."""
    p, i, ll = C.c_void_p, C.c_int, C.c_longlong
    lib.window_add_tile.restype = i
    lib.window_add_tile.argtypes = []
    lib.window_add_unit_work.restype = ll
    lib.window_add_unit_work.argtypes = []
    lib.window_add_launch.restype = i
    lib.window_add_launch.argtypes = ([p, i, p, i, ll, i, p]
                                      + [p] * len(PW.WS_PARTS1) + [i, i, p])
    lib.window_add_blocks_per_sm.restype = i
    lib.window_add_blocks_per_sm.argtypes = []


def _declare_first(lib: C.CDLL) -> None:
    """The first window-add design's interface (one ``window_add.cu`` for
    K3 and K4)."""
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


def load(kernel: str, name: str, path: str, tables: str) -> C.CDLL:
    so = build.build_shared(f"ab_{kernel}_{name}", build.nvcc_path(),
                            build.NVCC_FLAGS, [path])
    lib = C.CDLL(so)
    declare = {"two_level": HK._declare, "flat": _declare_flat,
               "ws": PW._declare if kernel == "k3" else PW._declare2,
               "ws2": PW._declare2, "plan": _declare_first,
               "k3only": _declare_k3_only}
    declare.get(tables, SK._declare)(lib)
    return lib


def first_design_call(lib: C.CDLL, sets, n_out: int) -> torch.Tensor:
    """The first window-add design's launch sequence for one or two lane
    sets: the running max and plan launch, ``torch.cumsum`` of the heavy
    tiles' unit counts, then the main kernel."""
    dev, dtype = sets[0][1].device, sets[0][1].dtype
    tile, unit_work = lib.window_add_tile(), lib.window_add_unit_work()
    if len(sets) == 1:  # K3: set b is empty
        sets = sets + [(sets[0][0][:0], sets[0][1][:0])]
    (sa, ua), (sb, ub) = sets
    La, Lb = sa.shape[0], sb.shape[0]
    nt = -(-n_out // tile)
    spread = sum(u.shape[0] * (-(-(u.shape[1] - 1) // tile) + 1)
                 * min(u.shape[1], tile) for u in (ua, ub) if u.shape[1])
    heavy = 2 * (spread // unit_work) + 2
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
        raise RuntimeError(f"plan launch failed: CUDA error {rc}")
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
        raise RuntimeError(f"main launch failed: CUDA error {rc}")
    return out


def k4_call(lib: C.CDLL, iface: str, arrays, n_out: int):
    """One K4 call through ``lib``, launched as the wrapper launches it."""
    sets = [tuple(arrays[0:2]), tuple(arrays[2:4])]
    if iface == "plan":
        return first_design_call(lib, sets, n_out)
    return PW._window_add2_cuda(sets, n_out, lib=lib)


def k3_call(lib: C.CDLL, iface: str, starts, upd, n_out: int):
    """One K3 call through ``lib``: its own wrapper's launch (``ws``), the
    first design's sequence (``plan``) or window_add2.cu's with set b empty
    (``ws2``)."""
    if iface == "plan":
        return first_design_call(lib, [(starts, upd)], n_out)
    if iface == "ws2":
        return PW._window_add2_cuda([(starts, upd), (starts[:0], upd[:0])],
                                    n_out, lib=lib)
    return PW._window_add1_cuda(starts, upd, n_out, lib=lib)


def k1_pass(lib: C.CDLL, tables: str, main, parts):
    """One call per bucket, as the wrapper makes it; returns the outputs."""
    tb = HD.device_tables(main.device)
    if tables == "two_level":
        table_args = [tb[k].data_ptr() for k in
                      ("lut2", "l1_base", "c1lut", "big_width", "ktid",
                       "klin", "kres")]
    else:
        table_args = [tb[k].data_ptr() for k in
                      ("biglut", "big_base", "big_width", "ktid", "klin",
                       "kres")]
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for lanes, nb, nc in parts:
        n = lanes[0].shape[0]
        big576 = torch.empty((n, 576), dtype=torch.int16, device=main.device)
        c1 = torch.empty((n, 144, 4), dtype=torch.int16, device=main.device)
        fail = torch.empty((n,), dtype=torch.bool, device=main.device)
        consts = ([] if tables == "two_level" else
                  [HD._C1_LO4, HD._C1_LO5, HD._C1_NIB4, HD._C1_NIB5,
                   HD._C1_NIB6])
        rc = lib.mp3_entropy_scan(
            main.data_ptr(), main.shape[0], main.shape[1],
            *[t.data_ptr() for t in lanes], *table_args,
            n, min(max(nb, 1), 512), HD.count1_quads(nc), *consts,
            big576.data_ptr(), c1.data_ptr(), fail.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"mp3_entropy_scan: CUDA error {rc}")
        outs.append((big576, c1, fail))
    return outs


def k2_call(lib: C.CDLL, mat, ts, g2):
    out = torch.empty_like(ts)
    rc = lib.mp3_synth(ts.data_ptr(), mat.data_ptr(), g2.data_ptr(),
                       out.data_ptr(), ts.shape[0], ts.shape[1],
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mp3_synth: CUDA error {rc}")
    return out


def live_lanes(arrays):
    """Each lane set cut before its tail of all-zero padding lanes."""
    live = []
    for st, u in zip(arrays[0::2], arrays[1::2]):
        nz = torch.nonzero(u.reshape(u.shape[0], -1).ne(0).any(1))
        n = int(nz.max()) + 1 if nz.numel() else 0
        live += [st[:n], u[:n]]
    return live


def probes(arrays, n_out) -> dict:
    """K4's inputs and parts of them: the whole group, the lanes before the
    zero tails, each set's zero tail alone (re-pointed onto its last live
    start) and no lanes at all (the output's zeros)."""
    sa, ua, sb, ub = arrays
    live = live_lanes(arrays)
    out = {"full": arrays, "live": live}
    for tag, (s, u), n in (("a", (sa, ua), live[0].shape[0]),
                           ("b", (sb, ub), live[2].shape[0])):
        at = int(s[:n].max()) if n else 0
        tail = [torch.full((s.shape[0] - n,), at, dtype=torch.int32,
                           device=s.device), u[n:]]
        if tag == "a":
            out["zero tail of a"] = tail + [sb[:0], ub[:0]]
        else:
            out["zero tail of b"] = [sa[:0], ua[:0]] + tail
    out["no lanes"] = [sa[:0], ua[:0], sb[:0], ub[:0]]
    return out


def run_k4(specs: list[str], rounds: int, reps: int, card: str) -> dict:
    """K4 versions on the 16-file FLAC group's inputs, then K3 there."""
    w = CS._flac_windows(torch.device("cuda"))
    *arrays, n_out = w["window_add2"]
    parts = probes(arrays, n_out)
    ref = PW.window_add2_plain(*arrays, n_out)
    result = {"shapes": [list(t.shape) for t in arrays], "n_out": n_out,
              "probes": {k: [int(t.shape[0]) for t in v[0::2]]
                         for k, v in parts.items()}}
    fns = {}
    for spec in specs:
        name, path, iface = parse_version("k4", spec)
        lib = load("k4", name, path, iface)
        for k, a in parts.items():
            got = k4_call(lib, iface, a, n_out)
            if not torch.equal(got, PW.window_add2_plain(*a, n_out)):
                raise SystemExit(f"k4 {name} differs from window_add2_plain "
                                 f"on {k}")
        torch.cuda.synchronize()
        assert torch.equal(k4_call(lib, iface, arrays, n_out), ref)
        occ = (lib.window_add2_blocks_per_sm() if iface == "ws" else None)
        print(f"k4 {name}: exact ({result['shapes']}, n_out {n_out}; and on "
              f"{result['probes']}); main kernel blocks per SM {occ}",
              flush=True)
        fns[name] = {k: (lambda lib=lib, iface=iface, a=a:
                         k4_call(lib, iface, a, n_out))
                     for k, a in parts.items()}
    turns = in_turns({k: v["full"] for k, v in fns.items()}, rounds, reps)
    live_turns = in_turns({k: v["live"] for k, v in fns.items()}, rounds, reps)
    for name in fns:
        t, lt = turns[name], live_turns[name]
        result[name] = {"turns_ms": t, "live_turns_ms": lt, "device": {}}
        print(f"k4 {name}: ms per call {['%.4f' % x for x in t]} mean "
              f"{sum(t) / len(t):.4f}; on the lanes before the zero tails "
              f"{['%.4f' % x for x in lt]} mean {sum(lt) / len(lt):.4f}  "
              f"[{card}]", flush=True)
        for k, fn in fns[name].items():
            kern = CS.device_kernels(fn, reps)
            result[name]["device"][k] = kern
            per = ", ".join(f"{CS.kernel_name(n)} {v:.4f}" for n, v in kern.items())
            print(f"k4 {name}: device on {k}: {sum(kern.values()):.4f} ms per "
                  f"call ({per})", flush=True)
    k3 = w["window_add"]
    k3_turns = in_turns({"k3": lambda: PW.window_add(*k3)}, rounds, reps)["k3"]
    k3_kern = CS.device_kernels(lambda: PW.window_add(*k3), reps)
    result["k3"] = {"turns_ms": k3_turns, "device_ms": sum(k3_kern.values()),
                    "kernels": k3_kern}
    print(f"k3 (window_add.cu): ms per call "
          f"{['%.4f' % x for x in k3_turns]} mean "
          f"{sum(k3_turns) / len(k3_turns):.4f}; device "
          f"{sum(k3_kern.values()):.4f} ms per call  [{card}]", flush=True)
    # what the card's memory gives a plain stream of the same size: one
    # copy of set a's updates (read and write)
    ua = arrays[1]
    dst = torch.empty_like(ua)
    copy_ms = CS.cuda_ms(lambda: dst.copy_(ua), reps)
    mb = 2 * ua.numel() * ua.element_size() / 1e6
    result["copy"] = {"ms": copy_ms, "mb_moved": mb}
    print(f"yardstick: copy of set a's updates, {mb:.1f} MB moved, "
          f"{copy_ms:.4f} ms ({mb / copy_ms / 1e3:.3f} TB/s)  [{card}]",
          flush=True)
    return result


def tile_census(starts, W: int, n_out: int) -> dict:
    """How many of K3's output tiles (of ``PW.TILE1`` elements) have how
    many lanes, with the starts re-pointed, and how the live lanes' starts
    align."""
    s = torch.cummax(starts.to(torch.int64), 0).values
    t0 = torch.arange(0, n_out, PW.TILE1, dtype=torch.int64, device=s.device)
    n = (torch.searchsorted(s, t0 + PW.TILE1)
         - torch.searchsorted(s, t0 - W + 1)).cpu()
    rows, tiles = torch.unique(n, return_counts=True)
    live = starts[s == starts.to(torch.int64)]
    return {"tiles": int(n.numel()),
            "tiles_by_lanes": {int(r): int(t) for r, t in zip(rows, tiles)},
            "starts_multiple_of_8192": bool((live % 8192 == 0).all()),
            "starts_multiple_of_4": bool((live % 4 == 0).all())}


def k3_probes(starts, upd, n_out) -> dict:
    """K3's inputs and probes of them: the one-row tiles alone (the live
    frames packed end to end at multiples of W), the pile-up tiles alone
    (the last live frame and the zero padding rows, all at start 0), and
    no lanes (the output's zeros)."""
    W = upd.shape[1]
    nz = torch.nonzero(upd.ne(0).any(1))
    n = int(nz.max()) + 1 if nz.numel() else 0
    dev = upd.device
    packed = torch.arange(n, dtype=torch.int32, device=dev) * W
    pile = torch.zeros((upd.shape[0] - n + 1,), dtype=torch.int32, device=dev)
    return {"full": (starts, upd, n_out),
            "one-row tiles": (packed, upd[:n], n * W),
            "pile-up tiles": (pile, upd[n - 1:], W),
            "no lanes": (starts[:0], upd[:0], n_out)}


def run_k3(specs: list[str], rounds: int, reps: int, card: str) -> dict:
    """K3 versions on the 16-file FLAC group's PCM inputs, beside one
    ``index_add_`` call and a copy of the updates."""
    starts, upd, n_out = CS._flac_windows(torch.device("cuda"))["window_add"]
    census = tile_census(starts, upd.shape[1], n_out)
    print(f"k3 inputs: starts {tuple(starts.shape)}, upd {tuple(upd.shape)} "
          f"{upd.dtype}, n_out {n_out}; {census}", flush=True)
    parts = k3_probes(starts, upd, n_out)
    result = {"census": census, "n_out": n_out,
              "probes": {k: [int(a[1].shape[0]), int(a[2])]
                         for k, a in parts.items()},
              "bound_ms": {k: CS.bound(CS.nbytes(*a[:2]) + a[2] * 4)[0]
                           for k, a in parts.items()}}
    fns = {}
    for spec in specs:
        name, path, iface = parse_version("k3", spec)
        lib = load("k3", name, path, iface)
        for k, a in parts.items():
            got, again = k3_call(lib, iface, *a), k3_call(lib, iface, *a)
            if not torch.equal(got, PW.window_add_plain(*a)):
                raise SystemExit(f"k3 {name} differs from window_add_plain "
                                 f"on {k}")
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                raise SystemExit(f"k3 {name} gives other bits a second time "
                                 f"on {k}")
        occ = {"ws": "window_add_blocks_per_sm",
               "k3only": "window_add_blocks_per_sm",
               "ws2": "window_add2_blocks_per_sm"}.get(iface)
        occ = getattr(lib, occ)() if occ else None
        print(f"k3 {name} ({iface}): exact and repeatable on {list(parts)}; "
              f"main kernel blocks per SM {occ}", flush=True)
        fns[name] = {k: (lambda lib=lib, iface=iface, a=a: k3_call(lib, iface, *a))
                     for k, a in parts.items()}
    dst = torch.empty_like(upd)
    timed = {name: v["full"] for name, v in fns.items()}
    timed["index_add_"] = CS._index_add_call([(starts, upd)], n_out)
    timed["copy"] = lambda: dst.copy_(upd)
    turns = in_turns(timed, rounds, reps)
    mb = (CS.nbytes(starts, upd) + n_out * 4) / 1e6
    for name, t in turns.items():
        mean = sum(t) / len(t)
        kern = CS.device_kernels(timed[name], reps)
        dev_ms = sum(kern.values())
        result[name] = {"turns_ms": t, "device_ms": dev_ms, "device": {"full": kern}}
        print(f"k3 {name}: ms per call {['%.4f' % x for x in t]} mean "
              f"{mean:.4f}; device {dev_ms:.4f} ms per call "
              f"({mb / dev_ms / 1e3:.3f} TB/s of K3's {mb:.1f} MB); bound "
              f"{result['bound_ms']['full']:.4f} ms  [{card}]", flush=True)
    for name in fns:
        for k, fn in fns[name].items():
            kern = CS.device_kernels(fn, reps)
            result[name]["device"][k] = kern
            per = ", ".join(f"{CS.kernel_name(n)} {v:.4f}" for n, v in kern.items())
            print(f"k3 {name}: device on {k} (bound "
                  f"{result['bound_ms'][k]:.4f}): {sum(kern.values()):.4f} ms "
                  f"per call ({per})", flush=True)
    print(f"yardstick: the copy moves {2 * CS.nbytes(upd) / 1e6:.1f} MB  "
          f"[{card}]", flush=True)
    return result


def device_ms(fn, reps: int, kernel: str) -> float:
    """Device milliseconds per launch of the kernels named ``kernel``
    among ``reps`` calls of ``fn``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            total += (getattr(e, "self_device_time_total", None)
                      or getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    if not count:
        print(f"the profiler saw no {kernel} launch", flush=True)
        return float("nan")
    return total / count / 1e3


def in_turns(fns: dict, rounds: int, reps: int) -> dict:
    """{name: [ms per call of each turn]}, the names in order then reversed."""
    turns = {k: [] for k in fns}
    order = list(fns)
    for _ in range(rounds):
        for k in order + order[::-1]:
            turns[k].append(CS.cuda_ms(fns[k], reps))
    return turns


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1", action="append", default=[], metavar="NAME=PATH[:TABLES]")
    ap.add_argument("--k2", action="append", default=[], metavar="NAME=PATH[:TABLES]")
    ap.add_argument("--k4", action="append", default=[], metavar="NAME=PATH[:IFACE]")
    ap.add_argument("--k3", action="append", default=[], metavar="NAME=PATH[:IFACE]")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA GPU")
    card = CS.card_line()
    dev = torch.device("cuda")
    result = {"card": card, "k1": {}, "k2": {}}
    if args.k4:
        result["k4"] = run_k4(args.k4, args.rounds, args.reps, card)
    if args.k3:
        result["k3"] = run_k3(args.k3, args.rounds, args.reps, card)
    if not (args.k1 or args.k2):
        write(result)
        return
    group, perm, buckets, ch, joint = CS._main_path_group(dev)
    main_u8, parts = CS._scan_inputs(group, perm, buckets)
    result["k1_launches_per_pass"] = len(parts)

    k1 = {}
    for spec in args.k1:
        name, path, tables = parse_version("k1", spec)
        lib = load("k1", name, path, tables)
        got = k1_pass(lib, tables, main_u8, parts)
        for (lanes, nb, nc), outs in zip(parts, got):
            ref = HD.scan_plain(main_u8, *lanes, n_big=nb, n_c1=nc)
            if not all(torch.equal(g, r) for g, r in zip(outs, ref)):
                raise SystemExit(f"k1 {name} differs from scan_plain "
                                 f"(bucket n_big={nb})")
        k1[name] = (lambda lib=lib, tables=tables:
                    k1_pass(lib, tables, main_u8, parts))
        for b, one in enumerate(parts):
            dev_ms = device_ms(lambda lib=lib, tables=tables, one=one:
                               k1_pass(lib, tables, main_u8, [one]),
                               args.reps, "mp3_entropy_kernel")
            print(f"k1 {name}: bucket {b} ({one[0][0].shape[0]} lanes, n_big "
                  f"{one[1]}, n_c1 {one[2]}) device {dev_ms:.4f} ms  [{card}]",
                  flush=True)
    for name, turns in in_turns(k1, args.rounds, args.reps).items():
        per = [t / len(parts) for t in turns]
        dev_ms = device_ms(k1[name], args.reps, "mp3_entropy_kernel")
        result["k1"][name] = {"turns_ms": per, "device_ms": dev_ms}
        print(f"k1 {name}: ms per launch {['%.4f' % t for t in per]} mean "
              f"{sum(per) / len(per):.4f} ({len(parts)} launches per pass); "
              f"device {dev_ms:.4f} ms per launch  [{card}]", flush=True)

    TS = dsp.fused_subband_samples(*group, perm, channels=ch, joint_stereo=joint,
                                   buckets=buckets)
    ts = TS.reshape(-1, TS.shape[2], 32).contiguous()
    c = dsp._consts(dev)
    nf = torch.as_tensor(SK.fold_synth_n(c["synth_n"].cpu().numpy()), device=dev)
    ref = SK.synthesis_plain(ts, c["synth_n"], c["g2"])
    k2 = {}
    for spec in args.k2:
        name, path, tables = parse_version("k2", spec)
        lib = load("k2", name, path, tables)
        mat = nf if tables == "folded" else c["synth_n"]
        got = k2_call(lib, mat, ts, c["g2"])
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, atol=1e-4, rtol=1e-5):
            raise SystemExit(f"k2 {name} differs from synthesis_plain: {err}")
        print(f"k2 {name}: TS {tuple(ts.shape)}, max abs err {err:.3e}", flush=True)
        k2[name] = lambda lib=lib, mat=mat: k2_call(lib, mat, ts, c["g2"])
    for name, turns in in_turns(k2, args.rounds, args.reps).items():
        dev_ms = device_ms(k2[name], args.reps, "mp3_synth_kernel")
        result["k2"][name] = {"turns_ms": turns, "device_ms": dev_ms}
        print(f"k2 {name}: ms per launch {['%.4f' % t for t in turns]} mean "
              f"{sum(turns) / len(turns):.4f}; device {dev_ms:.4f} ms per "
              f"launch  [{card}]", flush=True)

    write(result)


def write(result: dict) -> None:
    os.makedirs(CS.OUT_DIR, exist_ok=True)
    with open(os.path.join(CS.OUT_DIR, "kernel_ab.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()

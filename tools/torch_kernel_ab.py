"""Time versions of the PyTorch port's MP3 CUDA kernels against each other.

Runs on one NVIDIA GPU, on the inputs ``chip_smoke.py`` gives the kernels:
the three entropy-scan (K1) launches of the 16-file stereo MP3 group's
buckets and the synthesis (K2) of the same group's subband samples.  Each
version is a ``.cu`` source with the plain C interface of
``audio_decoder_tpu_torch/csrc/mp3_entropy.cu`` (K1) or ``mp3_synth.cu``
(K2), built here with the port's nvcc flags.  A version's tables are named
after a colon:

* K1 ``two_level`` (the default): the interface of the source in the tree
  (``huffman_device``'s two-level table, its first-level bases and the
  count1 table); ``flat``: the first design's interface (the flat prefix
  LUT and its bases, the count1 threshold constants);
* K2 ``folded`` (the default): ``synth_kernel.fold_synth_n(SYNTH_N)``;
  ``full``: SYNTH_N itself (the first design's).

Every version is first held against the plain twin (K1 exactly, K2 within
atol 1e-4 / rtol 1e-5), then timed with CUDA events in turns (the versions
in order, then in reverse, ``--rounds`` times), each turn the mean of
``--reps`` back-to-back calls, which cannot go below the calls' host time;
then its kernel's device time per launch is read from torch.profiler over
``--reps`` calls.  Prints one line per version with its turns and device
time, in milliseconds per launch, beside the card's name and power limit,
and writes them to ``kernel_ab.json`` in chip_smoke.py's output
directory (``OUT_DIR``).

Usage (the first design's sources are in git history):
  git show cf3a5a4:audio_decoder_tpu_torch/csrc/mp3_entropy.cu > build/ab/k1_pr1.cu
  git show cf3a5a4:audio_decoder_tpu_torch/csrc/mp3_synth.cu > build/ab/k2_pr1.cu
  python tools/torch_kernel_ab.py \\
      --k1 pr1=build/ab/k1_pr1.cu:flat \\
      --k1 new=audio_decoder_tpu_torch/csrc/mp3_entropy.cu \\
      --k2 pr1=build/ab/k2_pr1.cu:full \\
      --k2 new=audio_decoder_tpu_torch/csrc/mp3_synth.cu
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
from audio_decoder_tpu_torch.utils import build  # noqa: E402

TABLES = {"k1": ("two_level", "flat"), "k2": ("folded", "full")}


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


def load(kernel: str, name: str, path: str, tables: str) -> C.CDLL:
    so = build.build_shared(f"ab_{kernel}_{name}", build.nvcc_path(),
                            build.NVCC_FLAGS, [path])
    lib = C.CDLL(so)
    declare = {"two_level": HK._declare, "flat": _declare_flat}
    declare.get(tables, SK._declare)(lib)
    return lib


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
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA GPU")
    card = CS.card_line()
    dev = torch.device("cuda")
    group, perm, buckets, ch, joint = CS._main_path_group(dev)
    main_u8, parts = CS._scan_inputs(group, perm, buckets)
    result = {"card": card, "k1_launches_per_pass": len(parts), "k1": {}, "k2": {}}

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

    os.makedirs(CS.OUT_DIR, exist_ok=True)
    with open(os.path.join(CS.OUT_DIR, "kernel_ab.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()

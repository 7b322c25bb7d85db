"""Rehearse a CUDA kernel source on the CPU, against its plain twin.

Builds a ``.cu`` file of the port with g++ instead of nvcc: the source is
rewritten (each ``kernel<<<grid, block, smem, stream>>>(args)`` launch
becomes a call of ``shim::launch``, each ``extern __shared__`` array a
static array) and compiled with ``tools/cuda_cpu_shim.h`` force-included,
which runs every CUDA thread of a block as a std::thread.  The library
keeps the source's plain C interface, so the port's own wrapper drives it
on CPU tensors.  It shows wrong indexing, races on shared memory, barrier
and alignment faults and wrong results at small sizes; it cannot show
speed, or a read of a ``cp.async`` buffer before its wait (the shim copies
at issue time).  It is a tool for the step before a kernel's first run on
the card, not a test.

Usage:
  python tools/rehearse_cuda.py [--only ID] [SOURCE]

SOURCE defaults to ``audio_decoder_tpu_torch/csrc/window_add2.cu``; a file
of that name (a copy being edited, say) is run on the K4 cases of
``tests/test_torch_cuda.py`` (``window2_cases``), each held against
``window_add2_plain`` as the card's tests hold it (``window2_matches``:
int32 exactly, float32 within 2e-3 of the float64 sum) and called twice
with identical results.  A file named ``window_add.cu`` (K3) is run the
same way on K3's cases (``WINDOW1_CASES``, and the pile-up on updates that
begin one element into their storage), held exactly against
``window_add_plain``, then on K5's (``SPMD_CASES``; the shards as separate
allocations and, where they have one length, as views of one buffer), held
exactly against ``window_add_spmd_plain``.  A file named ``flac_rice.cu``
(the FLAC rice scan) is run on ``rice_case``'s cases through
``ops/rice_scan.rice_scan_cuda``, held exactly against ``rice_plain`` (the
plain twin and the decode's mask), after a call with the other variant's
codes per step, which it must refuse.  A file named ``flac_predict.cu``
(the FLAC predictor) is run on ``predict_case``'s blocksizes through
``ops/flac_predict.predict_cuda``, on the decode's strided view
(``decode_view``) and on a contiguous array, each held exactly against the
plain twin ``_predict``, after a call with overlapping rows, which it must
refuse.  Another source is only built.
"""

from __future__ import annotations

import argparse
import ctypes as C
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from audio_decoder_tpu_torch.ops import flac_predict as PP  # noqa: E402
from audio_decoder_tpu_torch.ops import rice_scan as RS  # noqa: E402
from audio_decoder_tpu_torch.ops import window_add as PW  # noqa: E402

SHIM = os.path.join(ROOT, "tools", "cuda_cpu_shim.h")
OUT = os.path.join(ROOT, "build", "rehearse")
K4 = os.path.join(ROOT, "audio_decoder_tpu_torch", "csrc", "window_add2.cu")
K3 = os.path.join(ROOT, "audio_decoder_tpu_torch", "csrc", "window_add.cu")
RICE = os.path.join(ROOT, "audio_decoder_tpu_torch", "csrc", "flac_rice.cu")
PREDICT = os.path.join(ROOT, "audio_decoder_tpu_torch", "csrc",
                       "flac_predict.cu")

_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                     re.S)
_DYN_SMEM = re.compile(r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?"
                       r"([\w ]+?)\s+(\w+)\[\];")


def _split_top(s: str) -> list[str]:
    """Split at the commas outside parentheses, brackets and angles."""
    parts, depth, cur = [], 0, ""
    for ch in s:
        if ch in "([<":
            depth += 1
        elif ch in ")]>":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    parts.append(cur.strip())
    return parts


def rewrite(src: str) -> str:
    def launch(m: re.Match) -> str:
        cfg = _split_top(m.group(2))
        smem = cfg[2] if len(cfg) > 2 else "0"
        return (f"shim::launch(dim3({cfg[0]}), dim3({cfg[1]}), "
                f"(size_t)({smem}), [=]() {{ {m.group(1)}({m.group(3)}); }});")

    src = re.sub(r"#include\s*<cuda_runtime\.h>", "", src)
    src = _DYN_SMEM.sub(r"alignas(16) static \1 \2[shim::kDynSmem];", src)
    return _LAUNCH.sub(launch, src)


def build_shim(path: str) -> str:
    """g++ build of the rewritten source; returns the library's path."""
    os.makedirs(OUT, exist_ok=True)
    name = os.path.splitext(os.path.basename(path))[0]
    cc = os.path.join(OUT, f"{name}.cc")
    with open(path) as f, open(cc, "w") as g:
        g.write(rewrite(f.read()))
    so = os.path.join(OUT, f"lib{name}_shim.so")
    cmd = ["g++", "-std=c++20", "-O1", "-g", "-pthread", "-fPIC", "-shared",
           "-include", SHIM, "-o", so, cc]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"g++ failed:\n{proc.stderr}")
    return so


def rehearse_k4(so: str, only: str | None) -> None:
    from tests.test_torch_cuda import unaligned_view, window2_cases, window2_matches

    lib = C.CDLL(so)
    PW._declare2(lib)
    for cid, sa, ua, sb, ub, n_out in window2_cases():
        if only and cid != only:
            continue
        t0 = time.perf_counter()
        arrays = [torch.as_tensor(x) for x in (sa, ua, sb, ub)]
        if cid.startswith("unaligned"):
            arrays[1] = unaligned_view(arrays[1])
        sets = [tuple(arrays[0:2]), tuple(arrays[2:4])]
        got = PW._window_add2_cuda(sets, n_out, lib=lib, stream=0)
        again = PW._window_add2_cuda(sets, n_out, lib=lib, stream=0)
        ok = window2_matches(got, arrays, n_out) and torch.equal(got, again)
        ref = PW.window_add2_plain(*arrays, n_out)
        plan = PW.plan_sizes(sa.shape[0], ua.shape[1], sb.shape[0],
                             ub.shape[1], n_out)
        print(f"{cid}: {'ok' if ok else 'DIFFERS'} (tiles {plan.nt}, heavy "
              f"bound {plan.heavy}; {time.perf_counter() - t0:.1f} s)",
              flush=True)
        if not ok:
            bad = torch.nonzero(got != ref).flatten()
            raise SystemExit(f"{cid}: {bad.numel()} elements differ, first "
                             f"{bad[:8].tolist()}: {got[bad[:8]].tolist()} vs "
                             f"{ref[bad[:8]].tolist()}")


def rehearse_k3(so: str, only: str | None) -> None:
    from tests.test_torch_cuda import WINDOW1_CASES, unaligned_view, window1_case

    lib = C.CDLL(so)
    PW._declare(lib)
    for cid in WINDOW1_CASES + ("unaligned-view",):
        if only and cid != only:
            continue
        t0 = time.perf_counter()
        starts, upd, n_out = window1_case(
            "pile-up-f32" if cid == "unaligned-view" else cid)
        s, u = torch.as_tensor(starts), torch.as_tensor(upd)
        if cid == "unaligned-view":
            u = unaligned_view(u)
        got = PW._window_add1_cuda(s, u, n_out, lib=lib, stream=0)
        again = PW._window_add1_cuda(s, u, n_out, lib=lib, stream=0)
        ref = PW.window_add_plain(s, u, n_out)
        ok = torch.equal(got, ref) and torch.equal(got.view(torch.int32),
                                                   again.view(torch.int32))
        plan = PW.plan_sizes1(u.shape[0], u.shape[1], n_out)
        print(f"{cid}: {'ok' if ok else 'DIFFERS'} (tiles {plan.nt}, heavy "
              f"bound {plan.heavy}; {time.perf_counter() - t0:.1f} s)",
              flush=True)
        if not ok:
            bad = torch.nonzero(got != ref).flatten()
            raise SystemExit(f"{cid}: {bad.numel()} elements differ, first "
                             f"{bad[:8].tolist()}: {got[bad[:8]].tolist()} vs "
                             f"{ref[bad[:8]].tolist()}")


def rehearse_k5(so: str, only: str | None) -> None:
    from tests.test_torch_cuda import SPMD_CASES, spmd_case

    lib = C.CDLL(so)
    PW._declare(lib)
    for cid in SPMD_CASES:
        if only and cid != only:
            continue
        shards, n_out = spmd_case(cid)
        sets = [(torch.as_tensor(s), torch.as_tensor(u)) for s, u in shards]
        layouts = {"separate": sets}
        if len({s.shape[0] for s, _ in sets}) == 1:
            starts = torch.cat([s for s, _ in sets])
            upd = torch.cat([u for _, u in sets])
            c = sets[0][0].shape[0]
            layouts["views"] = [(starts[i * c:(i + 1) * c], upd[i * c:(i + 1) * c])
                                for i in range(len(sets))]
        for name, ss in layouts.items():
            t0 = time.perf_counter()
            got = PW._window_add_spmd_cuda(ss, n_out, lib=lib, stream=0)
            again = PW._window_add_spmd_cuda(ss, n_out, lib=lib, stream=0)
            ref = PW.window_add_spmd_plain(*zip(*ss), n_out)
            ok = torch.equal(got, ref) and torch.equal(
                got.view(torch.int32), again.view(torch.int32))
            plan = PW.plan_sizes_spmd(tuple(s.shape[0] for s, _ in ss),
                                      ss[0][1].shape[1], n_out)
            print(f"K5 {cid} ({name}): {'ok' if ok else 'DIFFERS'} (tiles "
                  f"{plan.nt}, heavy bound {plan.heavy}; "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)
            if not ok:
                bad = torch.nonzero(got != ref).flatten()
                raise SystemExit(f"K5 {cid}: {bad.numel()} elements differ, "
                                 f"first {bad[:8].tolist()}: "
                                 f"{got[bad[:8]].tolist()} vs "
                                 f"{ref[bad[:8]].tolist()}")


def rehearse_rice(so: str, only: str | None) -> None:
    from audio_decoder_tpu_torch.codecs.flac import device as FV
    from audio_decoder_tpu_torch.codecs.flac import frontend as FF
    from tests.test_torch_cuda import RICE_CASES, rice_case, rice_plain

    lib = C.CDLL(so)
    RS._declare(lib)
    args = [torch.as_tensor(a) for a in rice_case("narrow")[:5]]
    try:  # the other variant's codes per step: refused, nothing written
        RS.rice_scan_cuda(*args, 12, True, FV.rice_k(False), FF.Q_CAP,
                          lib=lib, cuda_stream=0)
    except RuntimeError as e:
        print(f"rice: another step count refused ({e})", flush=True)
    else:
        raise SystemExit("rice: the library took the wide step count for "
                         "the narrow variant")
    for cid in RICE_CASES:
        if only and cid != only:
            continue
        t0 = time.perf_counter()
        case = rice_case(cid)
        args = [torch.as_tensor(a) for a in case[:5]]
        steps, narrow = case[5:]
        got_v, got_o = RS.rice_scan_cuda(*args, steps, narrow,
                                         FV.rice_k(narrow), FF.Q_CAP,
                                         lib=lib, cuda_stream=0)
        want_v, want_o = rice_plain(*case)
        ok = torch.equal(got_v, want_v) and torch.equal(got_o, want_o)
        print(f"rice {cid}: {'ok' if ok else 'DIFFERS'} (lanes "
              f"{got_v.shape[0]}, codes {got_v.shape[1]}; "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        if not ok:
            bad = torch.nonzero(got_v != want_v)
            raise SystemExit(f"rice {cid}: {bad.shape[0]} values differ, first "
                             f"{bad[:4].tolist()}; ovf differs at "
                             f"{torch.nonzero(got_o != want_o).flatten()[:8].tolist()}")


def rehearse_predict(so: str, only: str | None) -> None:
    from audio_decoder_tpu_torch.codecs.flac import device as FV
    from tests.test_torch_cuda import PREDICT_NMAX, decode_view, predict_case

    lib = C.CDLL(so)
    PP._declare(lib)
    # rows that overlap (the wrapper refuses them first): refused
    vals, *rest = [torch.as_tensor(a) for a in predict_case(16)]
    rc = lib.flac_predict_launch(vals.data_ptr(), 8,
                                 *(t.data_ptr() for t in rest),
                                 vals.shape[0], 16, vals.data_ptr(), None)
    if rc == 0:
        raise SystemExit("predict: the library took a row stride under nmax")
    print(f"predict: overlapping rows refused (CUDA error {rc})", flush=True)
    for nmax in PREDICT_NMAX:
        if only and str(nmax) != only:
            continue
        case = [torch.as_tensor(a) for a in predict_case(nmax)]
        want = FV._predict(*case, nmax)
        for layout, vals in (("decode-view", decode_view(case[0])),
                             ("contiguous", case[0])):
            t0 = time.perf_counter()
            got = PP.predict_cuda(vals, *case[1:], lib=lib, cuda_stream=0)
            ok = torch.equal(got, want)
            print(f"predict nmax {nmax} ({layout}): "
                  f"{'ok' if ok else 'DIFFERS'} ({got.shape[0]} subframes; "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)
            if not ok:
                bad = torch.nonzero(got != want)
                raise SystemExit(f"predict nmax {nmax} ({layout}): "
                                 f"{bad.shape[0]} samples differ, first "
                                 f"{bad[:4].tolist()}: "
                                 f"{got[tuple(bad[:4].t())].tolist()} vs "
                                 f"{want[tuple(bad[:4].t())].tolist()}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", nargs="?", default=K4)
    ap.add_argument("--only", help="run only the case with this id")
    args = ap.parse_args()
    so = build_shim(os.path.abspath(args.source))
    print(f"built {so}", flush=True)
    if os.path.basename(args.source) == os.path.basename(K4):
        rehearse_k4(so, args.only)
    elif os.path.basename(args.source) == os.path.basename(K3):
        rehearse_k3(so, args.only)
        rehearse_k5(so, args.only)
    elif os.path.basename(args.source) == os.path.basename(RICE):
        rehearse_rice(so, args.only)
    elif os.path.basename(args.source) == os.path.basename(PREDICT):
        rehearse_predict(so, args.only)


if __name__ == "__main__":
    main()

"""What each row count of the Layer III IMDCT product costs on one NVIDIA
GPU, on the batch path and on a stream chunk.

cuBLAS picks its SGEMM kernel by the row count, and the kernels round
differently, so the port runs the product ``[M, 18] @ [18, 36]`` in calls
of exactly ``dsp._MM_ROWS`` rows (``dsp._fixed_rows_mm``, the last call
zero-padded): a granule's result then does not depend on how many
granules one call decodes.  Prints, beside the card's name and power
limit:

1. the row counts M (every multiple of 32 up to 8,192, then every 4,128th
   below 2^20) at which one product's rows differ from the same rows of a
   product of 2^20 rows;
2. for each row count R of ``--rows``: whether the fixed-row product of
   the first m rows equals the same rows of the product of 2R + 5 rows
   (m from 32 to 2R + 5), and its milliseconds per call (CUDA events, the
   mean of ``--reps`` calls) and cuBLAS calls on the rows of the 16-file
   stereo group (``decode_assets`` of 16 copies of the stereo fixture)
   and of one ``Mp3Stream`` chunk of the stereo fixture at the default
   granules_per_chunk 512, beside one product on the same rows.  A
   Layer III decode runs the product four times, once per block type;
3. with ``--wall N``: the wall of ``decode_assets`` of 16 copies of the
   stereo fixture plus the LSF fixture (milliseconds, N runs after a
   warm-up, sorted), with ``dsp._MM_ROWS`` set to each R of ``--rows`` in
   turns.  ``--root`` imports the package from another checkout, such as
   the parent commit's, whose product may be a single call; then
   ``--rows`` is not applied there.

Usage:
  python3 tools/torch_imdct_rows.py --rows 65536,262144,1048576
  python3 tools/torch_imdct_rows.py --wall 10 --rows 65536,262144 [--root DIR]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
STEREO = os.path.join(DATA, "stereo_44k1_128k_js.mp3")
LSF = os.path.join(DATA, "mono_22k05_lsf.mp3")


def ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def products(dev, rows: list[int], reps: int) -> None:
    from audio_decoder_tpu_torch.codecs.mpeg import decoder as D
    from audio_decoder_tpu_torch.codecs.mpeg import dsp, native

    w = dsp._consts(dev)["w_all"][0].t()
    g = torch.Generator(device=dev).manual_seed(0)
    base = torch.randn((2 * max(rows) + 5, 18), device=dev, generator=g)
    ref = torch.matmul(base[: 1 << 20], w)
    counts = list(range(32, 8193, 32)) + list(range(8192, 1 << 20, 4128))
    bad = [m for m in counts
           if not torch.equal(torch.matmul(base[:m], w), ref[:m])]
    print(f"one product: rows differ from 2^20 rows' at {len(bad)} of "
          f"{len(counts)} row counts, the largest {max(bad, default=0)}")

    p = native.probe(open(STEREO, "rb").read())
    st = D.Mp3Stream(open(STEREO, "rb").read(), device=dev)
    shapes = {"16-file stereo group": 16 * D._bucket(p["n_granules"]) * 2 * 32,
              "Mp3Stream chunk": (st.gpc + st.WARMUP) * st.channels * 32}
    for label, n in shapes.items():
        x = base[:n]
        print(f"{label}, {n} rows: one product "
              f"{ms(lambda: torch.matmul(x, w), reps):.4f} ms, 1 call")
    for R in rows:
        dsp._MM_ROWS = R
        whole = dsp._fixed_rows_mm(base[: 2 * R + 5], w)
        ms_tried = (32, 2112, 3232, 4096, R - 1, R, R + 1, 2 * R + 5)
        same = all(torch.equal(dsp._fixed_rows_mm(base[:m], w), whole[:m])
                   for m in ms_tried)
        line = [f"R = {R}: rows equal at every count tried {same}"]
        for label, n in shapes.items():
            x = base[:n]
            t = ms(lambda: dsp._fixed_rows_mm(x, w), reps)
            line.append(f"{label} {t:.4f} ms, {-(-n // R)} calls")
        print("; ".join(line))


def walls(dev, rows: list[int], n: int, root: str) -> None:
    import audio_decoder_tpu_torch as adt
    from audio_decoder_tpu_torch.codecs.mpeg import dsp
    from audio_decoder_tpu_torch.io.assets import load_assets

    assets = load_assets([STEREO] * 16 + [LSF])
    labels = ([f"R = {R}" for R in rows] if hasattr(dsp, "_MM_ROWS")
              else ["as imported"])
    got = {k: [] for k in labels}
    for i in range(n + 1):
        for k, R in zip(labels, rows):
            if hasattr(dsp, "_MM_ROWS"):
                dsp._MM_ROWS = R
            t0 = time.perf_counter()
            adt.decode_assets(assets, device=dev)
            torch.cuda.synchronize()
            if i:  # the first round is a warm-up
                got[k].append((time.perf_counter() - t0) * 1e3)
    for k, v in got.items():
        print(f"decode_assets of 16 stereo + LSF MP3, {k} ({root}): "
              f"wall ms {sorted(round(t, 3) for t in v)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="65536,131072,262144,524288,1048576",
                    help="comma-separated row counts R")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--wall", type=int, default=0, metavar="N")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package is imported")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        raise SystemExit("torch_imdct_rows: needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    rows = [int(r) for r in args.rows.split(",")]
    if args.wall:
        walls(dev, rows, args.wall, root)
    else:
        products(dev, rows, args.reps)


if __name__ == "__main__":
    main()

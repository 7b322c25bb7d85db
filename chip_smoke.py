"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds every kernel of the main path from the repo's sources, holds each
kernel against its plain torch twin at the main path's shapes, drives the
main path (a mixed WAV + MP3 folder through ``decode_dir``) and checks its
output, then times the mixed batch.  Phases:

  1. environment: torch, CUDA, nvcc and the card (fails without CUDA);
  2. build: the entropy-scan and synthesis kernels (nvcc, sm_90a) and the
     host MP3 front-end (g++);
  3. kernels against their plain twins on the card: the entropy scan must
     match exactly, the synthesis within atol 1e-4 / rtol 1e-5 (the sums
     run in another order);
  4. main path: 16 WAV (10 s, 44.1 kHz stereo 16-bit, from the seed) +
     16 copies of the committed 10 s 128 kbps joint-stereo MP3 + the
     22.05 kHz mono LSF MP3 + one garbage .wav + one .xyz, decoded with
     ``decode_dir(folder, device="cuda")``; checks error codes, WAV PCM
     equal to src/32768, MP3 PCM within amplitude-scaled RMS 5e-7 of the
     port's CPU path on the same bytes, and that both kernels launched;
  5. rate: after one warm run, 3 timed runs of the mixed batch (decoded
     audio-seconds per second; informational).

Every phase is fatal.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it names the card and
its power limit, and the line before that lists the kernels.

Usage:  python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port")
STEREO_MP3 = os.path.join(FIXTURES, "stereo_44k1_128k_js.mp3")
LSF_MP3 = os.path.join(FIXTURES, "mono_22k05_lsf.mp3")
N_WAV = N_MP3 = 16
SECONDS = 10.0
RATE = 44100
RMS_TOL = 5e-7  # float32 round-off bar of the MP3 tests, amplitude-scaled


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def scaled_rms_ok(ref: np.ndarray, got: np.ndarray) -> tuple[bool, float, float]:
    """RMS of the difference against 5e-7 scaled by the signal's RMS/0.2
    (float32 round-off is relative to amplitude)."""
    rms = float(np.sqrt(((ref - got) ** 2).mean()))
    bar = RMS_TOL * max(1.0, float(np.sqrt((ref ** 2).mean())) / 0.2)
    return rms < bar, rms, bar


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the device (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wav_blob(pcm: np.ndarray, rate: int) -> bytes:
    data = pcm.astype("<i2").tobytes()
    ch = pcm.shape[1]
    fmt = struct.pack("<HHIIHH", 1, ch, rate, rate * ch * 2, ch * 2, 16)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_environment() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA GPU")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    log("nvcc: " + nvcc.strip().splitlines()[-1])
    card = card_line()
    log(f"card: {card}  ({torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible)")
    return card


def _nvcc() -> str:
    from audio_decoder_tpu_torch.utils import build

    return build.nvcc_path()


def phase_build() -> None:
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel, native
    from audio_decoder_tpu_torch.ops import synth_kernel
    from audio_decoder_tpu_torch.utils import build

    t0 = time.perf_counter()
    huffman_kernel.load_library()
    synth_kernel.load_library()
    native.probe(b"")  # builds + loads libmp3fe
    secs = {k: round(v, 3) for k, v in build.BUILD_SECONDS.items()}
    log(f"build: {time.perf_counter() - t0:.3f} s total; per library {secs}")


def _main_path_group(dev):
    """The 16-file stereo MP3 group as the main path builds it: lane
    tensors on ``dev`` plus the bucket plan."""
    from audio_decoder_tpu_torch.codecs.mpeg import decoder as D
    from audio_decoder_tpu_torch.codecs.mpeg import native

    blob = open(STEREO_MP3, "rb").read()
    with native.Mp3Session([blob] * N_MP3) as sess:
        info = sess.infos[0]
        g_cap = D._bucket(info["n_granules"])
        m_cap = D._bucket(info["main_bytes"], 1024)
        r = sess.lanes_batch(list(range(N_MP3)), g_cap, m_cap, info["channels"])
    bvs = r["big"].reshape(-1)[r["valid"].reshape(-1) > 0]
    n_big = min(512, int(-(-int(bvs.max()) // 32) * 32))
    perm, buckets = D._plan_buckets(r["big"].reshape(-1),
                                    r["valid"].reshape(-1), n_big)
    args = D.fused_wire_args(r, D._rate_idx_arr(r["sample_rate"]), dev)
    perm_t = None if perm is None else torch.as_tensor(perm, device=dev)
    return args, perm_t, buckets, info["channels"], bool(info["joint"])


def _scan_inputs(args, perm, buckets):
    """Per-bucket lane tensors exactly as mp3_decode_fused hands them to
    the entropy scan (file_idx .. valid; rate and cfg only reorder)."""
    from audio_decoder_tpu_torch.codecs.mpeg import dsp

    main, blockcfg, rate_idx = args[0], args[12], args[15]
    lanes = dsp.wire_lane_args(*args[1:10], rate_idx, blockcfg)[:10]
    if perm is not None:
        lanes = [a[perm.to(torch.int64)].contiguous() for a in lanes]
    out, at = [], 0
    for cnt, nb, nc in buckets:
        out.append(([a[at:at + cnt].contiguous() for a in lanes], nb, nc))
        at += cnt
    return main, out


def phase_kernels(dev) -> list[dict]:
    from audio_decoder_tpu_torch.codecs.mpeg import dsp
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_device as HD
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel as HK
    from audio_decoder_tpu_torch.ops import synth_kernel as SK

    args, perm, buckets, ch, joint = _main_path_group(dev)
    main, parts = _scan_inputs(args, perm, buckets)
    n_lanes = sum(len(p[0][0]) for p in parts)
    log(f"K1 shapes: main_u8 {tuple(main.shape)}, {n_lanes} lanes in "
        f"buckets {buckets}")

    # --- K1: entropy scan, exact ---
    max_err = 0
    n_failed = 0
    for lanes, nb, nc in parts:
        got = HK.entropy_scan(main, *lanes, n_big=nb, n_c1=nc)
        ref = HD.scan_plain(main, *lanes, n_big=nb, n_c1=nc)
        n_failed += int(got[2].sum())
        for name, g, r in zip(("big576", "c1", "fail"), got, ref):
            if not torch.equal(g, r):
                bad = int((g != r).sum())
                fail(f"K1 {name} differs from the plain scan in {bad} entries "
                     f"(bucket n_big={nb} n_c1={nc})")
            if name != "fail":
                max_err = max(max_err, int((g.to(torch.int32)
                                            - r.to(torch.int32)).abs().max()))
    log(f"K1 entropy scan: exact match ({n_lanes} lanes, {n_failed} failed)")

    def run_k1():
        for lanes, nb, nc in parts:
            HK.entropy_scan(main, *lanes, n_big=nb, n_c1=nc)

    def run_k1_plain():
        for lanes, nb, nc in parts:
            HD.scan_plain(main, *lanes, n_big=nb, n_c1=nc)

    k1_ms = cuda_ms(run_k1, 20)
    k1_plain_ms = cuda_ms(run_k1_plain, 2)
    log(f"K1 time: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")

    # --- K2: synthesis on the TS the same decode produces ---
    TS = dsp.fused_subband_samples(*args, perm, channels=ch, joint_stereo=joint,
                                   buckets=buckets)
    B, C, T, _ = TS.shape
    ts = TS.reshape(B * C, T, 32).contiguous()
    c = dsp._consts(dev)
    got = SK.polyphase_synthesis_blocks(ts, c["synth_n"], c["g2"])
    ref = SK.synthesis_plain(ts, c["synth_n"], c["g2"])
    k2_err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, atol=1e-4, rtol=1e-5):
        fail(f"K2 synthesis differs from the plain form: max abs err {k2_err}")
    log(f"K2 synthesis: TS {tuple(ts.shape)}, max abs err {k2_err:.3e} "
        "(atol 1e-4, rtol 1e-5)")
    k2_ms = cuda_ms(lambda: SK.polyphase_synthesis_blocks(ts, c["synth_n"], c["g2"]), 50)
    k2_plain_ms = cuda_ms(lambda: SK.synthesis_plain(ts, c["synth_n"], c["g2"]), 20)
    log(f"K2 time: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms")
    return [
        dict(name="mp3_entropy_scan", route="cuda",
             source="audio_decoder_tpu_torch/csrc/mp3_entropy.cu",
             replaces="audio_decoder_tpu/codecs/mpeg/huffman_pallas.py:335",
             launches=0, max_abs_err=max_err, ms=k1_ms, plain_ms=k1_plain_ms),
        dict(name="mp3_polyphase_synthesis", route="cuda",
             source="audio_decoder_tpu_torch/csrc/mp3_synth.cu",
             replaces="audio_decoder_tpu/ops/pallas_synth.py:50",
             launches=0, max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms),
    ]


def write_folder(folder: str, seed: int) -> dict:
    """The mixed main-path folder; returns the WAV sources by stem."""
    rng = np.random.default_rng(seed)
    frames = int(SECONDS * RATE)
    wavs = {}
    for i in range(N_WAV):
        pcm = rng.integers(-32768, 32768, size=(frames, 2)).astype(np.int16)
        wavs[f"w{i:02d}"] = pcm
        with open(os.path.join(folder, f"w{i:02d}.wav"), "wb") as f:
            f.write(wav_blob(pcm, RATE))
    for i in range(N_MP3):
        shutil.copyfile(STEREO_MP3, os.path.join(folder, f"m{i:02d}.mp3"))
    shutil.copyfile(LSF_MP3, os.path.join(folder, "lsf.mp3"))
    with open(os.path.join(folder, "garbage.wav"), "wb") as f:
        f.write(rng.integers(0, 256, size=4096).astype(np.uint8).tobytes())
    with open(os.path.join(folder, "notes.xyz"), "wb") as f:
        f.write(b"not audio")
    return wavs


def phase_main_path(folder: str, wavs: dict, dev) -> tuple[dict, float]:
    import audio_decoder_tpu_torch as adt
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel as HK
    from audio_decoder_tpu_torch.core import errors as E
    from audio_decoder_tpu_torch.ops import synth_kernel as SK

    HK.launches = 0
    SK.launches = 0
    batch, names = adt.decode_dir(folder, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {"mp3_entropy_scan": HK.launches,
                "mp3_polyphase_synthesis": SK.launches}
    log(f"main path launches: {launches}")
    for k, n in launches.items():
        if n <= 0 and dev.type == "cuda":
            fail(f"kernel {k} was not launched by the main path")
    if batch.data.device.type != dev.type:
        fail(f"AudioBatch.data is on {batch.data.device}, not {dev}")
    if not torch.isfinite(batch.data).all():
        fail("non-finite PCM in the batch")

    err = batch.err.cpu().numpy()
    for i, name in enumerate(batch.names):
        code = int(err[i])
        if name == "garbage":
            if code == 0:
                fail("garbage.wav decoded without an error code")
        elif name == "notes":
            if code != E.ERR_UNSUPPORTED:
                fail(f"notes.xyz has error code {code}, want ERR_UNSUPPORTED")
        elif code != 0:
            fail(f"{name} has error code {code}")

    for stem, src in wavs.items():
        got = batch.file(names[stem]).pcm
        if got.shape != src.shape or not np.array_equal(
                got, src.astype(np.float32) / np.float32(32768.0)):
            fail(f"{stem}.wav PCM differs from its source / 32768")
    log(f"WAV: {len(wavs)} files equal src/32768 exactly")

    # MP3 against the port's CPU path (plain twins) on the same bytes
    ref_batch = adt.decode_paths([STEREO_MP3, LSF_MP3], device="cpu")
    refs = {"stereo_44k1_128k_js": ref_batch.file(0).pcm,
            "mono_22k05_lsf": ref_batch.file(1).pcm}
    worst = 0.0
    checked = 0
    for name in batch.names:
        if not (name.startswith("m") or name == "lsf"):
            continue
        ref = refs["mono_22k05_lsf" if name == "lsf" else "stereo_44k1_128k_js"]
        got = batch.file(names[name]).pcm
        if got.shape != ref.shape:
            fail(f"{name}.mp3 shape {got.shape} != CPU path {ref.shape}")
        ok, rms, bar = scaled_rms_ok(ref, got)
        worst = max(worst, rms / bar)
        if not ok:
            fail(f"{name}.mp3 RMS {rms:.3e} vs the CPU path exceeds {bar:.3e}")
        checked += 1
    log(f"MP3: {checked} files within amplitude-scaled RMS of the CPU path "
        f"(worst rms/bar {worst:.3f})")
    return launches, float(batch.audio_seconds())


def phase_rate(folder: str, card: str) -> None:
    import audio_decoder_tpu_torch as adt
    from audio_decoder_tpu_torch.io.assets import load_assets, scan_assets

    assets = load_assets(scan_assets(folder))

    def run():
        b = adt.decode_assets(assets, device="cuda")
        torch.cuda.synchronize()
        return b

    audio_s = float(run().audio_seconds())  # warm run
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    rates = [audio_s / t for t in times]
    log(f"rate: {audio_s:.3f} audio-s per batch; wall {times} s; "
        f"decode_throughput_mixed {rates} audio-s/s  [{card}]")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    card = phase_environment()
    phase_build()
    dev = torch.device("cuda")
    kernels = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="adt_smoke_") as folder:
        wavs = write_folder(folder, args.seed)
        launches, _ = phase_main_path(folder, wavs, dev)
        phase_rate(folder, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

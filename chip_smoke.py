"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds every kernel of the port from the repo's sources, holds each kernel
against its plain torch twin at its path's shapes, drives each path
through ``decode_dir`` and checks its output, then times the paths.
Phases:

  1. environment: torch, CUDA, nvcc and the card (fails without CUDA);
  2. build, all libraries at once: the entropy-scan, synthesis and
     window-add kernels (K3's window_add.cu, K4's window_add2.cu; nvcc,
     sm_90a) and the host MP3 and FLAC front-ends (g++);
  3. kernels against their plain twins on the card: the entropy scan (K1)
     must match exactly, the synthesis (K2) within atol 1e-4 / rtol 1e-5
     (the sums run in another order), at the WAV + MP3 path's shapes; the
     window-add kernels K4 (FLAC values) and K3 (FLAC PCM) exactly, at the
     16-file FLAC group's shapes (K3 also at the 24-bit mono group's).  Each is timed with CUDA events beside
     its twin, its bound (bytes or operations at the card's peak) and,
     for K3/K4, one ``index_add_`` call, all in milliseconds per launch
     (K1 runs one launch per bucket of the group; the phase prints the
     launches per pass and the longest lane's serial chain of codes; K3
     and K4 are also timed on the lanes before the zero tail of padding
     lanes, and their device time per call is read from torch.profiler,
     kernel by kernel, whole and without that tail);
  4. WAV + MP3 path: 16 WAV (10 s, 44.1 kHz stereo 16-bit, from the seed)
     + 16 copies of the committed 10 s 128 kbps joint-stereo MP3 + the
     22.05 kHz mono LSF MP3 + one garbage .wav + one .xyz, decoded with
     ``decode_dir(folder, device="cuda")``; checks error codes, WAV PCM
     equal to src/32768, MP3 PCM within amplitude-scaled RMS 5e-7 of the
     port's CPU path on the same bytes, and that K1 and K2 launched;
  5. FLAC path: 16 copies of the committed 10 s 44.1 kHz stereo 16-bit
     FLAC + the 3 s 48 kHz mono 24-bit FLAC + a corrupt .flac (random
     bytes behind the fLaC marker) + a truncated copy, decoded with
     ``decode_dir(folder, device="cuda")``; checks error codes against the
     port's CPU path, every good file's PCM equal to the CPU path bit for
     bit and its integers against the STREAMINFO MD5, and that K3 and K4
     launched;
  6. the frame-chunked FLAC route: the music fixture with the port's
     ``frontend.BIT_CAP`` shrunk to the file's size, so it decodes in
     chunks of a few frames, K3 and K4 once per chunk, on the card and on
     the CPU; checks the two bit for bit, the STREAMINFO MD5, and that K3
     launched once per chunk;
  7. rates: after one warm run, 3 timed runs each of the WAV + MP3 folder,
     16 FLAC files, and 16 WAV + 16 MP3 + 16 FLAC (decoded audio-seconds
     per second; informational);
  8. the other families: 16 copies each of 10 s 44.1 kHz stereo AIFF
     24-bit, AIFF-C sowt 16-bit, AU µ-law, CAF f32 LE, WAV IMA ADPCM and
     WAV MS ADPCM (block_align 2048) and AIFF-C ima4, 8 copies each of a
     10 s Layer I (448 kbps) and Layer II (192 kbps) stream, a truncated
     AIFF, a garbage .au and a .mp2 of random bytes (all written from the
     seed by the numpy writers in tests/), decoded with
     ``decode_dir(folder, device="cuda")``; checks names, formats, error
     codes and metadata against the port's CPU path on the same bytes,
     every integer family's PCM bit for bit, Layer I/II within
     amplitude-scaled RMS 5e-7, the ADPCM PCM against tests/ima_ref.py
     and ms_ref.py's decoders, and that the synthesis kernel (K2)
     launched; holds K2 against its twin at the Layer I/II groups' shapes
     (and at T = 2048·12 and 512·36) and times it; prints each family's
     audio-seconds per second with its host milliseconds per stage;
  9. the single-file streams: a 180 s stereo MP3 (the committed fixture 18
     times), 30 s Layer I and Layer II streams, a 10-minute 44.1 kHz
     stereo 16-bit WAV, a 60 s AIFF 24-bit, a 60 s WAV IMA ADPCM (block_align
     2048, random nibbles) and the committed FLAC music fixture, each
     through ``stream_file(device="cuda")`` at the default chunk sizes and
     from a seek that lands inside a granule, frame, block and chunk; the
     chunks must equal the one-shot ``decode_paths(device="cuda")`` bit for
     bit; prints each stream's audio-seconds per second, time to the first
     chunk, chunk count and peak device memory against the one-shot
     decode's; counts each stream run's launches on its own (set to 0
     just before it, read just after) and checks them: K1 and K2 once per
     Layer III chunk, K2 once per Layer I/II chunk, K3 and K4 once per
     FLAC chunk, nothing for the PCM streams; holds K1, K2, K3 and K4
     against their twins at the streams' chunk shapes and times them;
 10. the batch DSP: ``consensus_for`` on the mixed folder's batch (card =
     CPU); ``resample_to_consensus`` of 16 × 10 s stereo tones at each of
     48,000, 32,000 and 22,050 Hz plus 17 at 44,100 Hz against the CPU path
     (max abs 2e-6, amplitude-scaled RMS 5e-7), each tone above 60 dB SNR,
     the 44.1 kHz rows bit for bit, with each ratio's device ms and patch
     bytes; ``route_channels`` mono→stereo and stereo→mono against the CPU;
 11. the engine through its CLI: an asset folder of the mixed folder's 16
     WAV and 16 MP3 and the LSF MP3, 4 copies of the FLAC fixture and 2
     Layer II files (~135 MB of f32 tracks), rendered by ``cli render
     --resample`` (the live loop at PERIOD 128, SPEC_DEPTH 8) from a
     seeded script that uses every verb; K1-K4's launches in its decode
     are counted alone and must be exactly the folder's groups' (K1 and K2
     as the main path's MP3 files, one more K2 for the Layer II group, one
     K4 and one K3 for the FLAC group); each of those calls' inputs is kept
     and K1-K4 are held against their twins on them (K1, K3, K4 exactly,
     K2 within atol 1e-4 / rtol 1e-5) and timed; the written WAV must equal
     the captured int16 blocks, and the same script with ``--platform
     cpu`` must agree within 1 LSB (the share that differs is printed);
 12. bench.py's render configuration on the card (8 stereo tracks of 2 s,
     all 64 voices used and active, every third voice reversed, gain
     1/64, blocks of 4,096 frames, chains of 64): ``render_chain`` must
     equal sequential ``render_block`` bit for bit, ``EngineLoop`` at
     SPEC_DEPTH 8 must equal SPEC_DEPTH 0 over a command script, and a
     checkpoint saved halfway must continue sample-exact; prints the
     render's × real time (best of 5 chains after a warm one, one fetch a
     chain), the live loop's × real time at PERIOD 128, the device
     operations, kernel launch calls and device ms per block (torch
     profiler), the chain's peak device memory and the sink's kind;
 13. the multi-device path (``parallel/``) on a logical mesh of 8 shards over
     one card (data 4 x model 2): the main path's 16 WAV plus one (padded
     to 20 by ``pad_batch``, consensus over the shards), the stereo MP3
     fixture cut at 16 distinct frame boundaries, the families phase's
     Layer II stream cut at 8 distinct frame counts, and 16 copies of the
     FLAC music fixture beside 8 short seeded FLAC files, each decoded by
     its ``sharded_*_fn`` and held against the single-card decode of the
     same inputs (WAV and FLAC bit for bit, FLAC also against every file's
     MD5; MP3 and Layer II bit for bit or else within amplitude-scaled RMS
     5e-7, the max abs difference printed), each run's launches counted
     alone (K1 and K2 once per data shard, K3 3 x 4 times and K4 never in
     the FLAC decode, i.e. K5 three times), each K1, K2 and K3 call's
     inputs kept and the kernel held against its twin on them (K1 and K3
     exactly, K2 within atol 1e-4 / rtol 1e-5) and timed, and the wall of
     a second run beside the single card's; bench.py's render over
     ``model`` (two chains of 64 blocks bit-identical, each block within
     2e-6 of the single-card render, positions equal); K5 at the 16-file
     FLAC group's PCM windows over the 4 data shards, exact against its
     plain twin and timed beside it, its bound and ``index_add_``.  Where
     more than one card is visible it repeats the decodes and the render
     over the cards and prints how often the cross-card NCCL reduce ran.

With ``--profile`` it then profiles one decode of the 16 FLAC files with
torch.profiler and prints each FLAC stage's host and device time (the
full table goes to chiprun_out/flac_profile.txt), then one decode of the
families folder (stage spans ``pcm.*``, ``adpcm.*``, ``l12.*``; table in
chiprun_out/families_profile.txt) and each ADPCM kind's scan alone with
its kernel launches.

Every phase is fatal.  The kernels line gives each kernel's launches on
the main path, the streams (``streams``), the Layer I/II path
(``layer12``), the engine's decode (``engine``) and the sharded runs
(``multichip``); K5 (``window_add_spmd``) has its own entry.  The last line of
standard output is
``{"ok": true, "device": {...}}``; the line before it names the card and
its power limit, and the line before that lists the kernels.

With ``--phase multichip`` it builds, writes the main path's WAV files
and a seeded Layer II stream, and runs phase 13 alone (about a minute):
the quick check of the cross-card path on a machine with several cards.

Usage:  python3 chip_smoke.py [--seed N] [--profile] [--phase all|multichip]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port")
STEREO_MP3 = os.path.join(FIXTURES, "stereo_44k1_128k_js.mp3")
LSF_MP3 = os.path.join(FIXTURES, "mono_22k05_lsf.mp3")
MUSIC_FLAC = os.path.join(FIXTURES, "music_44k1_s16.flac")
MONO24_FLAC = os.path.join(FIXTURES, "mono_48k_s24.flac")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
N_WAV = N_MP3 = N_FLAC = 16
N_FAM, N_L12 = 16, 8  # copies per PCM/ADPCM family, per Layer I/II stream
ADPCM_BA = 2048
SECONDS = 10.0
RATE = 44100
# the card's published peaks (H100 SXM data sheet): memory rate, and f32
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def scaled_rms_ok(ref: np.ndarray, got: np.ndarray) -> tuple[bool, float, float]:
    """RMS of the difference against 5e-7 scaled by the signal's RMS/0.2
    (float32 round-off is relative to amplitude; the port's
    ``parallel.dryrun.scaled_rms``): (passes, RMS, bar)."""
    from audio_decoder_tpu_torch.parallel.dryrun import scaled_rms

    rms, bar = scaled_rms(ref, got)
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


def kernel_name(key: str) -> str:
    """A profiler kernel key without namespace, template or arguments."""
    name = key.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].split("<")[0].split("::")[-1]


def device_kernels(fn, reps: int) -> dict:
    """{kernel name: device milliseconds per call of ``fn``} for every
    kernel that ``reps`` calls launch, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / reps / 1e3
    return out


def dev_us(e, self_only: bool = False) -> float:
    """A profiler row's device microseconds (total or self), under either
    of torch's attribute names."""
    name = "self_device_time_total" if self_only else "device_time_total"
    legacy = "self_cuda_time_total" if self_only else "cuda_time_total"
    return getattr(e, name, None) or getattr(e, legacy, 0.0)


def bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """Least milliseconds for the work at the card's peaks: the larger of
    bytes moved over the memory rate and f32 operations over the f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    """Build every library at once, one compiler process each."""
    from audio_decoder_tpu_torch.codecs.flac import native as flac_native
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel, native
    from audio_decoder_tpu_torch.ops import synth_kernel, window_add
    from audio_decoder_tpu_torch.runtime import native as runtime_native
    from audio_decoder_tpu_torch.utils import build

    t0 = time.perf_counter()
    loaders = (huffman_kernel.load_library, synth_kernel.load_library,
               window_add.load_library, window_add.load_library2, native._load,
               flac_native._load, runtime_native.load_library)
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as ex:
        for f in [ex.submit(fn) for fn in loaders]:
            f.result()  # a BuildError carries the compiler's output
    secs = {k: round(v, 3) for k, v in build.BUILD_SECONDS.items()}
    log(f"build: {time.perf_counter() - t0:.3f} s total (in parallel); "
        f"per library {secs}")


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


def _lane_walk(bits, lane, n_big: int, n_quads: int) -> tuple[int, int]:
    """(pairs, quads) one lane of the entropy scan decodes, walked serially
    on the host with the scan's rules (huffman_device.scan_plain)."""
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_device as HD

    start, end, limit, bv, ra, rb, tsel, c1sel, valid = lane
    if valid <= 0:
        return 0, 0

    def peek(pos: int, n: int) -> int:  # bits outside the row read as 0
        v = 0
        for j in range(pos, pos + n):
            v = (v << 1) | (int(bits[j]) if 0 <= j < len(bits) else 0)
        return v

    pos, pairs = start, 0
    for p in range(min(bv, n_big)):
        region = (2 * p >= ra) + (2 * p >= rb)
        t = min(max(tsel[region], 0), 31)
        tid, lb = int(HD._KTID[t]), int(HD._KLIN[t])
        pairs += 1
        w = int(HD._BIG_WIDTH[tid])
        if w:
            e = int(HD._BIGLUT[HD._BIG_BASE[tid] + peek(pos, w)])
            ln, x, y = e >> 8, (e >> 4) & 15, e & 15
            pos += ln + (lb if x == 15 and lb else 0) + (x > 0) \
                + (lb if y == 15 and lb else 0) + (y > 0)
            if ln == 0:
                return pairs, 0
        if HD._KTID_RESERVED[t] or pos > end:
            return pairs, 0
    idx0 = min(2 * bv, 576)
    quads = 0
    while quads < n_quads and pos < end and idx0 + 4 * quads < 576:
        quads += 1
        o = int(HD._C1_LUT[int(c1sel > 0), peek(pos, 10)]) >> 8
        if pos + o > limit:
            break
        pos += o
    return pairs, quads


def _longest_lane(main, parts) -> tuple[int, int]:
    """(pairs, quads) of the lane with the most codes in the pass: lanes
    are walked in descending order of the most codes their side info
    allows, until no unwalked lane can beat the best walk."""
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_device as HD

    rows = np.unpackbits(main.cpu().numpy(), axis=1)
    cands = []
    for lanes, nb, nc in parts:
        cols = [a.cpu().numpy() for a in lanes]
        fidx, start, end, limit, bv, ra, rb, tsel, c1sel, valid = cols
        nb, nq = min(max(nb, 1), 512), HD.count1_quads(nc)
        for i in range(len(bv)):
            b = int(bv[i])
            most = (max(min(b, nb), 0)
                    + min(nq, max(0, -(-(576 - min(2 * b, 576)) // 4))))
            lane = (int(start[i]), int(end[i]), int(limit[i]), b, int(ra[i]),
                    int(rb[i]), [int(x) for x in tsel[i]], int(c1sel[i]),
                    int(valid[i]))
            cands.append((most if valid[i] > 0 else 0, int(fidx[i]), lane, nb, nq))
    cands.sort(key=lambda c: -c[0])
    best = (0, 0)
    for most, f, lane, nb, nq in cands:
        if most <= sum(best):
            break
        got = _lane_walk(rows[min(max(f, 0), len(rows) - 1)], lane, nb, nq)
        if sum(got) > sum(best):
            best = got
    return best


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

    # one pass is one launch per bucket; every K1 number is per launch
    n_k1 = len(parts)
    k1_ms = cuda_ms(run_k1, 20) / n_k1
    k1_plain_ms = cuda_ms(run_k1_plain, 2) / n_k1
    # each input read once (the byte rows once for all buckets), each
    # output written once
    k1_bytes = nbytes(main) + sum(
        nbytes(*lanes, *HK.entropy_scan(main, *lanes, n_big=nb, n_c1=nc))
        for lanes, nb, nc in parts)
    k1_bound, k1_by = bound(k1_bytes / n_k1)
    log(f"K1 time: {n_k1} launches per pass; per launch kernel {k1_ms:.4f} "
        f"ms, plain {k1_plain_ms:.4f} ms, bound {k1_bound:.4f} ms "
        f"({k1_bytes} bytes per pass)")
    pairs, quads = _longest_lane(main, parts)
    log(f"K1 serial chain: the longest lane decodes {pairs + quads} codes "
        f"({pairs} big-values pairs + {quads} count1 quads), one after the "
        "other")

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
    # per row and step: the 32 -> 64 matrixing and the 16-tap FIR over 32
    # outputs, 2 f32 operations per multiply-add
    k2_flops = 2.0 * B * C * T * (64 * 32 + 16 * 32)
    k2_bound, k2_by = bound(nbytes(ts, c["synth_n"], c["g2"], got), k2_flops)
    log(f"K2 time: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, "
        f"bound {k2_bound:.4f} ms ({k2_by}; {k2_flops:.4g} flop)")
    return [
        dict(name="mp3_entropy_scan", route="cuda",
             source="audio_decoder_tpu_torch/csrc/mp3_entropy.cu",
             replaces="audio_decoder_tpu/codecs/mpeg/huffman_pallas.py:335",
             launches=0, max_abs_err=max_err, ms=k1_ms, plain_ms=k1_plain_ms,
             bound_ms=k1_bound, bound_by=k1_by, library_ms=None),
        dict(name="mp3_polyphase_synthesis", route="cuda",
             source="audio_decoder_tpu_torch/csrc/mp3_synth.cu",
             replaces="audio_decoder_tpu/ops/pallas_synth.py:50",
             launches=0, max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
             bound_ms=k2_bound, bound_by=k2_by, library_ms=None),
    ]


def _flac_windows(dev, path: str = MUSIC_FLAC, copies: int = N_FLAC):
    """The two window-add calls' inputs of a FLAC group (by default the
    16-file one), as the FLAC path builds them (``stage="windows"`` of the
    device program)."""
    from audio_decoder_tpu_torch.codecs.flac import decoder as FD
    from audio_decoder_tpu_torch.codecs.flac import device as FV
    from audio_decoder_tpu_torch.codecs.flac import frontend

    blob = open(path, "rb").read()
    analyses = frontend.analyze_batch([blob] * copies)
    for a in analyses:
        if isinstance(a, Exception):
            fail(f"the FLAC fixture does not walk: {a!r}")
    args, statics = FD.pack_wire(analyses, dev)
    log(f"FLAC group statics: {statics}")
    return FV.flac_decode_wire(*args, stage="windows", **statics)


def _index_add_call(sets, n_out: int):
    """One ``index_add_`` computing the same window sum (indices and the
    flat updates built here, outside the timed call)."""
    idx, upd = [], []
    for s, u in sets:
        st = torch.cummax(s.to(torch.int64), 0).values
        w = torch.arange(u.shape[1], dtype=torch.int64, device=u.device)
        idx.append((st[:, None] + w).clamp_(max=n_out).reshape(-1))
        upd.append(u.reshape(-1))
    idx, upd = torch.cat(idx), torch.cat(upd)
    dtype = sets[0][1].dtype
    return lambda: torch.zeros((n_out + 1,), dtype=dtype,
                               device=upd.device).index_add_(0, idx, upd)


def phase_flac_kernels(dev) -> list[dict]:
    from audio_decoder_tpu_torch.ops import window_add as PW

    w = _flac_windows(dev)
    out = []
    for name, tag, fn, plain, replaces, source in (
            ("window_add2", "K4", PW.window_add2, PW.window_add2_plain,
             "audio_decoder_tpu/ops/window_add.py:255", "window_add2.cu"),
            ("window_add", "K3", PW.window_add, PW.window_add_plain,
             "audio_decoder_tpu/ops/window_add.py:215", "window_add.cu")):
        *arrays, n_out = w[name]
        sets = list(zip(arrays[0::2], arrays[1::2]))
        got, ref = fn(*arrays, n_out), plain(*arrays, n_out)
        lib = _index_add_call(sets, n_out)
        torch.cuda.synchronize()
        if got.dtype != ref.dtype or got.shape != ref.shape:
            fail(f"{tag} {name}: {got.dtype} {tuple(got.shape)} vs the plain "
                 f"twin's {ref.dtype} {tuple(ref.shape)}")
        if not torch.equal(got, ref):
            fail(f"{tag} {name} differs from its plain twin in "
                 f"{int((got != ref).sum())} of {n_out} elements")
        if not torch.equal(lib()[:n_out], ref):
            fail(f"{tag}: index_add_ yardstick differs from the plain twin")
        err = float((got.double() - ref.double()).abs().max()) if n_out else 0.0
        shapes = ", ".join(f"starts {tuple(s.shape)} upd {tuple(u.shape)} "
                           f"{u.dtype}" for s, u in sets)
        log(f"{tag} {name}: exact match ({shapes}; n_out {n_out})")
        ms = cuda_ms(lambda: fn(*arrays, n_out), 50)
        plain_ms = cuda_ms(lambda: plain(*arrays, n_out), 20)
        library_ms = cuda_ms(lib, 20)
        b_ms, by = bound(nbytes(*arrays) + n_out * got.element_size())
        # the same call without the tail of all-zero padding lanes, which
        # the packers pile onto the last live start
        live = []
        for st, u in sets:
            nz = torch.nonzero(u.reshape(u.shape[0], -1).ne(0).any(1))
            n = int(nz.max()) + 1 if nz.numel() else 0
            live += [st[:n], u[:n]]
        live_ms = cuda_ms(lambda: fn(*live, n_out), 50)
        log(f"{tag} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"index_add_ {library_ms:.4f} ms, bound {b_ms:.4f} ms ({by}); "
            f"kernel on the {[int(t.shape[0]) for t in live[::2]]} lanes "
            f"before the zero tail {live_ms:.4f} ms")
        # its device time, per kernel, whole and split
        for label, args in (("", arrays), ("before the zero tail, ", live)):
            kern = device_kernels(lambda a=args: fn(*a, n_out), 20)
            per = ", ".join(f"{kernel_name(k)} {v:.4f}" for k, v in kern.items())
            log(f"{tag} device, {label}ms per call: {sum(kern.values()):.4f} "
                f"({per})")
        out.append(dict(
            name=name, route="cuda",
            source=f"audio_decoder_tpu_torch/csrc/{source}",
            replaces=replaces,
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=by, library_ms=library_ms))
    # K3 at the second group's shapes: the 24-bit mono fixture (48 frame
    # rows of 4096; the log counts starts that are not multiples of 4)
    starts, upd, n_mono = _flac_windows(dev, MONO24_FLAC, 1)["window_add"]
    got = PW.window_add(starts, upd, n_mono)
    ref = PW.window_add_plain(starts, upd, n_mono)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        fail(f"K3 window_add differs from its plain twin at the mono group in "
             f"{int((got != ref).sum())} of {n_mono} elements")
    log(f"K3 window_add at the 24-bit mono group: exact (starts "
        f"{tuple(starts.shape)} upd {tuple(upd.shape)}; "
        f"{int((starts % 4 != 0).sum())} starts not multiples of 4)")
    return out


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


def write_flac_folder(folder: str, seed: int) -> dict:
    """The FLAC folder; returns {stem: source path} of the good files."""
    rng = np.random.default_rng(seed + 1)
    for i in range(N_FLAC):
        shutil.copyfile(MUSIC_FLAC, os.path.join(folder, f"g{i:02d}.flac"))
    shutil.copyfile(MONO24_FLAC, os.path.join(folder, "mono24.flac"))
    with open(os.path.join(folder, "corrupt.flac"), "wb") as f:
        f.write(b"fLaC" + rng.integers(0, 256, size=8192).astype(np.uint8).tobytes())
    music = open(MUSIC_FLAC, "rb").read()
    with open(os.path.join(folder, "truncated.flac"), "wb") as f:
        f.write(music[: len(music) // 2])
    good = {f"g{i:02d}": MUSIC_FLAC for i in range(N_FLAC)}
    good["mono24"] = MONO24_FLAC
    return good


def phase_flac_path(folder: str, good: dict, dev) -> dict:
    import audio_decoder_tpu_torch as adt
    from audio_decoder_tpu_torch.ops import window_add as PW

    for k in PW.launches:
        PW.launches[k] = 0
    batch, names = adt.decode_dir(folder, device=dev)
    torch.cuda.synchronize()
    launches = dict(PW.launches)
    log(f"FLAC path launches: {launches}")
    for k in ("window_add", "window_add2"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the FLAC path")
    if batch.data.device.type != dev.type or not torch.isfinite(batch.data).all():
        fail(f"FLAC batch is not finite PCM on {dev}")

    # the port's CPU path (plain twins) on the same bytes
    paths = [os.path.join(folder, f"{n}.flac")
             for n in ("mono24", "corrupt", "truncated")] + [MUSIC_FLAC]
    ref = adt.decode_paths(paths, device="cpu")
    ref_of = {"mono24": 0, "corrupt": 1, "truncated": 2}
    err = batch.err.cpu().numpy()
    checked = 0
    for name in batch.names:
        r = ref_of.get(name, 3)
        code, want = int(err[names[name]]), int(ref.err[r])
        if code != want:
            fail(f"{name}.flac has error code {code}, the CPU path {want}")
        if name == "corrupt" and code == 0:
            fail("corrupt.flac decoded without an error code")
        if name in good and code != 0:
            fail(f"{name}.flac has error code {code}")
        if code != 0:
            continue
        got, cpu = batch.file(names[name]), ref.file(r)
        if got.pcm.shape != cpu.pcm.shape or not np.array_equal(got.pcm, cpu.pcm):
            fail(f"{name}.flac PCM on the card differs from the CPU path")
        if name not in good:
            continue
        if not _md5_ok(good[name], got):
            fail(f"{name}.flac fails its STREAMINFO MD5")
        checked += 1
    codes = {n: int(err[names[n]]) for n in ("corrupt", "truncated")}
    log(f"FLAC: {checked} files equal the CPU path bit for bit and pass "
        f"their STREAMINFO MD5; error codes {codes}")
    return launches


def _md5_ok(path: str, got) -> bool:
    """The decoded file's integers against its STREAMINFO MD5."""
    from audio_decoder_tpu_torch.codecs.flac import frontend

    an = frontend.analyze(open(path, "rb").read())
    ints = np.round(got.pcm.astype(np.float64)
                    * 2.0 ** (got.bits_per_sample - 1)).astype(np.int64)
    return frontend.verify_md5(an, ints) is True


def phase_flac_chunked(dev) -> dict:
    """The frame-chunked FLAC route: the music fixture past a shrunken
    ``frontend.BIT_CAP`` decodes chunk by chunk, on the card and on the CPU."""
    import audio_decoder_tpu_torch as adt
    from audio_decoder_tpu_torch.codecs.flac import frontend
    from audio_decoder_tpu_torch.ops import window_add as PW

    cap = frontend.BIT_CAP
    frontend.BIT_CAP = 8 * os.path.getsize(MUSIC_FLAC)  # the file is past it
    try:
        for k in PW.launches:
            PW.launches[k] = 0
        t0 = time.perf_counter()
        gpu = adt.decode_paths([MUSIC_FLAC], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(PW.launches)
        cpu = adt.decode_paths([MUSIC_FLAC], device="cpu")
    finally:
        frontend.BIT_CAP = cap
    log(f"FLAC chunked route launches: {launches} ({wall:.3f} s on the card)")
    if launches["window_add"] < 2:
        fail(f"the chunked route launched K3 {launches['window_add']} times: "
             "the file did not decode in chunks")
    if int(gpu.err[0]) != 0 or int(cpu.err[0]) != 0:
        fail(f"chunked route error codes {int(gpu.err[0])} (card), "
             f"{int(cpu.err[0])} (CPU)")
    got, ref = gpu.file(0), cpu.file(0)
    if got.pcm.shape != ref.pcm.shape or not np.array_equal(got.pcm, ref.pcm):
        fail("the chunked route's PCM on the card differs from the CPU path")
    if not _md5_ok(MUSIC_FLAC, got):
        fail("the chunked route's PCM fails its STREAMINFO MD5")
    log(f"FLAC chunked route: {got.pcm.shape[0]} frames equal the CPU path "
        f"bit for bit and pass the STREAMINFO MD5")
    return launches


def _rate(label: str, assets, card: str) -> None:
    import audio_decoder_tpu_torch as adt

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
        f"{label} {rates} audio-s/s  [{card}]")


def phase_rate(folder: str, flac_folder: str, card: str) -> None:
    from audio_decoder_tpu_torch.io.assets import load_assets, scan_assets

    mixed = load_assets(scan_assets(folder))
    flac = load_assets(scan_assets(flac_folder))
    flac16 = [a for a in flac if a.name.startswith("g")]
    _rate("decode_throughput_mixed", mixed, card)
    _rate("flac_only (16 FLAC)", flac16, card)
    three = ([a for a in mixed if a.name.startswith("w")]
             + [a for a in mixed if a.ext == "mp3" and a.name != "lsf"] + flac16)
    if len(three) != N_WAV + N_MP3 + N_FLAC:
        fail(f"the three-family batch has {len(three)} files")
    _rate("wav_mp3_flac (16 + 16 + 16)", three, card)


def phase_profile(flac_folder: str, card: str) -> None:
    """torch.profiler over one decode of the 16 FLAC files: host and device
    milliseconds of each FLAC stage span, and the device's idle share."""
    import audio_decoder_tpu_torch as adt
    from audio_decoder_tpu_torch.io.assets import load_assets, scan_assets
    from torch.profiler import ProfilerActivity, profile

    assets = [a for a in load_assets(scan_assets(flac_folder))
              if a.name.startswith("g")]
    adt.decode_assets(assets, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        adt.decode_assets(assets, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    rows = prof.key_averages()
    busy = sum(dev_us(e, True) for e in rows if not e.key.startswith("flac."))
    log(f"profile: wall {wall * 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"(idle share {1 - busy / 1e3 / (wall * 1e3):.3f})  [{card}]")
    for e in sorted((e for e in rows if e.key.startswith("flac.")),
                    key=lambda e: e.key):
        log(f"profile span {e.key}: calls {e.count}, host "
            f"{e.cpu_time_total / 1e3:.3f} ms, device {dev_us(e) / 1e3:.3f} ms")
    # the window-add wrappers alone: which of their launches takes the time
    from audio_decoder_tpu_torch.ops import window_add as PW

    w = _flac_windows(torch.device("cuda"))
    calls = ((PW.window_add2, w["window_add2"]), (PW.window_add, w["window_add"]))
    for fn, a in calls:
        fn(*a)
    torch.cuda.synchronize()
    reps = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as kprof:
        for fn, a in calls:
            for _ in range(reps):
                fn(*a)
        torch.cuda.synchronize()
    krows = sorted((e for e in kprof.key_averages() if dev_us(e, True) > 0),
                   key=lambda e: -dev_us(e, True))
    for e in krows[:12]:
        log(f"profile window-add kernel {e.key[:60]}: calls {e.count}, device "
            f"{dev_us(e, True) / e.count / 1e3:.4f} ms per call  [{card}]")
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "flac_profile.txt")
    with open(path, "w") as f:
        f.write(f"{card}\n")
        f.write(rows.table(sort_by="self_device_time_total", row_limit=60))
        f.write("\nwindow-add wrappers, 10 calls each\n")
        f.write(kprof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=30))
    log(f"profile table: {path}")


# ---------------------------------------------------------------------------
# Phase 8: AIFF, AU, CAF, the ADPCM unpackers and MPEG Layers I/II
# ---------------------------------------------------------------------------

#: family kind → (extension, copies, format tag the decode reports)
KINDS = {
    "aiff24": ("aif", N_FAM, "aiff"), "sowt16": ("aifc", N_FAM, "aiff"),
    "ulaw": ("au", N_FAM, "au"), "caf_f32": ("caf", N_FAM, "caf"),
    "ima": ("wav", N_FAM, "wav"), "ms": ("wav", N_FAM, "wav"),
    "ima4": ("aifc", N_FAM, "aiff"), "layer1": ("mp1", N_L12, "mp1"),
    "layer2": ("mp2", N_L12, "mp2"),
}
#: TRACE stages of the families' decode, host milliseconds each
STAGES = ("pcm/parse", "adpcm/scan", "l12/analyze", "l12/requantize",
          "l12/synthesis")


def family_sources(seed: int) -> dict:
    """One 10 s 44.1 kHz stereo file per kind, from the seed: {kind: (bytes,
    reference)}, the reference being the int PCM (aiff24, sowt16), the
    numpy reference decoder's int16 PCM (ADPCM) or None."""
    from tests import ima_ref as IR
    from tests import ms_ref as MR
    from tests import seeded_writers as SW
    from tests.synth import make_aiff, make_au, make_caf

    rng = np.random.default_rng(seed + 2)
    frames = int(SECONDS * RATE)
    z2 = np.zeros((0, 2), np.int64)

    def ints(bits):
        return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1),
                            size=(frames, 2))

    t = np.arange(frames)
    tone = (9000 * np.sin(2 * np.pi * 440 * t / RATE)[:, None]
            * np.array([1.0, 0.7]) + rng.normal(0, 1500, (frames, 2)))
    tone = np.clip(tone, -32768, 32767).astype(np.int16)
    pcm24, pcm16 = ints(24), ints(16)
    ima = IR.encode(tone, ADPCM_BA)
    ms = MR.encode(tone, ADPCM_BA)
    ima4 = IR.encode_ima4(tone)
    return {
        "aiff24": (make_aiff(pcm24, RATE, 24), pcm24 / 2.0 ** 23),
        "sowt16": (make_aiff(pcm16, RATE, 16, compression=b"sowt"),
                   pcm16 / 2.0 ** 15),
        "ulaw": (make_au(z2, RATE, 1, data_override=rng.integers(
            0, 256, size=2 * frames).astype(np.uint8).tobytes()), None),
        "caf_f32": (make_caf(np.clip(rng.standard_normal((frames, 2)) * 0.3,
                                     -1, 1).astype(np.float32), RATE,
                             bits=32, little=True, float_=True), None),
        "ima": (SW.ima_wav(ima, 2, ADPCM_BA), IR.decode(ima, 2, ADPCM_BA)),
        "ms": (SW.ms_wav(ms, 2, ADPCM_BA), MR.decode(ms, 2, ADPCM_BA)),
        "ima4": (make_aiff(z2, RATE, 16, compression=b"ima4",
                           data_override=ima4, frames_override=frames),
                 IR.decode_ima4(ima4, 2, n_frames=frames)),
        "layer1": (SW.layer1_frames(rng, -(-frames // 384), 2), None),
        "layer2": (SW.layer2_frames(rng, -(-frames // 1152), 2, sr=RATE,
                                    kbps=192), None),
    }


def write_families_folder(folder: str, seed: int) -> dict:
    """The families folder; returns family_sources(seed)."""
    t0 = time.perf_counter()
    src = family_sources(seed)
    rng = np.random.default_rng(seed + 3)
    for kind, (ext, copies, _fmt) in KINDS.items():
        for i in range(copies):
            with open(os.path.join(folder, f"{kind}_{i:02d}.{ext}"), "wb") as f:
                f.write(src[kind][0])
    bad = {"truncated.aif": src["aiff24"][0][: len(src["aiff24"][0]) // 2],
           "garbage.au": rng.integers(0, 256, 4096).astype(np.uint8).tobytes(),
           "random.mp2": rng.integers(0, 256, 8192).astype(np.uint8).tobytes()}
    for name, blob in bad.items():
        with open(os.path.join(folder, name), "wb") as f:
            f.write(blob)
    log(f"families folder written in {time.perf_counter() - t0:.3f} s "
        f"(sources, copies and the reference ADPCM decodes)")
    return src


def _kind(name: str) -> str:
    return name.rsplit("_", 1)[0]


def phase_families(folder: str, src: dict, dev) -> int:
    """Decode the families folder on the card and on the CPU and hold the
    two (and the references) against each other; returns K2's launches."""
    import audio_decoder_tpu_torch as adt
    from audio_decoder_tpu_torch.core import errors as E
    from audio_decoder_tpu_torch.ops import synth_kernel as SK

    SK.launches = 0
    t0 = time.perf_counter()
    gpu, names = adt.decode_dir(folder, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = SK.launches
    log(f"families path launches: {{'mp3_polyphase_synthesis': {k2}}} "
        f"({wall:.3f} s on the card, first run)")
    if k2 <= 0:
        fail("the Layer I/II path did not launch the synthesis kernel (K2)")
    if gpu.data.device.type != dev.type or not torch.isfinite(gpu.data).all():
        fail(f"families batch is not finite PCM on {dev}")
    cpu, cnames = adt.decode_dir(folder, device="cpu")
    if cnames != names or cpu.names != gpu.names or cpu.formats != gpu.formats:
        fail("families: names or formats differ between the card and the CPU")
    for k in ("sample_rate", "num_channels", "bits_per_sample",
              "valid_frames", "err"):
        if not torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)):
            fail(f"families: {k} differs between the card and the CPU")

    # random.mp2 may hold a chance frame sync (then a short Layer I/II
    # stream decodes): it is held to the CPU path's code only
    err = dict(zip(gpu.names, gpu.err.cpu().tolist()))
    want = {"truncated": E.ERR_EOF, "garbage": E.ERR_UNSUPPORTED}
    for name, code in err.items():
        if name in want and code != want[name]:
            fail(f"{name} has error code {code}, want {want[name]}")
        if name not in want and name != "random" and code != 0:
            fail(f"{name} has error code {code}")

    worst = 0.0
    counts: dict = {}
    for name in gpu.names:
        kind = _kind(name)
        if kind not in KINDS:
            continue
        i = names[name]
        got, ref = gpu.file(i), cpu.file(i)
        if got.format != KINDS[kind][2] or got.pcm.shape != ref.pcm.shape:
            fail(f"{name}: format {got.format}, shape {got.pcm.shape} vs the "
                 f"CPU path's {ref.pcm.shape}")
        if kind.startswith("layer"):
            ok, rms, bar = scaled_rms_ok(ref.pcm, got.pcm)
            worst = max(worst, rms / bar)
            if not ok:
                fail(f"{name} RMS {rms:.3e} vs the CPU path exceeds {bar:.3e}")
        elif not np.array_equal(got.pcm, ref.pcm):
            fail(f"{name} PCM on the card differs from the CPU path")
        expect = src[kind][1]
        if expect is not None and counts.get(kind, 0) == 0:
            if kind in ("ima", "ms", "ima4"):
                ints = np.round(got.pcm.astype(np.float64) * 32768.0)
                same = ints.shape == expect.shape and np.array_equal(ints, expect)
            else:
                same = np.array_equal(got.pcm, expect.astype(np.float32))
            if not same:
                fail(f"{name} PCM differs from its reference")
        counts[kind] = counts.get(kind, 0) + 1
    for kind, (_ext, copies, _fmt) in KINDS.items():
        if counts.get(kind) != copies:
            fail(f"families: {counts.get(kind)} {kind} files, want {copies}")
    log(f"families: {sum(counts.values())} files on the card equal the CPU "
        f"path (integer families bit for bit; Layer I/II worst rms/bar "
        f"{worst:.3f}); ADPCM equal to the reference decoders, AIFF to the "
        f"source integers; error codes { {n: err[n] for n in ('truncated', 'garbage', 'random')} }")
    return k2


def phase_families_k2(dev, src: dict) -> list[dict]:
    """K2 against its plain twin at the Layer I/II groups' shapes (the
    folder's 8-file groups) and at T = 2048·12 and 512·36 (BC = 16), with
    CUDA-event times and the bytes/operations bound."""
    from audio_decoder_tpu_torch.codecs.mpeg import decoder as D
    from audio_decoder_tpu_torch.codecs.mpeg import dsp
    from audio_decoder_tpu_torch.codecs.mpeg import layer12 as L12

    c = dsp._consts(dev)
    cases = []
    for kind, analyze in (("layer1", L12.analyze_l1),
                          ("layer2", L12.analyze_l2)):
        an = analyze(src[kind][0])
        TS = L12.l12_subband_samples(*D.pack_layer12([an] * N_L12, dev))
        B, C, T, _ = TS.shape
        cases.append((f"{kind} group", TS.reshape(B * C, T, 32).contiguous()))
    gen = torch.Generator(device=dev).manual_seed(5)
    for steps, frames in ((12, 2048), (36, 512)):
        cases.append((f"T = {frames}·{steps}", torch.randn(
            (16, frames * steps, 32), device=dev, generator=gen)))
    return [_k2_timed(label, ts, c) for label, ts in cases]


def phase_families_rate(folder: str, card: str, dev) -> None:
    """Each kind's files decoded alone on the card (after the checked run),
    audio-seconds per second with the host milliseconds of each stage."""
    import audio_decoder_tpu_torch as adt
    from audio_decoder_tpu_torch.io.assets import load_assets, scan_assets
    from audio_decoder_tpu_torch.utils.trace import TRACE

    assets = load_assets(scan_assets(folder))
    for kind in KINDS:
        sub = [a for a in assets if _kind(a.name) == kind]
        TRACE.reset()
        t0 = time.perf_counter()
        b = adt.decode_assets(sub, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        audio_s = float(b.audio_seconds())
        stages = {k: round(TRACE.stats[k].seconds * 1e3, 3)
                  for k in STAGES if k in TRACE.stats}
        log(f"rate: family {kind} ({len(sub)} files, {audio_s:.3f} audio-s): "
            f"wall {wall * 1e3:.3f} ms, {audio_s / wall:.3f} audio-s/s; host "
            f"ms per stage {stages}  [{card}]")


def phase_families_profile(folder: str, card: str, dev) -> None:
    """torch.profiler over one decode of the families folder (host and
    device ms per stage span, the device's idle share), then each ADPCM
    kind's files alone: the scan's host ms and its kernel launches."""
    import audio_decoder_tpu_torch as adt
    from audio_decoder_tpu_torch.io.assets import load_assets, scan_assets
    from torch.profiler import ProfilerActivity, profile

    assets = load_assets(scan_assets(folder))
    prefixes = ("pcm.", "adpcm.", "l12.")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        adt.decode_assets(assets, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    busy = sum(dev_us(e, True) for e in rows if not e.key.startswith(prefixes))
    log(f"profile families: wall {wall * 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms (idle share {1 - busy / 1e3 / (wall * 1e3):.3f})"
        f"  [{card}]")
    # each span has a host entry (host time; its kernels' device time) and
    # a device-side entry (first to last kernel on the device's timeline)
    for e in sorted((e for e in rows if e.key.startswith(prefixes)),
                    key=lambda e: (e.key, -e.cpu_time_total)):
        if e.cpu_time_total > 0:
            log(f"profile span {e.key}: calls {e.count}, host "
                f"{e.cpu_time_total / 1e3:.3f} ms, its kernels "
                f"{dev_us(e) / 1e3:.3f} ms")
        else:
            log(f"profile span {e.key}: device timeline "
                f"{dev_us(e) / 1e3:.3f} ms")
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "families_profile.txt")
    with open(path, "w") as f:
        f.write(f"{card}\n")
        f.write(rows.table(sort_by="self_device_time_total", row_limit=60))
    log(f"profile table: {path}")

    for kind in ("ima", "ms", "ima4"):
        sub = [a for a in assets if _kind(a.name) == kind]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as kprof:
            adt.decode_assets(sub, device=dev)
            torch.cuda.synchronize()
        events = kprof.events()
        spans = [e.time_range for e in events if e.name == "adpcm.scan"]
        launches = sum(
            1 for e in events if e.name.startswith("cudaLaunchKernel")
            and any(s.start <= e.time_range.start <= s.end for s in spans))
        scan = [e for e in kprof.key_averages()
                if e.key == "adpcm.scan" and e.cpu_time_total > 0]
        if not scan or launches == 0:
            fail(f"the ADPCM scan of {kind} left no span or launched nothing")
        log(f"profile ADPCM scan {kind} ({len(sub)} files): host "
            f"{scan[0].cpu_time_total / 1e3:.3f} ms, its kernels "
            f"{dev_us(scan[0]) / 1e3:.3f} ms, {launches} kernel launches  "
            f"[{card}]")


# ---------------------------------------------------------------------------
# Phase 9: the single-file streams (stream_file); phase 10: the batch DSP
# ---------------------------------------------------------------------------

STREAM_MP3_COPIES = 18  # the 10 s stereo fixture 18 times: 180 s
STREAM_L12_SECONDS = 30
STREAM_WAV_SECONDS = 600
STREAM_PCM_SECONDS = 60
#: each stream's seek quantum: granule, frame, block or chunk (a seek must
#: land inside one)
SEEK_QUANTA = (576, 384, 1152, 2041, 4096, 1 << 17)


def write_stream_files(folder: str, seed: int) -> dict:
    """One long file per stream kind, from the seed: {kind: path}."""
    from tests import seeded_writers as SW
    from tests.synth import make_aiff

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 4)
    blobs = {
        "mp3": ("long.mp3", open(STEREO_MP3, "rb").read() * STREAM_MP3_COPIES),
        "layer1": ("long.mp1", SW.layer1_frames(
            rng, -(-STREAM_L12_SECONDS * RATE // 384), 2)),
        "layer2": ("long.mp2", SW.layer2_frames(
            rng, -(-STREAM_L12_SECONDS * RATE // 1152), 2, sr=RATE, kbps=192)),
        "wav": ("long.wav", wav_blob(rng.integers(
            -32768, 32768, size=(STREAM_WAV_SECONDS * RATE, 2), dtype=np.int16),
            RATE)),
        "aiff24": ("long.aif", make_aiff(rng.integers(
            -(1 << 23), 1 << 23, size=(STREAM_PCM_SECONDS * RATE, 2)), RATE, 24)),
    }
    # IMA ADPCM blocks of random nibbles under valid headers (step index
    # 0..88, reserved byte 0): any nibble decodes, so no encoder is needed
    spb = SW.ima_spb(ADPCM_BA, 2)
    ima = rng.integers(0, 256, size=(-(-STREAM_PCM_SECONDS * RATE // spb),
                                     ADPCM_BA), dtype=np.uint8)
    ima[:, [2, 6]] %= 89
    ima[:, [3, 7]] = 0
    blobs["ima"] = ("long_ima.wav", SW.ima_wav(ima.tobytes(), 2, ADPCM_BA))
    paths = {}
    for kind, (name, blob) in blobs.items():
        paths[kind] = os.path.join(folder, name)
        with open(paths[kind], "wb") as f:
            f.write(blob)
    paths["flac"] = MUSIC_FLAC
    log(f"stream files written in {time.perf_counter() - t0:.3f} s: "
        + ", ".join(f"{k} {os.path.getsize(p)} B" for k, p in paths.items()))
    return paths


def _seek_sample(total: int) -> int:
    """A sample five sixths of the way in (the seek decodes the rest) that
    no seek quantum divides."""
    s = total * 5 // 6 + 7
    while any(s % q == 0 for q in SEEK_QUANTA):
        s += 1
    return s


#: the kernels each stream launches once per chunk; it launches no other
STREAM_KERNELS = {
    "mp3": ("mp3_entropy_scan", "mp3_polyphase_synthesis"),
    "layer1": ("mp3_polyphase_synthesis",),
    "layer2": ("mp3_polyphase_synthesis",),
    "flac": ("window_add", "window_add2"),
}


def _zero_kernel_counts() -> None:
    """Set every kernel's launch count to 0."""
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel as HK
    from audio_decoder_tpu_torch.ops import synth_kernel as SK
    from audio_decoder_tpu_torch.ops import window_add as PW

    HK.launches = 0
    SK.launches = 0
    for k in PW.launches:
        PW.launches[k] = 0


def _kernel_counts() -> dict:
    """{kernel: launches since the counts were last set to 0}."""
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel as HK
    from audio_decoder_tpu_torch.ops import synth_kernel as SK
    from audio_decoder_tpu_torch.ops import window_add as PW

    return {"mp3_entropy_scan": HK.launches, "mp3_polyphase_synthesis": SK.launches,
            **PW.launches}


def _counted_stream(kind: str, path: str, dev, start_sample: int = 0):
    """One ``stream_file(device="cuda")`` run with every launch count set
    to 0 just before it and read just after it: (chunks, seconds to the
    first chunk, wall seconds, {kernel: launches}).  Fails unless each
    kernel of ``STREAM_KERNELS[kind]`` launched once per chunk and no
    other kernel launched."""
    import audio_decoder_tpu_torch as adt

    _zero_kernel_counts()
    chunks, first = [], None
    t0 = time.perf_counter()
    for c in adt.stream_file(path, start_sample=start_sample, device=dev):
        if first is None:
            first = time.perf_counter() - t0
        chunks.append(c)
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    want = {k: len(chunks) if k in STREAM_KERNELS.get(kind, ()) else 0
            for k in counts}
    if counts != want:
        fail(f"stream {kind} from sample {start_sample}: launches {counts}, "
             f"want {want} ({len(chunks)} chunks)")
    return chunks, first, wall, counts


def phase_streams(paths: dict, dev, card: str) -> dict:
    """Every stream through ``stream_file(device="cuda")`` at the default
    chunk sizes and once from a seek, each against the one-shot
    ``decode_paths(device="cuda")`` of the same file bit for bit; prints
    the rates, the time to the first chunk, the chunk count and the peak
    device memory of the stream and of the one-shot decode.  Each stream
    run is counted on its own (``_counted_stream``); returns {kernel:
    {stream kind: launches over its two runs}}."""
    import audio_decoder_tpu_torch as adt

    per_kernel: dict = {}
    for kind, path in paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        one = adt.decode_paths([path], device=dev)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        one_peak = torch.cuda.max_memory_allocated() - base
        f = one.file(0)
        if f.err != 0:
            fail(f"stream {kind}: the one-shot decode has error code {f.err}")
        ref, rate = f.pcm[:, : f.num_channels], f.sample_rate
        del one
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        chunks, first, wall, counts = _counted_stream(kind, path, dev)
        peak = torch.cuda.max_memory_allocated() - base
        got = np.concatenate(chunks)
        if got.shape != ref.shape or not np.array_equal(got, ref):
            bad = (int((got != ref).sum()) if got.shape == ref.shape
                   else f"shape {got.shape} vs {ref.shape}")
            fail(f"stream {kind}: the chunks differ from the one-shot decode "
                 f"on the card ({bad})")
        s = _seek_sample(len(ref))
        seek, _f, _w, seek_counts = _counted_stream(kind, path, dev, s)
        if not np.array_equal(np.concatenate(seek), ref[s:]):
            fail(f"stream {kind}: the chunks from sample {s} differ from the "
                 "one-shot decode")
        if kind == "wav" and 4 * peak >= one_peak:
            fail(f"stream wav: peak device memory {peak} B is not bounded by "
                 f"the chunk (one-shot {one_peak} B)")
        for k in STREAM_KERNELS.get(kind, ()):
            per_kernel.setdefault(k, {})[kind] = counts[k] + seek_counts[k]
        audio_s = len(ref) / rate
        log(f"stream {kind}: {len(chunks)} chunks, {audio_s:.3f} audio-s, wall "
            f"{wall:.3f} s, {audio_s / wall:.3f} audio-s/s, first chunk "
            f"{first * 1e3:.3f} ms; peak device memory {peak} B (one-shot "
            f"{one_peak} B, {one_s:.3f} s); equal to the one-shot decode bit "
            f"for bit, also from sample {s} ({len(seek)} chunks); launches "
            f"{ {k: n for k, n in counts.items() if n} }, from the seek "
            f"{ {k: n for k, n in seek_counts.items() if n} }  [{card}]")
    log(f"streams launches, each stream run counted on its own: {per_kernel}")
    return per_kernel


def _k1_timed(label: str, main, lanes, nb: int, nc: int) -> dict:
    """K1 against the plain scan on one bucket's inputs exactly, timed
    beside it with its bytes bound."""
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_device as HD
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel as HK

    got = HK.entropy_scan(main, *lanes, n_big=nb, n_c1=nc)
    ref = HD.scan_plain(main, *lanes, n_big=nb, n_c1=nc)
    for name, g, r in zip(("big576", "c1", "fail"), got, ref):
        if not torch.equal(g, r):
            fail(f"K1 {name} at the {label} differs from the plain scan in "
                 f"{int((g != r).sum())} entries")
    ms = cuda_ms(lambda: HK.entropy_scan(main, *lanes, n_big=nb, n_c1=nc), 50)
    plain_ms = cuda_ms(lambda: HD.scan_plain(main, *lanes, n_big=nb, n_c1=nc), 2)
    b_ms, by = bound(nbytes(main, *lanes, *got))
    log(f"K1 at the {label}: main_u8 {tuple(main.shape)}, "
        f"{lanes[0].shape[0]} lanes, n_big {nb}: exact; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    return dict(shape=[int(lanes[0].shape[0]), int(main.shape[1])],
                max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by)


def _k2_timed(label: str, ts, c) -> dict:
    """K2 against its plain twin on ``ts`` (within atol 1e-4 / rtol 1e-5),
    timed beside it with its bytes/operations bound."""
    from audio_decoder_tpu_torch.ops import synth_kernel as SK

    got = SK.polyphase_synthesis_blocks(ts, c["synth_n"], c["g2"])
    ref = SK.synthesis_plain(ts, c["synth_n"], c["g2"])
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, atol=1e-4, rtol=1e-5):
        fail(f"K2 at the {label} shape {tuple(ts.shape)} differs from "
             f"its plain form: max abs err {err}")
    ms = cuda_ms(lambda: SK.polyphase_synthesis_blocks(ts, c["synth_n"],
                                                       c["g2"]), 50)
    plain_ms = cuda_ms(lambda: SK.synthesis_plain(ts, c["synth_n"],
                                                  c["g2"]), 10)
    BC, T, _ = ts.shape
    flops = 2.0 * BC * T * (64 * 32 + 16 * 32)
    b_ms, by = bound(nbytes(ts, c["synth_n"], c["g2"], got), flops)
    log(f"K2 at the {label}: TS {tuple(ts.shape)}, max abs err {err:.3e} "
        f"(atol 1e-4, rtol 1e-5); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    return dict(shape=list(ts.shape), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)


def _window_timed(label: str, name: str, arrays, n_out: int) -> dict:
    """K3 (``window_add``) or K4 (``window_add2``) against its plain twin
    on ``arrays`` exactly, timed beside the twin and one ``index_add_``
    call of the same sum, with its bytes bound."""
    from audio_decoder_tpu_torch.ops import window_add as PW

    fn = getattr(PW, name)
    plain = getattr(PW, name + "_plain")
    got, ref = fn(*arrays, n_out), plain(*arrays, n_out)
    torch.cuda.synchronize()
    if got.dtype != ref.dtype or not torch.equal(got, ref):
        fail(f"{name} at the {label} differs from its plain twin")
    lib = _index_add_call(list(zip(arrays[0::2], arrays[1::2])), n_out)
    if not torch.equal(lib()[:n_out], ref):
        fail(f"{name} at the {label}: index_add_ differs from the plain twin")
    ms = cuda_ms(lambda: fn(*arrays, n_out), 50)
    plain_ms = cuda_ms(lambda: plain(*arrays, n_out), 20)
    library_ms = cuda_ms(lib, 20)
    b_ms, by = bound(nbytes(*arrays) + n_out * got.element_size())
    shapes = [list(a.shape) for a in arrays]
    log(f"{name} at the {label}: inputs {shapes}, n_out {n_out}: exact; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    return dict(shape=shapes, n_out=n_out, max_abs_err=0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=library_ms)


def phase_stream_kernels(paths: dict, dev) -> tuple[list, list, dict]:
    """K1, K2, K3 and K4 against their twins at the streams' chunk shapes:
    a middle chunk of the 180 s MP3 (one K1 launch over (512 + 2)·2 lanes,
    K2 over 514·18 steps), the first chunk of the Layer I and II streams
    (K2), and the first chunk of the FLAC stream (K4, then K3)."""
    from audio_decoder_tpu_torch.codecs.flac import decoder as FD
    from audio_decoder_tpu_torch.codecs.flac import device as FV
    from audio_decoder_tpu_torch.codecs.flac.stream import FlacStream
    from audio_decoder_tpu_torch.codecs.mpeg import decoder as D
    from audio_decoder_tpu_torch.codecs.mpeg import dsp
    from audio_decoder_tpu_torch.codecs.mpeg import layer12 as L12

    st = D.Mp3Stream(open(paths["mp3"], "rb").read(), device=dev)
    lo, hi = st.gpc - st.WARMUP, 2 * st.gpc
    args = D.fused_wire_args(st.chunk_wire(lo, hi), st._rate_idx, dev)
    main, parts = _scan_inputs(args, None, st._buckets)
    (lanes, nb, nc), = parts
    k1 = [_k1_timed("Mp3Stream chunk", main, lanes, nb, nc)]

    c = dsp._consts(dev)
    TS = dsp.fused_subband_samples(*args, None, channels=st.channels,
                                   joint_stereo=st._joint,
                                   granules_per_frame=st._gpf,
                                   buckets=st._buckets)
    B, C, T, _ = TS.shape
    k2 = [_k2_timed("Mp3Stream chunk", TS.reshape(B * C, T, 32).contiguous(),
                    c)]
    for kind in ("layer1", "layer2"):
        ls = D.L12Stream(open(paths[kind], "rb").read(), device=dev)
        arrays = ls.chunk_arrays(0, min(ls.fpc + ls.WARMUP, ls.n_frames))
        TS = L12.l12_subband_samples(*(torch.as_tensor(a, device=dev)
                                       for a in arrays))
        B, C, T, _ = TS.shape
        k2.append(_k2_timed(f"L12Stream {kind} chunk",
                            TS.reshape(B * C, T, 32).contiguous(), c))
    fs = FlacStream(open(paths["flac"], "rb").read(), device=dev)
    wargs, statics = FD.pack_wire(fs._slices[:1], dev, fs._sizing)
    w = FV.flac_decode_wire(*wargs, stage="windows", **statics)
    k34 = {name: [_window_timed("FlacStream chunk", name, w[name][:-1],
                                w[name][-1])]
           for name in ("window_add2", "window_add")}
    return k1, k2, k34


def _snr_vs_tone(y: np.ndarray, freq: float, rate: int) -> float:
    """SNR of ``y`` against its best-fit sinusoid at ``freq`` (edges
    trimmed), in dB."""
    n = y.shape[0]
    t = np.arange(n) / rate
    lo, hi = n // 8, n - n // 8
    basis = np.stack([np.sin(2 * np.pi * freq * t),
                      np.cos(2 * np.pi * freq * t)], 1)[lo:hi]
    coef, *_ = np.linalg.lstsq(basis, y[lo:hi].astype(np.float64), rcond=None)
    resid = y[lo:hi] - basis @ coef
    return 10 * np.log10(float((basis @ coef).var())
                         / max(float(resid.var()), 1e-30))


#: the resample batch: (source rate, files), every file 10 s of stereo
RESAMPLE_ROWS = ((48000, 16), (32000, 16), (22050, 16), (44100, 17))
RESAMPLE_MAX_ABS = 2e-6


def _tone_batch(dev, seed: int):
    """The resample batch on ``dev``: each file a 1 kHz tone (amplitude
    0.5) plus noise 70 dB under it, zero-padded to the longest file."""
    from audio_decoder_tpu_torch.core.batch import AudioBatch

    rates = [r for r, n in RESAMPLE_ROWS for _ in range(n)]
    frames = [int(SECONDS * r) for r in rates]
    S = max(frames)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pcm = torch.zeros((len(rates), S, 2), dtype=torch.float32, device=dev)
    for i, (r, n) in enumerate(zip(rates, frames)):
        t = torch.arange(n, dtype=torch.float64, device=dev) / r
        tone = (0.5 * torch.sin(2 * np.pi * 1000.0 * t)).to(torch.float32)
        pcm[i, :n] = tone[:, None] + 1e-4 * torch.randn(
            (n, 2), generator=gen, device=dev)

    def meta(v):
        return torch.as_tensor(np.asarray(v, np.int32), device=dev)

    B = len(rates)
    return AudioBatch.from_pcm(
        pcm, sample_rate=meta(rates), num_channels=meta([2] * B),
        bits_per_sample=meta([16] * B), valid_frames=meta(frames),
        err=meta([0] * B), names=tuple(f"r{i:02d}" for i in range(B)),
        formats=("wav",) * B)


def _on_cpu(batch):
    import dataclasses

    return dataclasses.replace(batch, **{
        k: getattr(batch, k).cpu() for k in (
            "data", "sample_rate", "num_channels", "bits_per_sample",
            "valid_frames", "err")})


def phase_dsp(folder: str, dev, card: str, seed: int) -> None:
    """Consensus on the mixed folder's batch (its metadata reduced on the
    card and on the CPU); resample_to_consensus of the
    four-rate tone batch on the card against the CPU path (max abs 2e-6,
    amplitude-scaled RMS 5e-7), each tone's SNR above 60 dB, the rows
    already at the consensus rate bit for bit; per-ratio device ms, patch
    bytes and rate; route_channels mono→stereo and stereo→mono on the
    card against the CPU path (1e-6)."""
    import audio_decoder_tpu_torch as adt
    from audio_decoder_tpu_torch.dsp import resample as R

    batch, _ = adt.decode_dir(folder, device=dev)
    got = adt.consensus_for(batch, device=dev)
    want = adt.consensus_for(_on_cpu(batch), device="cpu")
    if got != want or got != (RATE, 2):
        fail(f"consensus_for on the card {got}, on the CPU {want}")
    log(f"consensus of the mixed folder: {got} on the card and the CPU")

    tb = _tone_batch(dev, seed)
    rate, ch = adt.consensus_for(tb, device=dev)
    if (rate, ch) != (44100, 2):
        fail(f"the tone batch's consensus is {(rate, ch)}, want (44100, 2)")
    t0 = time.perf_counter()
    adt.resample_to_consensus(tb, rate, device=dev)  # builds the weights
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = adt.resample_to_consensus(tb, rate, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    ref = adt.resample_to_consensus(_on_cpu(tb), rate, device="cpu")
    cpu_s = time.perf_counter() - t0
    for k in ("sample_rate", "valid_frames", "err", "num_channels"):
        if not torch.equal(getattr(out, k).cpu(), getattr(ref, k)):
            fail(f"resample_to_consensus: {k} differs between card and CPU")
    rates = tb.sample_rate.cpu().numpy()
    S, C = tb.max_frames, tb.channels
    total_audio = float(tb.audio_seconds())
    log(f"resample_to_consensus of {tb.batch_size} files ({total_audio:.1f} "
        f"audio-s) to {rate} Hz: wall {wall * 1e3:.3f} ms on the card "
        f"({total_audio / wall:.1f} audio-s/s; the first call, which builds "
        f"the weights, {cold * 1e3:.3f} ms), peak device memory {peak} B; "
        f"CPU path {cpu_s:.3f} s  [{card}]")
    for src, n in RESAMPLE_ROWS:
        rows = np.nonzero(rates == src)[0]
        a = out.data[rows].cpu().numpy()
        b = ref.data[rows].numpy()
        err = float(np.abs(a - b).max())
        ok, rms, bar = scaled_rms_ok(b, a)
        if err > RESAMPLE_MAX_ABS or not ok:
            fail(f"resample from {src} Hz: card vs CPU max abs {err:.3e}, "
                 f"rms {rms:.3e} (bar {bar:.3e})")
        if src == rate:
            if not torch.equal(out.data[rows, : S * C], tb.data[rows]):
                fail("rows already at the consensus rate were changed")
            log(f"resample: the {n} rows at {src} Hz are untouched, bit for "
                "bit")
            continue
        i = int(rows[0])
        snr = _snr_vs_tone(out.pcm[i, : int(out.valid_frames[i]), 0]
                           .cpu().numpy(), 1000.0, rate)
        if snr <= 60.0:
            fail(f"resample from {src} Hz: tone SNR {snr:.1f} dB <= 60")
        L, M = R._ratio(src, rate)
        x = tb.data[torch.as_tensor(rows, device=dev)]
        ms = cuda_ms(lambda: R._resample_LM_flat(x, L=L, M=M, C=C), 5)
        # the patches tensor [B, S//M, (M + taps)·C] f32 of the product
        patch = len(rows) * (S // M) * (M + R._TAPS) * C * 4
        log(f"resample {src} -> {rate} Hz (L/M {L}/{M}): {n} files, card vs "
            f"CPU max abs {err:.3e}, rms {rms:.3e} (bar {bar:.3e}); tone SNR "
            f"{snr:.1f} dB; device {ms:.3f} ms, patches {patch} B, "
            f"{n * SECONDS / (ms / 1e3):.1f} audio-s/s  [{card}]")

    x = out.pcm[:4]
    for c_in, c_out in ((1, 2), (2, 1)):
        src = x[..., :c_in].contiguous()
        got = adt.route_channels(src, c_out, device=dev)
        want = adt.route_channels(src.cpu(), c_out, device="cpu")
        err = float((got.cpu() - want).abs().max())
        if tuple(got.shape) != tuple(want.shape) or err > 1e-6:
            fail(f"route_channels {c_in}->{c_out}: card vs CPU max abs {err}")
        log(f"route_channels {c_in}->{c_out} on {tuple(src.shape)}: card vs "
            f"CPU max abs {err:.3e}")


# ---------------------------------------------------------------------------
# The engine: CLI render of an asset folder, and bench.py's render config
# ---------------------------------------------------------------------------

#: bench.py's render configuration: tracks, their seconds, chain depth,
#: frames per block (bench.py:641-661)
RENDER_TRACKS, RENDER_TRACK_S, RENDER_DEPTH, RENDER_FRAMES = 8, 2, 64, 4096
N_ENGINE_FLAC, N_ENGINE_L2 = 4, 2


def write_engine_folder(folder: str, mixed: str, layer2: bytes) -> list:
    """The engine's asset folder: the mixed folder's 16 WAV and 16 MP3 and
    the LSF MP3, 4 copies of the FLAC fixture, 2 Layer II files; returns
    the track names."""
    for name in sorted(os.listdir(mixed)):
        if name.endswith(".mp3") or (name.startswith("w") and name.endswith(".wav")):
            shutil.copyfile(os.path.join(mixed, name), os.path.join(folder, name))
    for i in range(N_ENGINE_FLAC):
        shutil.copyfile(MUSIC_FLAC, os.path.join(folder, f"f{i}.flac"))
    for i in range(N_ENGINE_L2):
        with open(os.path.join(folder, f"l2_{i}.mp2"), "wb") as f:
            f.write(layer2)
    return sorted(os.path.splitext(n)[0] for n in os.listdir(folder))


def engine_script(names: list, seed: int) -> str:
    """A seeded command script over the folder's tracks that uses every
    verb (load, start, velocity ±, group, tc, seq with chance and jitter,
    trem, env, pause/resume, stop, unload), with ``@<s>`` time steps."""
    rng = np.random.default_rng(seed + 5)
    wav = [n for n in names if n.startswith("w")]
    mp3 = [n for n in names if n.startswith("m")]
    lines = ["tc beat b:%d" % rng.integers(100, 160)]
    lines += [f"load {n}" for n in wav[:12] + mp3[:12]]
    lines += [f"load {n} -t s:{rng.integers(3000, 9000)}"
              for n in ("w12", "m12", "f0", "lsf", "l2_0")]
    lines += ["load f1 -t c:beat", "load f2", "load l2_1",
              "group bed -v " + ",".join(wav[:12] + mp3[:12]),
              "group kit -v f2,l2_1 -t m:%d" % rng.integers(150, 400)]
    for n in wav[:12] + mp3[:12]:
        lines.append(f"velocity {n} {rng.choice([-1, 1]) * rng.uniform(0.5, 1.6):.3f}")
    lines += [
        f"seq w12 -p 8 -s 0,2,3,5,7 -c a:{rng.uniform(0.5, 0.9):.2f},3:0.4 "
        f"-j a:{rng.uniform(0.1, 0.6):.2f}",
        f"seq kit -p 4 -s 0,1,3 -c a:{rng.uniform(0.4, 0.9):.2f} -j 1:0.5",
        "seq f1 -p 2 -s 0 -c a:0.9", "trem m12 -p 4 -d 0.6",
        "env f0 -p 2 -d 0.9", "trem bed -t s:20000 -p 3 -d 0.3",
        f"velocity lsf {-rng.uniform(0.5, 1.0):.3f}", "velocity l2_0 1.5",
        "start -t beat", "start -g bed", "start -v w12", "start -v m12",
        "start -v f0", "start -v f1", "@0.5", "start -g kit", "start -v lsf",
        "start -v l2_0", "@1.0", "velocity w12 -1.25", "pause -g bed",
        "@0.5", "resume -g bed", "stop -v f0", "pause -v m12", "@0.5",
        "resume -v m12", "unload lsf", "load lsf -t s:7000",
        "seq lsf -p 2 -s 0 -c a:0.9", "start -v lsf", "@1.0", "stop -g kit",
        "pause -t beat", "@0.5", "resume -t beat", "@0.5"]
    return "\n".join(lines) + "\n"


def _render_cli(folder: str, script: str, out: str, platform: str):
    """``cli render --resample`` of the script: (args, wall seconds).  The
    card is the CLI's default, so only the CPU run names a platform."""
    from audio_decoder_tpu_torch import cli

    argv = ["render", "--assets", folder, "--script", script, "--resample",
            "--out", out]
    args = cli.parse_args(([] if platform == "cuda" else
                           ["--platform", platform]) + argv)
    if args.platform != platform:
        fail(f"cli render runs on {args.platform}, not {platform}")
    t0 = time.perf_counter()
    if args.fn(args) != 0:
        fail(f"cli render --platform {platform} returned non-zero")
    return args, time.perf_counter() - t0


@contextlib.contextmanager
def _captured_kernel_inputs():
    """Inside the block every call of a K1-K4 wrapper first keeps a copy of
    its inputs: yields {kernel: [(args, kwargs), ...]}.  K1 and K2 are
    looked up in their modules at each call, K3 and K4 where the FLAC
    device program bound them, and K3 also in its own module, where K5
    (``window_add_spmd``) calls it once per shard; the wrappers are
    restored after."""
    from audio_decoder_tpu_torch.codecs.flac import device as FV
    from audio_decoder_tpu_torch.codecs.mpeg import huffman_kernel as HK
    from audio_decoder_tpu_torch.ops import synth_kernel as SK
    from audio_decoder_tpu_torch.ops import window_add as PW

    seen: dict = {}
    slots = [(HK, "entropy_scan", "mp3_entropy_scan"),
             (SK, "polyphase_synthesis_blocks", "mp3_polyphase_synthesis"),
             (FV, "window_add2", "window_add2"),
             (FV, "window_add", "window_add"),
             (PW, "window_add", "window_add")]
    saved = [getattr(mod, attr) for mod, attr, _ in slots]

    def keeping(fn, key):
        def call(*args, **kw):
            seen.setdefault(key, []).append(
                (tuple(a.clone() if torch.is_tensor(a) else a for a in args), kw))
            return fn(*args, **kw)
        return call

    for (mod, attr, key), fn in zip(slots, saved):
        setattr(mod, attr, keeping(fn, key))
    try:
        yield seen
    finally:
        for (mod, attr, _), fn in zip(slots, saved):
            setattr(mod, attr, fn)


def captured_kernels(seen: dict, where: str) -> dict:
    """K1-K4 against their twins on the very inputs a run gave them
    (``_captured_kernel_inputs``), each call timed beside its twin on its
    inputs' card: K1 per bucket exactly, K2 per group within atol 1e-4 /
    rtol 1e-5, K4 and K3 exactly.  Returns {kernel: [shape entries]}."""
    out: dict = {}

    def on_card(key, args, timed, *rest):
        with torch.cuda.device(args[0].device):
            out.setdefault(key, []).append(timed(*rest))

    for i, (args, kw) in enumerate(seen.get("mp3_entropy_scan", [])):
        on_card("mp3_entropy_scan", args, _k1_timed, f"{where}'s K1 call {i}",
                args[0], args[1:], kw["n_big"], kw["n_c1"])
    for i, (args, _kw) in enumerate(seen.get("mp3_polyphase_synthesis", [])):
        ts, n_mat, g2 = args
        on_card("mp3_polyphase_synthesis", args, _k2_timed,
                f"{where}'s K2 call {i}", ts, {"synth_n": n_mat, "g2": g2})
    for name in ("window_add2", "window_add"):
        for i, (args, _kw) in enumerate(seen.get(name, [])):
            on_card(name, args, _window_timed, f"{where}'s call {i}", name,
                    args[:-1], args[-1])
    return out


def phase_engine_cli(folder: str, work: str, names: list, card: str,
                     seed: int, main_launches: dict) -> tuple[dict, dict]:
    """``python -m audio_decoder_tpu_torch.cli render --resample`` over the
    engine folder on the card (K1-K4 run in its decode; their launches are
    counted alone and must be the folder's groups' exactly, and each call's
    inputs are kept and the kernels held against their twins on them), the
    written WAV against the captured int16 blocks, then the same script
    with ``--platform cpu``: the card within 1 LSB of the CPU.  The script
    and the WAVs go to ``work``.  Returns the kernels' launches and their
    shape entries."""
    import audio_decoder_tpu_torch as adt

    script = os.path.join(work, "script.txt")
    with open(script, "w") as f:
        f.write(engine_script(names, seed))
    _zero_kernel_counts()
    with _captured_kernel_inputs() as seen:
        args, wall = _render_cli(folder, script, os.path.join(work, "cuda.wav"),
                                 "cuda")
        torch.cuda.synchronize()
    launches = _kernel_counts()
    log(f"engine: cli render on the card launched {launches} in its decode "
        f"({wall:.3f} s wall for decode, resample and "
        f"{args.pcm.shape[0] / RATE:.3f} s of audio)  [{card}]")
    # the folder's MP3 files are the main path's own (the stereo group's
    # buckets and the LSF group), its 2 Layer II files one more K2 group,
    # its 4 FLAC copies one group for K4 and K3
    want = {"mp3_entropy_scan": main_launches["mp3_entropy_scan"],
            "mp3_polyphase_synthesis":
                main_launches["mp3_polyphase_synthesis"] + 1,
            "window_add2": 1, "window_add": 1, "window_add_spmd": 0}
    calls = {k: len(seen.get(k, [])) for k in want}
    if launches != want or calls != want:
        fail(f"the engine's decode launched {launches} in {calls} wrapper "
             f"calls, want {want}")
    shapes = captured_kernels(seen, "engine decode")
    del seen
    got = adt.decode_paths([args.out], device="cuda").file(0)
    want = args.pcm.astype(np.float32) / np.float32(32768.0)
    if got.err or got.pcm.shape != want.shape or not np.array_equal(got.pcm, want):
        fail("the written WAV differs from the captured int16 blocks")
    if np.abs(args.pcm).max() < 1000:
        fail("the engine render is (nearly) silent")
    cpu_args, cpu_wall = _render_cli(folder, script, os.path.join(work, "cpu.wav"),
                                     "cpu")
    if args.pcm.shape != cpu_args.pcm.shape:
        fail(f"engine render shapes differ: card {args.pcm.shape}, "
             f"CPU {cpu_args.pcm.shape}")
    d = np.abs(args.pcm.astype(np.int32) - cpu_args.pcm.astype(np.int32))
    log(f"engine: the WAV equals the captured blocks; card vs CPU render "
        f"max {int(d.max())} LSB, {float((d > 0).mean()):.3e} of the "
        f"{d.size} samples differ (CPU path {cpu_wall:.3f} s)")
    if d.max() > 1:
        fail(f"the card's render differs from the CPU's by {int(d.max())} LSB")
    return launches, shapes


def render_config(dev, seed: int = 11):
    """bench.py's render configuration on ``dev``: 8 stereo tracks of 2 s
    (random, from the seed), all 64 voices used and active at random
    positions, velocities 0.25-2 with every third voice reversed, gain
    1/64."""
    import dataclasses

    from audio_decoder_tpu_torch.engine import state as ES

    g = torch.Generator(device=dev).manual_seed(seed)
    S = RATE * RENDER_TRACK_S
    tracks = torch.randn((RENDER_TRACKS, S, 2), generator=g, device=dev) * 0.1
    st = ES.empty_state(tracks, [S] * RENDER_TRACKS, [2] * RENDER_TRACKS,
                        out_channels=2, device=dev)
    V = ES.MAX_VOICES
    pos = 1000.0 + (S - 2000.0) * torch.rand(V, generator=g, device=dev)
    sign = torch.where(torch.arange(V, device=dev) % 3 == 0, -1.0, 1.0)
    vel = sign * (0.25 + 1.75 * torch.rand(V, generator=g, device=dev))
    used = torch.ones(V, dtype=torch.bool, device=dev)
    st = dataclasses.replace(
        st, v_used=used, v_active=used,
        v_track=(torch.arange(V, device=dev) % RENDER_TRACKS).to(torch.int32),
        v_pos=pos, v_vel=vel, v_gain=torch.full((V,), 1.0 / 64, device=dev))
    return st, ES.HostRegistry([f"t{i}" for i in range(RENDER_TRACKS)])


#: commands over the render configuration for the loop's equality runs:
#: (line, blocks rendered after it)
ENGINE_LOOP_SCRIPT = [("load t0 -t s:3000", 0), ("seq t0 -p 4 -s 0,1,3 -c a:0.7 -j a:0.5", 0),
               ("start -v t0", 40), ("tc beat b:180", 0), ("load t1 -t c:beat", 0),
               ("trem t1 -p 2 -d 0.5", 0), ("start -t beat", 0), ("start -v t1", 70),
               ("velocity t1 -1.5", 33), ("group g -v t0,t1", 0), ("pause -g g", 25),
               ("resume -g g", 90), ("env t0 -p 2 -d 0.8", 64), ("stop -v t1", 50)]


def _loop_run(dev, depth: int, checkpoint: str | None = None):
    """The loop over the render configuration at ``SPEC_DEPTH`` ``depth``:
    the collected blocks (and a checkpoint halfway, if asked)."""
    from audio_decoder_tpu_torch.engine.checkpoint import save_state
    from audio_decoder_tpu_torch.runtime import loop as LM
    from audio_decoder_tpu_torch.runtime.native import Sink

    saved, LM.SPEC_DEPTH = LM.SPEC_DEPTH, depth
    try:
        st, reg = render_config(dev)
        loop = LM.EngineLoop(st, reg, RATE, 2,
                             sink=Sink("default", RATE, 2, realtime=False))
        out = []
        for i, (line, n) in enumerate(ENGINE_LOOP_SCRIPT):
            if not loop.submit(line):
                fail(f"loop command {line!r} rejected: {loop.errors}")
            out.append(loop.run_blocks(n, collect=True))
            if checkpoint and i == len(ENGINE_LOOP_SCRIPT) // 2:
                save_state(checkpoint, loop.state, loop.reg)
                ck_at = sum(len(o) for o in out)
        if loop.errors:
            fail(f"loop errors: {loop.errors}")
        audio = np.concatenate(out)
        return (audio, ck_at) if checkpoint else audio
    finally:
        LM.SPEC_DEPTH = saved


def _launches_per_call(fn, reps: int) -> tuple[float, float, float]:
    """Per call of ``fn``, from torch.profiler: the device operations
    (every kernel, memcpy and memset on the card), the host's kernel
    launch calls, and the device milliseconds."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops, api, us = 0, 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops += 1
            us += dev_us(e)
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"):
            api += 1
    return ops / reps, api / reps, us / reps / 1e3


def phase_engine_render(dev, card: str, work: str) -> dict:
    """bench.py's render configuration on the card: render_chain equal to
    sequential render_block, the loop at SPEC_DEPTH 8 equal to 0, a
    checkpoint's sample-exact continuation; render and live-loop × real
    time, launches per block, peak device memory, the sink's kind."""
    from audio_decoder_tpu_torch.engine import render as ER
    from audio_decoder_tpu_torch.engine.checkpoint import load_state
    from audio_decoder_tpu_torch.runtime import loop as LM
    from audio_decoder_tpu_torch.runtime.native import Sink

    st, _ = render_config(dev)
    F, D = RENDER_FRAMES, RENDER_DEPTH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    blks, acts, poss, clocks = ER.render_chain(st, frames=F, out_channels=2, depth=D)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    cur = st
    for i in range(D):
        blk, cur = ER.render_block(cur, frames=F, out_channels=2)
        if not (torch.equal(blk, blks[i]) and torch.equal(cur.v_active, acts[i])
                and torch.equal(cur.v_pos, poss[i]) and torch.equal(cur.clock, clocks[i])):
            fail(f"render_chain differs from sequential render_block at block {i}")
    if not torch.isfinite(blks).all() or float(blks.abs().max()) == 0.0:
        fail("the render configuration rendered non-finite or silent blocks")
    log(f"engine: render_chain ({D} x {F} frames, 64 voices) equals {D} "
        f"sequential render_block calls bit for bit")

    def chain_once() -> float:
        t0 = time.perf_counter()
        b = ER.render_chain(st, frames=F, out_channels=2, depth=D)[0]
        float(b[-1, -1, 0])  # one fetch per chain
        return D * F / RATE / (time.perf_counter() - t0)

    chain_once()
    rates = [chain_once() for _ in range(5)]
    render_x = max(rates)
    n_block, api_block, ms_block = _launches_per_call(
        lambda: ER.render_block(st, frames=F, out_channels=2), 3)
    n_period, api_period, ms_period = _launches_per_call(
        lambda: ER.render_block(st, frames=LM.PERIOD, out_channels=2), 3)

    base_audio = _loop_run(dev, 0)
    ck = os.path.join(work, "engine_ckpt")
    spec_audio, ck_at = _loop_run(dev, 8, checkpoint=ck)
    if not np.array_equal(spec_audio, base_audio):
        fail("EngineLoop at SPEC_DEPTH 8 differs from SPEC_DEPTH 0 on the card")
    st2, reg2 = load_state(ck, device=dev)
    loop2 = LM.EngineLoop(st2, reg2, RATE, 2, sink=Sink("default", RATE, 2,
                                                         realtime=False))
    rest = []
    for line, n in ENGINE_LOOP_SCRIPT[len(ENGINE_LOOP_SCRIPT) // 2 + 1:]:
        if not loop2.submit(line):
            fail(f"resumed loop: command {line!r} rejected: {loop2.errors}")
        rest.append(loop2.run_blocks(n, collect=True))
    if loop2.errors:
        fail(f"resumed loop errors: {loop2.errors}")
    if not np.array_equal(np.concatenate(rest), base_audio[ck_at:]):
        fail("the loop resumed from a checkpoint does not continue sample-exact")
    log(f"engine: EngineLoop at SPEC_DEPTH 8 equals SPEC_DEPTH 0 bit for bit "
        f"over {base_audio.shape[0]} frames; the checkpoint at frame {ck_at} "
        f"continues sample-exact")

    st, reg = render_config(dev)
    loop = LM.EngineLoop(st, reg, RATE, 2, sink=Sink("default", RATE, 2,
                                                      realtime=False))
    loop.run_blocks(64)
    n_live = 2048
    t0 = time.perf_counter()
    loop.run_blocks(n_live)
    loop_x = n_live * LM.PERIOD / RATE / (time.perf_counter() - t0)
    sink = Sink("default", RATE, 2)
    kind = sink.mode
    sink.close()
    out = dict(render_x=render_x, render_x_runs=rates, loop_x=loop_x,
               ops_per_block=n_block, launch_calls_per_block=api_block,
               device_ms_per_block=ms_block, ops_per_period=n_period,
               launch_calls_per_period=api_period,
               device_ms_per_period=ms_period, peak_bytes=peak, sink=kind)
    log(f"engine: render {render_x:.3f}x real time (best of 5 chains of {D} x "
        f"{F} frames, 64 voices; runs {[round(r, 3) for r in rates]}); live "
        f"loop {loop_x:.3f}x real time at PERIOD {LM.PERIOD} (SPEC_DEPTH "
        f"{LM.SPEC_DEPTH}, {n_live} blocks); per block at {F} frames "
        f"{n_block:.1f} device operations, {api_block:.1f} kernel launch "
        f"calls, {ms_block:.3f} device ms; at {LM.PERIOD} frames "
        f"{n_period:.1f}, {api_period:.1f}, {ms_period:.3f} ms; peak device "
        f"memory of a chain {peak} B; sink {kind}  [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the multi-device path (parallel/: mesh, sharded decode, the
# voice-sharded render, K5)
# ---------------------------------------------------------------------------

#: the logical mesh: 8 shards on one card, data 4 x model 2 (the JAX
#: package's virtual test mesh)
MESH_N, MESH_MODEL = 8, 2
MESH_WAV_EXTRA = 1  # the main path's 16 WAV plus one: an uneven batch
MESH_FLAC_SHORT = 8  # short seeded FLAC files beside the 16 music copies


def mesh_inputs(folder: str, layer2: bytes, seed: int) -> dict:
    """The phase's host inputs, every file distinct: the main path's 16 WAV
    plus one more; the stereo MP3 fixture cut at 16 distinct frame
    boundaries (a frame-aligned prefix is a valid stream); the ``layer2``
    stream (the families phase's) cut at 8 distinct frame counts (Layer II frames
    stand alone, so a prefix's analysis is the analysis's prefix); 16
    copies of the FLAC music fixture and 8 short seeded stereo files
    (tests/flac_writer)."""
    import dataclasses

    from audio_decoder_tpu_torch.codecs.flac import frontend
    from audio_decoder_tpu_torch.codecs.mpeg import frontend as MF
    from audio_decoder_tpu_torch.codecs.mpeg import layer12 as L12
    from audio_decoder_tpu_torch.io.assets import pack_bytes
    from tests import flac_writer

    rng = np.random.default_rng(seed + 13)
    wavs = [open(os.path.join(folder, f"w{i:02d}.wav"), "rb").read()
            for i in range(N_WAV)]
    extra = rng.integers(-32768, 32768, (int(SECONDS * RATE) // 3, 2)).astype(np.int16)
    wav_bufs, wav_lens = pack_bytes(wavs + [wav_blob(extra, RATE)])
    mp3 = open(STEREO_MP3, "rb").read()
    frames = MF.find_frames(mp3)
    mp3s = [mp3[:frames[len(frames) - 1 - 5 * i][0]] for i in range(N_MP3)]
    l2 = L12.analyze_l2(layer2)
    l2s = [dataclasses.replace(l2, n_frames=n, codes=l2.codes[:n],
                               cls=l2.cls[:n], sf_idx=l2.sf_idx[:n])
           for n in (l2.n_frames - 9 * i for i in range(N_L12))]
    music = open(MUSIC_FLAC, "rb").read()
    short = [flac_writer.encode_file(
        np.clip(rng.standard_normal((RATE // 2 + 997 * i, 2)) * 4000,
                -32768, 32767).astype(np.int64), RATE, 16, blocksize=4096)
        for i in range(MESH_FLAC_SHORT)]
    flacs = [frontend.analyze(b) for b in [music] * N_FLAC + short]
    return dict(wav=(wav_bufs, wav_lens), mp3=mp3s, layer2=l2s, flac=flacs,
                wav_frames=int(SECONDS * RATE))


def _mesh_refs(inp: dict, dev) -> dict:
    """The single-card results the sharded ones are held against, with the
    single-card wall of each decode."""
    from audio_decoder_tpu_torch import parallel as P
    from audio_decoder_tpu_torch.codecs.flac import decoder as FD
    from audio_decoder_tpu_torch.codecs.flac import device as FV
    from audio_decoder_tpu_torch.codecs.mpeg import decoder as D
    from audio_decoder_tpu_torch.codecs.mpeg import dsp
    from audio_decoder_tpu_torch.codecs.mpeg import layer12 as L12
    from audio_decoder_tpu_torch.parallel.dryrun import pack_mp3_group

    def on(args):
        return [torch.as_tensor(a).to(dev) for a in args]

    bufs, lens = inp["wav"]
    mp3_args, mp3_kw = pack_mp3_group(inp["mp3"])
    l2 = inp["layer2"][0]
    l2_kw = dict(channels=l2.channels, steps=l2.steps_per_frame)
    l2_args = D.pack_layer12(inp["layer2"], "cpu")
    sizing = P.round_sizing(FD.sizing_for(inp["flac"]), MESH_N // MESH_MODEL)
    flac_args, flac_kw = FD.pack_group(inp["flac"], "cpu", sizing)
    wav_kw = dict(bits=16, channels=2, max_frames=inp["wav_frames"])
    calls = {
        "wav": lambda: P.decode_pcm_step(*on((bufs, lens)), **wav_kw),
        "mp3": lambda: dsp.mp3_decode_fused(*on(mp3_args), None, **mp3_kw),
        "layer2": lambda: L12.l12_synthesize(*on(l2_args), **l2_kw),
        "flac": lambda: FV.flac_decode_batch(*on(flac_args), **flac_kw),
    }
    refs, walls = {}, {}
    for k, fn in calls.items():
        fn()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs[k] = fn()
        torch.cuda.synchronize()
        walls[k] = time.perf_counter() - t0
    return dict(refs=refs, walls=walls, wav_kw=wav_kw, mp3=(mp3_args, mp3_kw),
                layer2=(l2_args, l2_kw), flac=(flac_args, flac_kw))


def _counted_run(fn):
    """``fn()`` with every launch count set to 0 just before it and read
    just after, each K1-K4 call's inputs kept (``_captured_kernel_inputs``);
    then ``fn()`` once more, timed alone: (the first run's result,
    {kernel: launches}, {kernel: [(args, kwargs)]}, the second's wall
    seconds)."""
    _zero_kernel_counts()
    with _captured_kernel_inputs() as seen:
        out = fn()
        torch.cuda.synchronize()
    counts = _kernel_counts()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return out, counts, seen, time.perf_counter() - t0


def _close_or_equal(label: str, ref: torch.Tensor, got: torch.Tensor) -> str:
    """Exact, or else within amplitude-scaled RMS 5e-7 per file (its max
    abs difference printed); fails otherwise."""
    if got.shape != ref.shape:
        fail(f"mesh {label}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if torch.equal(got, ref):
        return "exact"
    r, g = ref.cpu().numpy(), got.cpu().numpy()
    worst = 0.0
    for i in range(r.shape[0]):
        ok, rms, bar = scaled_rms_ok(r[i], g[i])
        if not ok:
            fail(f"mesh {label}: file {i} RMS {rms:.3e} over {bar:.3e}")
        worst = max(worst, rms)
    return (f"within RMS 5e-7 (worst {worst:.3e}, max abs "
            f"{float(np.abs(r - g).max()):.3e})")


def _mesh_decodes(mesh, inp: dict, ref: dict, card: str,
                  label: str) -> tuple[dict, dict]:
    """Every sharded decode on ``mesh``, each counted alone and held against
    the single-card result, and every K1, K2 and K3 call of the MP3, Layer
    II and FLAC runs held against its twin on that call's inputs
    (``captured_kernels``); returns ({path: {kernel: launches}}, {kernel:
    [shape entries]})."""
    from audio_decoder_tpu_torch import parallel as P
    from audio_decoder_tpu_torch.codecs.flac import frontend

    D = mesh.shape["data"]
    dev0 = ref["refs"]["wav"][0].device
    launches = {}
    # WAV: 17 files padded to a multiple of the data size, consensus
    bufs, lens = inp["wav"]
    n_wav = bufs.shape[0]
    bufs_p, lens_p, valid = P.pad_batch(bufs, lens, D)
    step = P.sharded_decode_fn(mesh, **ref["wav_kw"])
    (pcm, meta, rate, ch), counts, _, wall = _counted_run(
        lambda: step(bufs_p, lens_p))
    one, one_meta = ref["refs"]["wav"]
    if not torch.equal(pcm.gather(dev0)[:n_wav], one):
        fail(f"mesh {label} WAV PCM differs from the single-card decode")
    err = meta["err"].gather("cpu").numpy()
    if (err[:n_wav] != one_meta["err"].cpu().numpy()).any() or not (
            err[~valid] != 0).all() or (err[valid] != 0).any():
        fail(f"mesh {label} WAV error codes {err}")
    if (int(rate.value), int(ch.value)) != (RATE, 2):
        fail(f"mesh {label} WAV consensus {int(rate.value)} x {int(ch.value)}")
    wavs = [inp["wav_src"][i] for i in range(N_WAV)]
    got16 = pcm.gather("cpu")[:N_WAV].reshape(N_WAV, -1, 2).numpy()
    if not np.array_equal(got16, np.stack(wavs) / np.float32(32768.0)):
        fail(f"mesh {label} WAV PCM differs from its source")
    launches["wav"] = counts
    log(f"mesh {label} WAV: {n_wav} files padded to {bufs_p.shape[0]}, "
        f"{D} data shards; equal to the single-card decode, padding rows "
        f"masked, consensus {int(rate.value)} Hz x {int(ch.value)}; wall "
        f"{wall * 1e3:.3f} ms (single card {ref['walls']['wav'] * 1e3:.3f} ms)"
        f"  [{card}]")

    seen_all: dict = {}
    for path, make in (
            ("mp3", lambda a, kw: P.sharded_mp3_decode_fn(mesh, **kw)(*a)),
            ("layer2", lambda a, kw: P.sharded_l12_fn(mesh, **kw)(*a))):
        args, kw = ref[path]
        out, counts, seen, wall = _counted_run(lambda: make(args, kw))
        for k, calls in seen.items():
            seen_all.setdefault(k, []).extend(calls)
        how = _close_or_equal(f"{label} {path}", ref["refs"][path],
                              out.gather(dev0))
        launches[path] = counts
        log(f"mesh {label} {path}: {args[0].shape[0]} files over {D} data "
            f"shards, {how} against the single-card decode; launches "
            f"{ {k: n for k, n in counts.items() if n} }; wall "
            f"{wall * 1e3:.3f} ms (single card "
            f"{ref['walls'][path] * 1e3:.3f} ms)  [{card}]")

    args, kw = ref["flac"]
    (pcm, ovf), counts, seen, wall = _counted_run(
        lambda: P.sharded_flac_fn(mesh, **kw)(*args))
    seen_all.update(seen)
    one, one_ovf = ref["refs"]["flac"]
    if not torch.equal(pcm.gather(dev0), one) or not torch.equal(
            ovf.gather(dev0), one_ovf) or bool(one_ovf.any()):
        fail(f"mesh {label} FLAC differs from the single-card decode")
    got = pcm.gather("cpu").numpy()
    an = inp["flac"][0]
    for i in range(N_FLAC):
        view = types.SimpleNamespace(
            pcm=got[i, :an.total * 2].reshape(an.total, 2), bits_per_sample=16)
        if not _md5_ok(MUSIC_FLAC, view):
            fail(f"mesh {label} FLAC file {i} fails its STREAMINFO MD5")
    for i, a in enumerate(inp["flac"][N_FLAC:], N_FLAC):
        ints = np.round(got[i, :a.total * 2].astype(np.float64) * 32768)
        if frontend.verify_md5(a, ints.astype(np.int64).reshape(a.total, 2)) is not True:
            fail(f"mesh {label} FLAC short file {i} fails its MD5")
    want = {"window_add": 3 * D, "window_add2": 0, "window_add_spmd": 3}
    if {k: counts[k] for k in want} != want:
        fail(f"mesh {label} FLAC launched {counts}, want {want}")
    launches["flac"] = counts
    log(f"mesh {label} FLAC: {len(inp['flac'])} files over {D} data shards, "
        f"equal to the single-card decode bit for bit, MD5 of all "
        f"{len(inp['flac'])}; launches {counts}; wall {wall * 1e3:.3f} ms "
        f"(single card {ref['walls']['flac'] * 1e3:.3f} ms)  [{card}]")
    for path, k1 in (("mp3", 1), ("layer2", 0)):
        want = {"mp3_entropy_scan": k1 * D, "mp3_polyphase_synthesis": D}
        if {k: launches[path][k] for k in want} != want:
            fail(f"mesh {label} {path} launched {launches[path]}, want {want}")
    calls = {k: len(v) for k, v in seen_all.items()}
    want = {"mp3_entropy_scan": D, "mp3_polyphase_synthesis": 2 * D,
            "window_add": 3 * D}
    if calls != want:
        fail(f"mesh {label}: the kernels' wrappers were called {calls} "
             f"times, want {want}")
    shapes = captured_kernels(seen_all, f"mesh {label}")
    log(f"mesh {label}: every K1, K2 and K3 call of the sharded MP3, Layer "
        f"II and FLAC runs ({calls}) held against its twin on its inputs")
    return launches, shapes


def _mesh_render(mesh, dev, card: str, label: str) -> None:
    """bench.py's render configuration over ``model``: a chain of 64
    blocks twice (bit-identical), each block within 2e-6 of the
    single-card render, positions, active flags and the clock equal."""
    from audio_decoder_tpu_torch import parallel as P
    from audio_decoder_tpu_torch.engine import render as ER

    st, _ = render_config(dev)
    step = P.sharded_render_fn(mesh, frames=RENDER_FRAMES, out_channels=2)

    def chain():
        sst, out = P.shard_engine_state(st, mesh), []
        for _ in range(RENDER_DEPTH):
            blk, sst = step(sst)
            out.append(blk.value.to(dev))
        torch.cuda.synchronize()
        return torch.stack(out), sst.gather(dev)

    chain()  # warm
    t0 = time.perf_counter()
    a, end_a = chain()
    wall = time.perf_counter() - t0
    b, _ = chain()
    if not torch.equal(a, b):
        fail(f"mesh {label} render: two sharded chains differ")
    ref, cur = [], st
    t0 = time.perf_counter()
    for _ in range(RENDER_DEPTH):
        blk, cur = ER.render_block(cur, frames=RENDER_FRAMES, out_channels=2)
        ref.append(blk)
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    err = float((a - torch.stack(ref)).abs().max())
    if err > 2e-6:
        fail(f"mesh {label} render: max abs {err:.3e} from the single card")
    for k in ("v_pos", "v_active", "clock"):
        if not torch.equal(getattr(end_a, k), getattr(cur, k)):
            fail(f"mesh {label} render: {k} differs from the single card")
    log(f"mesh {label} render: {RENDER_DEPTH} blocks x {RENDER_FRAMES} frames, "
        f"64 voices over {mesh.shape['model']} model shards; two chains "
        f"bit-identical; max abs {err:.3e} from the single card (bar 2e-6), "
        f"positions, active flags and clock equal; chain wall "
        f"{wall * 1e3:.3f} ms (single card {one_wall * 1e3:.3f} ms)  [{card}]")


def _k5_timed(dev, mesh, card: str) -> dict:
    """K5 at the 16-file FLAC group's PCM windows over the mesh's data
    shards, exact against the plain twin, timed beside it, its bound (the
    function's bytes, as K3's) and one ``index_add_``; also K3 on the whole
    group and the two halves of K5 (K3 per shard, the psum)."""
    from audio_decoder_tpu_torch import parallel as P
    from audio_decoder_tpu_torch.ops import window_add as PW

    starts, upd, n_out = _flac_windows(dev)["window_add"]
    S, U = P.shard(starts, mesh), P.shard(upd, mesh)
    got = PW.window_add_spmd(S, U, n_out, mesh=mesh).value
    ref = PW.window_add_plain(starts, upd, n_out)
    lib = _index_add_call([(starts, upd)], n_out)
    torch.cuda.synchronize()
    if not torch.equal(got, ref) or not torch.equal(lib()[:n_out], ref):
        fail("K5 window_add_spmd differs from its plain twin at the FLAC group")
    ms = cuda_ms(lambda: PW.window_add_spmd(S, U, n_out, mesh=mesh), 20)
    plain_ms = cuda_ms(lambda: PW.window_add_plain(starts, upd, n_out), 10)
    library_ms = cuda_ms(lib, 20)
    k3_ms = cuda_ms(lambda: PW.window_add(starts, upd, n_out), 20)
    shards_ms = cuda_ms(lambda: [PW.window_add(s, u, n_out)
                                 for s, u in zip(S.shards, U.shards)], 20)
    parts = [PW.window_add(s, u, n_out) for s, u in zip(S.shards, U.shards)]
    psum_ms = cuda_ms(lambda: P.psum(parts, mesh), 20)
    b_ms, by = bound(nbytes(starts, upd) + n_out * got.element_size())
    log(f"K5 window_add_spmd at the 16-file FLAC group (starts "
        f"{tuple(starts.shape)} upd {tuple(upd.shape)}, n_out {n_out}) over "
        f"{mesh.shape['data']} data shards of one card: exact; kernel "
        f"{ms:.4f} ms per call (K3 per shard {shards_ms:.4f}, psum "
        f"{psum_ms:.4f}), plain {plain_ms:.4f} ms, index_add_ "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({by}); K3 on the whole "
        f"group {k3_ms:.4f} ms  [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=by, max_abs_err=0.0, k3_per_shard_ms=shards_ms,
                psum_ms=psum_ms, k3_whole_ms=k3_ms)


def phase_multichip(folder: str, wavs: dict, layer2: bytes, dev, card: str,
                    seed: int) -> tuple[dict, dict, dict]:
    """The multi-device path on a logical mesh of 8 shards over one card
    (data 4 x model 2), then over the real cards where more than one is
    visible.  Returns ({path: {kernel: launches}} and {kernel: [shape
    entries]} of the logical mesh, K5's numbers)."""
    from audio_decoder_tpu_torch import parallel as P
    from audio_decoder_tpu_torch.parallel import mesh as M

    t0 = time.perf_counter()
    inp = mesh_inputs(folder, layer2, seed)
    inp["wav_src"] = [wavs[f"w{i:02d}"] for i in range(N_WAV)]
    ref = _mesh_refs(inp, dev)
    log(f"mesh inputs and single-card references: "
        f"{time.perf_counter() - t0:.3f} s")
    mesh = P.make_mesh(MESH_N, MESH_MODEL, devices=[dev] * MESH_N)
    nccl0 = M.collectives["psum_nccl"]
    launches, shapes = _mesh_decodes(mesh, inp, ref, card, "logical 4x2")
    _mesh_render(mesh, dev, card, "logical 4x2")
    k5 = _k5_timed(dev, mesh, card)
    if M.collectives["psum_nccl"] != nccl0:
        fail("a psum on one card went through NCCL")
    n = torch.cuda.device_count()
    if n >= 2:
        model = 2 if n % 2 == 0 and n >= 4 else 1
        cards = P.make_mesh(n, model)
        _mesh_decodes(cards, inp, ref, card, f"{n} cards")
        _mesh_render(cards, dev, card, f"{n} cards")
        ran = M.collectives["psum_nccl"] - nccl0
        log(f"mesh: the cross-card NCCL reduce ran {ran} times over {n} cards")
        if ran == 0:
            fail("no psum crossed the cards")
    else:
        log("mesh: one card visible, so the cross-card NCCL reduce did not "
            "run (every psum added its partials on the card)")
    log(f"multichip phase {time.perf_counter() - t0:.3f} s")
    return launches, shapes, k5


def multichip_only(seed: int) -> None:
    """``--phase multichip``: the build, the main path's 16 WAV files and a
    seeded 10 s Layer II stream, then ``phase_multichip`` alone (about a
    minute; on a machine with several cards, the quick check of the
    cross-card path)."""
    from tests import seeded_writers as SW

    card = phase_environment()
    phase_build()
    rng = np.random.default_rng(seed + 2)
    layer2 = SW.layer2_frames(rng, -(-int(SECONDS * RATE) // 1152), 2,
                              sr=RATE, kbps=192)
    with tempfile.TemporaryDirectory(prefix="adt_smoke_mesh_") as folder:
        wavs = write_folder(folder, seed)
        phase_multichip(folder, wavs, layer2, torch.device("cuda"), card, seed)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--profile", action="store_true",
                    help="profile one FLAC decode after the other phases")
    ap.add_argument("--phase", choices=("all", "multichip"), default="all",
                    help="multichip: the build and the multi-device phase "
                    "alone")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)  # the numpy writers of tests/
    if args.phase == "multichip":
        multichip_only(args.seed)
        return

    card = phase_environment()
    phase_build()
    dev = torch.device("cuda")
    kernels = phase_kernels(dev) + phase_flac_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="adt_smoke_") as folder, \
            tempfile.TemporaryDirectory(prefix="adt_smoke_flac_") as flac_folder, \
            tempfile.TemporaryDirectory(prefix="adt_smoke_fam_") as fam_folder, \
            tempfile.TemporaryDirectory(prefix="adt_smoke_stream_") as st_folder:
        wavs = write_folder(folder, args.seed)
        launches, _ = phase_main_path(folder, wavs, dev)
        good = write_flac_folder(flac_folder, args.seed)
        launches.update(phase_flac_path(flac_folder, good, dev))
        phase_flac_chunked(dev)
        phase_rate(folder, flac_folder, card)
        src = write_families_folder(fam_folder, args.seed)
        k2_families = phase_families(fam_folder, src, dev)
        k2_shapes = phase_families_k2(dev, src)
        phase_families_rate(fam_folder, card, dev)
        t0 = time.perf_counter()
        stream_paths = write_stream_files(st_folder, args.seed)
        stream_launches = phase_streams(stream_paths, dev, card)
        k1_streams, k2_streams, k34_streams = phase_stream_kernels(
            stream_paths, dev)
        t1 = time.perf_counter()
        phase_dsp(folder, dev, card, args.seed)
        t2 = time.perf_counter()
        log(f"streams phases {t1 - t0:.3f} s, DSP phase {t2 - t1:.3f} s")
        with tempfile.TemporaryDirectory(prefix="adt_smoke_engine_") as eng, \
                tempfile.TemporaryDirectory(prefix="adt_smoke_work_") as work:
            names = write_engine_folder(eng, folder, src["layer2"][0])
            engine_launches, engine_shapes = phase_engine_cli(
                eng, work, names, card, args.seed, launches)
            phase_engine_render(dev, card, work)
        log(f"engine phases {time.perf_counter() - t2:.3f} s")
        mesh_launches, mesh_shapes, k5 = phase_multichip(
            folder, wavs, src["layer2"][0], dev, card, args.seed)
        if args.profile:
            phase_profile(flac_folder, card)
            phase_families_profile(fam_folder, card, dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        # the streams: each kernel's launches over the stream_file runs
        # that launch it (each run counted on its own), and the kernel at
        # the streams' chunk shapes
        per = stream_launches[k["name"]]
        k["streams"] = dict(launches=sum(per.values()), per_stream=per,
                            shapes={"mp3_entropy_scan": k1_streams,
                                    "mp3_polyphase_synthesis": k2_streams,
                                    **k34_streams}[k["name"]])
        # the engine path: the launches of cli render's decode of the
        # engine folder, counted alone, and the kernel on each call's
        # inputs there
        k["engine"] = dict(launches=engine_launches[k["name"]],
                           shapes=engine_shapes[k["name"]])
        if k["name"] == "mp3_polyphase_synthesis":
            # the Layer I/II path: its launches per decode_dir of the
            # families folder, and K2 at its shapes
            k["layer12"] = dict(launches=k2_families, shapes=k2_shapes)
        # the multi-device path: each sharded run's launches on the logical
        # mesh, counted alone, and the kernel on each of its calls' inputs
        k["multichip"] = dict(
            launches={path: n[k["name"]] for path, n in mesh_launches.items()
                      if n[k["name"]]},
            shapes=mesh_shapes.get(k["name"], []))
    kernels.append(dict(
        name="window_add_spmd", route="cuda",
        source="audio_decoder_tpu_torch/csrc/window_add.cu",
        replaces="audio_decoder_tpu/ops/window_add.py:184",
        launches=mesh_launches["flac"]["window_add_spmd"],
        k3_launches=mesh_launches["flac"]["window_add"], **k5))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Write the MP3 and FLAC fixtures the PyTorch port's chip smoke run and
tests use.

The machine with the GPU has no libmp3lame and no FLAC encoder, so the clips
are encoded once (MP3 with the system's libmp3lame, FLAC with the JAX
package's ``encode_flac``) and committed under tests/data/torch_port/:

* ``stereo_44k1_128k_js.mp3``: 10 s of 44.1 kHz stereo noise at 128 kbps
  joint stereo, the MP3 half of bench.py's mixed workload (same signal
  recipe and LAME settings as bench.py's ``_mp3_blob``);
* ``mono_22k05_lsf.mp3``: 3 s of 22.05 kHz mono (MPEG-2 LSF, one granule
  per frame), which also exercises the channel-expanding batch concat;
* ``music_44k1_s16.flac``: 10 s of 44.1 kHz stereo 16-bit, bench.py's
  decaying-chord FLAC signal (``bench.py:597-603``) encoded with
  ``encode_flac(..., bits=16)``, the FLAC workload of bench.py;
* ``mono_48k_s24.flac``: 3 s of 48 kHz mono 24-bit, loud enough that some
  rice parameters exceed 16, so the port's ``sizing_for`` picks the wide
  rice-scan variant (asserted here).

Usage:  python tools/make_torch_fixtures.py [--out tests/data/torch_port]
                                            [--only mp3|flac]
"""

from __future__ import annotations

import argparse
import ctypes as C
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT_DIR = os.path.join(REPO, "tests", "data", "torch_port")


def lame_encode(pcm: np.ndarray, rate: int, kbps: int, mode: int) -> bytes:
    """int16 [frames, channels] → MP3 bytes (mode 1 joint stereo, 3 mono)."""
    L = C.CDLL("libmp3lame.so.0")
    L.lame_init.restype = C.c_void_p
    gfp = C.c_void_p(L.lame_init())
    n, ch = pcm.shape
    L.lame_set_num_channels(gfp, ch)
    L.lame_set_in_samplerate(gfp, rate)
    L.lame_set_out_samplerate(gfp, rate)
    L.lame_set_brate(gfp, kbps)
    L.lame_set_mode(gfp, mode)
    L.lame_set_bWriteVbrTag(gfp, 0)
    if L.lame_init_params(gfp) < 0:
        raise RuntimeError("lame_init_params failed")
    pcm = np.ascontiguousarray(pcm, np.int16)
    out = np.zeros(n * 5 // 4 + 7200 * 4, np.uint8)
    outp = out.ctypes.data_as(C.POINTER(C.c_ubyte))
    if ch == 2:
        w = L.lame_encode_buffer_interleaved(
            gfp, pcm.ctypes.data_as(C.POINTER(C.c_short)), n, outp, len(out))
    else:
        mono = pcm[:, 0].copy()
        w = L.lame_encode_buffer(
            gfp, mono.ctypes.data_as(C.POINTER(C.c_short)),
            mono.ctypes.data_as(C.POINTER(C.c_short)), n, outp, len(out))
    if w < 0:
        raise RuntimeError(f"lame_encode failed: {w}")
    w2 = L.lame_encode_flush(
        gfp, out[w:].ctypes.data_as(C.POINTER(C.c_ubyte)), len(out) - w)
    L.lame_close(gfp)
    return bytes(out[: w + w2])


def stereo_noise(rng, seconds: float, rate: int) -> np.ndarray:
    """bench.py's MP3 signal: noise plus a delayed, scaled copy."""
    s = 0.3 * rng.standard_normal(int(seconds * rate))
    x = np.stack([s, np.roll(s, 17) * 0.8], 1)
    return np.clip(x * 30000, -32768, 32767).astype(np.int16)


def chord(rng, seconds: float, rate: int, amp: float) -> np.ndarray:
    """bench.py's FLAC signal: three decaying partials plus faint noise,
    as float PCM in [-1, 1) (one channel)."""
    frames = int(seconds * rate)
    t = np.arange(frames) / rate
    m = np.zeros(frames)
    for f0, a in ((110.0, 0.35), (220.5, 0.2), (331.1, 0.12)):
        m += a * np.sin(2 * np.pi * f0 * t) * np.exp(-0.2 * t)
    m += 0.002 * rng.standard_normal(frames)
    return m * amp


def flac_clips(seed: int) -> dict:
    from audio_decoder_tpu.codecs.flac.encode import encode_flac
    from audio_decoder_tpu_torch.codecs.flac import decoder, frontend

    rng = np.random.default_rng(seed)
    m = chord(rng, 10.0, 44100, 20000)
    music = np.clip(np.stack([m, 0.8 * m], 1), -32768, 32767
                    ).astype(np.float32) / 2.0 ** 15
    # 24-bit mono: the chord near full scale plus noise at about -42 dBFS,
    # whose residuals need rice parameters above 16 (the wide scan)
    w = chord(rng, 3.0, 48000, 1.0)[:, None] * 2.0
    w += 0.008 * rng.standard_normal(w.shape)
    mono24 = np.clip(w, -1.0, 1.0 - 2.0 ** -23).astype(np.float32)
    clips = {
        "music_44k1_s16.flac": encode_flac(music, 44100, bits=16),
        "mono_48k_s24.flac": encode_flac(mono24, 48000, bits=24),
    }
    an = frontend.analyze(clips["mono_48k_s24.flac"])
    if decoder.sizing_for([an])["rice_narrow"]:
        raise SystemExit("mono_48k_s24.flac: every rice parameter <= 16; "
                         "the fixture must drive the wide scan")
    return clips


def mp3_clips(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "stereo_44k1_128k_js.mp3": lame_encode(stereo_noise(rng, 10.0, 44100),
                                               44100, 128, mode=1),
        "mono_22k05_lsf.mp3": lame_encode(stereo_noise(rng, 3.0, 22050)[:, :1],
                                          22050, 48, mode=3),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--only", choices=("mp3", "flac"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    clips = {}
    if args.only != "flac":
        clips.update(mp3_clips(args.seed))
    if args.only != "mp3":
        clips.update(flac_clips(args.seed))
    for name, blob in clips.items():
        path = os.path.join(args.out, name)
        with open(path, "wb") as f:
            f.write(blob)
        print(f"{path}: {len(blob)} bytes")


if __name__ == "__main__":
    main()

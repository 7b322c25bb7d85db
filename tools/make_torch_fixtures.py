"""Write the MP3 fixtures the PyTorch port's chip smoke run and tests use.

The machine with the GPU has no libmp3lame, so the clips are encoded once
with the system's libmp3lame and committed under tests/data/torch_port/:

* ``stereo_44k1_128k_js.mp3``: 10 s of 44.1 kHz stereo noise at 128 kbps
  joint stereo, the MP3 half of bench.py's mixed workload (same signal
  recipe and LAME settings as bench.py's ``_mp3_blob``);
* ``mono_22k05_lsf.mp3``: 3 s of 22.05 kHz mono (MPEG-2 LSF, one granule
  per frame), which also exercises the channel-expanding batch concat.

Usage:  python tools/make_torch_fixtures.py [--out tests/data/torch_port]
"""

from __future__ import annotations

import argparse
import ctypes as C
import os

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tests", "data", "torch_port")


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    clips = {
        "stereo_44k1_128k_js.mp3": lame_encode(stereo_noise(rng, 10.0, 44100),
                                               44100, 128, mode=1),
        "mono_22k05_lsf.mp3": lame_encode(stereo_noise(rng, 3.0, 22050)[:, :1],
                                          22050, 48, mode=3),
    }
    for name, blob in clips.items():
        path = os.path.join(args.out, name)
        with open(path, "wb") as f:
            f.write(blob)
        print(f"{path}: {len(blob)} bytes")


if __name__ == "__main__":
    main()

"""BLAST's asset folder: the one-shots, loops, samples and stems a performer
loads into the engine's voices.

The configuration's ``folder`` lists the kinds in order, each with its
``count``, container (``wav``, ``aiff`` or ``mp3``), ``bits``, ``rate``,
``channels``, a length range in seconds and a level:

* ``hit``: drum-like one-shots, a pitched body sweeping down under a noise
  burst, each with its own decay and pan;
* ``loop``, ``smp``, ``stem``: the ``fma-mp3`` maker's music generator
  (``music_mp3.music``) at the kind's rate, over 4 s at least and cut to
  the file's length; a one-channel kind takes the
  mean of its two channels; ``mp3`` files are encoded by the benchmark's
  Layer III writer (``mp3_writer``) at the kind's ``kbps``.

File ``i`` is made from the generator seeded by (``pool_seed``, i) and
named ``<kind><n>`` (``info["name"]``) with its container's extension
(``info["ext"]``); ``info["frames"]`` is its frames at its own rate.  The
WAV (16-bit) and AIFF (24-bit, big-endian, an 80-bit rate) headers are
written here.  Nothing here imports the program under test.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from . import mp3_writer
from .music_mp3 import music

EXT = "wav"
CHUNK = 1


def layout(config: dict) -> list[tuple[dict, int]]:
    """Each pool file's kind and its number within the kind, in pool order."""
    out = [(kind, n) for kind in config["folder"] for n in range(int(kind["count"]))]
    if len(out) != int(config["pool_files"]):
        raise ValueError(f"the folder holds {len(out)} files, pool_files is "
                         f"{config['pool_files']}")
    return out


def make_files(config: dict, indices) -> list[tuple[bytes, dict]]:
    kinds = layout(config)
    return [_file(config, i, *kinds[i]) for i in indices]


def _file(config: dict, i: int, kind: dict, n: int) -> tuple[bytes, dict]:
    rng = np.random.default_rng([int(config["pool_seed"]), i])
    rate, ch = int(kind["rate"]), int(kind["channels"])
    lo, hi = kind["seconds"]
    frames = int(round(rng.uniform(float(lo), float(hi)) * rate))
    gain = 10 ** (float(kind["level_db"]) / 20)
    if kind["kind"] == "hit":
        x = _hit(rng, frames, rate) * gain
    else:   # a few seconds at least, so that every instrument plays; then cut
        x = music(rng, max(frames, 4 * rate), rate)[:frames] * gain
    if ch == 1:
        x = x.mean(axis=1, keepdims=True)
    fmt = kind["format"]
    if fmt == "wav":
        blob = wav16(x, rate)
    elif fmt == "aiff":
        blob = aiff24(x, rate)
    elif fmt == "mp3":
        blob, offsets = mp3_writer.encode(x, int(kind["kbps"]))
        frames = len(offsets) * mp3_writer.FRAME
    else:
        raise ValueError(f"no writer for {fmt!r}")
    name = f"{kind['kind']}{n:02d}"
    return blob, {"frames": frames, "ext": {"aiff": "aif"}.get(fmt, fmt), "name": name}


def _hit(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    """A drum-like one-shot, stereo float [n, 2], peak 1."""
    t = np.arange(n) / rate
    f0, f1 = rng.uniform(120, 900), rng.uniform(35, 110)
    sweep = f1 + (f0 - f1) * np.exp(-t / rng.uniform(0.01, 0.08))
    body = np.sin(2 * np.pi * np.cumsum(sweep) / rate) * np.exp(-t / rng.uniform(0.05, 0.5))
    noise = rng.standard_normal(n) * np.exp(-t / rng.uniform(0.005, 0.06))
    x = body + rng.uniform(0.1, 0.8) * noise
    x[: max(1, int(0.002 * rate))] *= np.linspace(0, 1, max(1, int(0.002 * rate)))
    x /= max(np.abs(x).max(), 1e-9)
    th = (rng.uniform(-0.6, 0.6) + 1) * np.pi / 4
    return np.stack([np.cos(th) * x, np.sin(th) * x], axis=1) * math.sqrt(2) / 2


def _pcm(x: np.ndarray, bits: int) -> np.ndarray:
    full = (1 << (bits - 1)) - 1
    return np.clip(np.round(x * full), -full - 1, full).astype(np.int64)


def wav16(x: np.ndarray, rate: int) -> bytes:
    """A RIFF WAVE file of 16-bit PCM from float [n, channels] within ±1."""
    ch = x.shape[1]
    data = _pcm(x, 16).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, ch, rate, rate * ch * 2, ch * 2, 16)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt \
        + b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _extended(rate: int) -> bytes:
    """A positive integer as an IEEE 754 80-bit extended float, big-endian."""
    e = rate.bit_length() - 1
    return struct.pack(">HQ", 16383 + e, rate << (63 - e))


def aiff24(x: np.ndarray, rate: int) -> bytes:
    """An AIFF file of 24-bit big-endian PCM from float [n, channels]."""
    n, ch = x.shape
    v = _pcm(x, 24).reshape(-1) & 0xFFFFFF
    data = np.stack([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF], axis=1).astype(np.uint8)
    data = data.tobytes()
    comm = struct.pack(">hIh", ch, n, 24) + _extended(rate)
    ssnd = struct.pack(">II", 0, 0) + data
    body = b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm \
        + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd + (b"\0" if len(ssnd) % 2 else b"")
    return b"FORM" + struct.pack(">I", len(body)) + body

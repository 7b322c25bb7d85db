"""An FMA-like pool: seeded music-like stereo clips, encoded as MP3.

Each clip is ``clip_seconds`` of 44.1 kHz stereo music: a drum kit (kick,
snare, hats), a bass line, chords and a lead melody in a seeded key, tempo
and progression, each instrument panned, with a short cross-channel echo,
mastered to a seeded loudness.  Clip ``i`` is made from the generator
seeded by (``pool_seed``, i) and encoded by ``mp3_writer`` at
``bitrates_kbps[i % len(bitrates_kbps)]``.  Each frame's main data is its
own, so a clip rotated by whole frames is a clip too (``frame_offsets``).
Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
from scipy import signal

from . import mp3_writer

EXT = "mp3"
CHUNK = 1
_TABLE = 2048
_MAJOR = np.array([0, 2, 4, 5, 7, 9, 11])
_MINOR = np.array([0, 2, 3, 5, 7, 8, 10])


def _wavetable(amps) -> np.ndarray:
    ph = np.arange(_TABLE) / _TABLE
    return sum(a * np.sin(2 * np.pi * (h + 1) * ph) for h, a in enumerate(amps))


def _voice(n, onsets, lengths, freqs, table, attack, decay, rate) -> np.ndarray:
    """Notes back to back (onsets ascending, ``lengths`` samples each) on a
    wavetable, each with its own attack and exponential decay."""
    out = np.zeros(n)
    end = min(n, int(onsets[-1] + lengths[-1]))
    start = int(np.ceil(onsets[0]))
    idx = np.arange(start, end)
    note = np.searchsorted(onsets, idx, side="right") - 1
    t = idx - onsets[note]
    live = t < lengths[note]
    phase = np.cumsum(freqs[note] / rate)
    env = (1 - np.exp(-t / (attack * rate))) * np.exp(-t / (decay * rate))
    out[start:end] = np.where(live, table[(phase * _TABLE).astype(np.int64) % _TABLE] * env, 0)
    return out


def _hits(n, times, template) -> np.ndarray:
    imp = np.zeros(n)
    np.add.at(imp, times[times < n], 1.0)
    return signal.fftconvolve(imp, template)[:n]


def music(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    """``n`` frames of stereo music-like audio, float [n, 2] within ±1."""
    beat = rate * 60.0 / rng.uniform(80, 160)
    key = 110.0 * 2 ** (rng.integers(0, 12) / 12)
    scale = _MAJOR if rng.random() < 0.5 else _MINOR
    beats = np.arange(int(n / beat) + 2) * beat
    bars = beats[::4]
    prog = rng.choice([0, 3, 4, 5, 1], size=len(bars))        # chord roots, scale degrees

    def hz(degree, octave):
        d = np.asarray(degree)
        return key * 2 ** (octave + (scale[d % 7] + 12 * (d // 7)) / 12)

    tracks = []
    # drums: kick on 1 and 3, snare on 2 and 4, hats on the eighths
    t = np.arange(int(0.3 * rate)) / rate
    kick = np.sin(2 * np.pi * np.cumsum(50 + 90 * np.exp(-t / 0.03)) / rate) * np.exp(-t / 0.12)
    noise = rng.standard_normal(len(t))
    snare = (0.6 * np.diff(noise, prepend=0) + 0.4 * np.sin(2 * np.pi * 185 * t)) * np.exp(-t / 0.06)
    hat = np.diff(np.diff(rng.standard_normal(len(t)), prepend=0), prepend=0)[:int(0.06 * rate)]
    hat *= np.exp(-t[:len(hat)] / 0.012)
    b = beats.astype(np.int64)
    eighths = (np.arange(2 * len(beats)) * beat / 2).astype(np.int64)
    tracks.append((_hits(n, b[::2], kick) * 0.9, 0.0))
    tracks.append((_hits(n, b[1::2], snare) * 0.35, rng.uniform(-0.2, 0.2)))
    tracks.append((_hits(n, eighths, hat) * rng.uniform(0.08, 0.2), rng.uniform(-0.6, 0.6)))
    # bass: the chord's root, one note a beat
    roots = np.repeat(prog, 4)[:len(beats)]
    tracks.append((_voice(n, beats, np.full(len(beats), 0.9 * beat), hz(roots, 0),
                          _wavetable([1, 0.5, 0.33, 0.25, 0.2]), 0.005, 0.4, rate) * 0.5,
                   rng.uniform(-0.1, 0.1)))
    # chords: root, third and fifth over each bar
    pad = _wavetable([1, 0.3, 0.2, 0.1, 0.08, 0.05])
    for j, step in enumerate((0, 2, 4)):
        tracks.append((_voice(n, bars, np.full(len(bars), 4 * beat), hz(prog + step, 1), pad,
                              0.08, 2.5, rate) * 0.16, (-0.5, 0.0, 0.5)[j]))
    # lead: eighth and quarter notes on the scale, with rests
    dur = rng.choice([0.5, 1.0], size=4 * len(beats)) * beat
    on = np.concatenate([[beats[0]], np.cumsum(dur)[:-1]])
    keep = (rng.random(len(on)) > 0.2) & (on < n)
    deg = np.cumsum(rng.integers(-2, 3, size=len(on))) % 14
    tracks.append((_voice(n, on[keep], dur[keep] * 0.95, hz(deg[keep], 2),
                          _wavetable([1, 0.6, 0.4, 0.3, 0.2, 0.1, 0.05]), 0.01, 0.5, rate) * 0.22,
                   rng.uniform(-0.4, 0.4)))

    out = np.zeros((n, 2))
    for x, pan in tracks:
        th = (pan + 1) * np.pi / 4
        out[:, 0] += np.cos(th) * x
        out[:, 1] += np.sin(th) * x
    for ch, d in ((0, int(0.023 * rate)), (1, int(0.031 * rate))):   # cross-channel echo
        out[d:, ch] += 0.25 * out[:-d, 1 - ch]
    rms = np.sqrt(np.mean(out ** 2))
    out *= 10 ** (rng.uniform(-16, -10) / 20) / max(rms, 1e-9)
    return np.tanh(out)


def make_files(config: dict, indices) -> list[tuple[bytes, dict]]:
    return [_clip(config, i) for i in indices]


def _clip(config: dict, i: int) -> tuple[bytes, dict]:
    rate = int(config["sample_rate"])
    n = int(round(float(config["clip_seconds"]) * rate))
    pcm = music(np.random.default_rng([int(config["pool_seed"]), i]), n, rate)
    kbps = config["bitrates_kbps"][i % len(config["bitrates_kbps"])]
    blob, offsets = mp3_writer.encode(pcm, int(kbps))
    frames = len(offsets) * mp3_writer.FRAME
    return blob, {"frames": frames, "frame_offsets": offsets.tolist()}

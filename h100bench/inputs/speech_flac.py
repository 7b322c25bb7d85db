"""A LibriSpeech-like pool: seeded speech-like utterances, encoded as FLAC.

Each utterance is read speech as a corpus of audiobooks holds it: phrases
of voiced syllables (a glottal pulse train through three moving formants)
and unvoiced ones (band-passed noise), pauses between phrases, and a low
room noise under everything, at 16 kHz mono 16-bit.  Utterance ``i`` is
made from the generator seeded by (``pool_seed``, i), at the length
``lengths`` gives it.  The streams come from ``flac_writer``.  Nothing here imports the program under
test.
"""

from __future__ import annotations

import numpy as np
from scipy import signal, stats

from .flac_writer import encode_many

# vowel formant targets (Hz): F1, F2, F3
_VOWELS = np.array([[730, 1090, 2440], [270, 2290, 3010], [300, 870, 2240],
                    [530, 1840, 2480], [640, 1190, 2390], [490, 1350, 1690],
                    [660, 1720, 2410], [440, 1020, 2240]], np.float64)


def _resonator(f: float, bw: float, rate: int):
    r = np.exp(-np.pi * bw / rate)
    return np.array([1.0 - r, 0.0, 0.0]), np.array([1.0, -2 * r * np.cos(2 * np.pi * f / rate), r * r])


def speech(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    """``n`` int16 samples of speech-like audio."""
    x = np.zeros(n)
    t = int(rng.uniform(0.1, 0.4) * rate)  # leading silence
    f0_base = rng.uniform(90, 220)  # the reader's pitch
    state = [np.zeros(2) for _ in range(3)]
    while t < n:
        phrase_end = min(n, t + int(rng.uniform(1.0, 4.0) * rate))
        f0 = f0_base * rng.uniform(0.9, 1.15)
        while t < phrase_end:
            m = min(phrase_end - t, int(rng.uniform(0.12, 0.3) * rate))
            env = np.sin(np.pi * (np.arange(m) + 0.5) / m) ** 0.7
            if rng.random() < 0.75:  # voiced: pulses through formants
                contour = f0 * (1 + 0.03 * np.sin(np.linspace(0, rng.uniform(1, 3), m)))
                contour *= 1 + 0.01 * rng.standard_normal(m)
                phase = np.cumsum(contour / rate)
                src = np.diff(np.floor(phase), prepend=np.floor(phase[0])) > 0
                src = signal.lfilter([1.0], [1.0, -0.95], src.astype(np.float64))
                seg = np.zeros(m)
                for j, (fc, bw) in enumerate(zip(_VOWELS[rng.integers(len(_VOWELS))]
                                                 * rng.uniform(0.92, 1.08, 3), (80, 100, 140))):
                    b, a = _resonator(fc, bw, rate)
                    y, state[j] = signal.lfilter(b, a, src, zi=state[j])
                    seg += y * (1.0, 0.5, 0.25)[j]
                seg *= 0.9 / max(np.abs(seg).max(), 1e-9)
                f0 *= 0.995  # declination over the phrase
            else:  # unvoiced: band-passed noise
                b, a = signal.butter(2, [rng.uniform(2000, 3500), 7000], btype="band", fs=rate)
                seg = signal.lfilter(b, a, rng.standard_normal(m)) * 0.25
            x[t:t + m] += seg * env * rng.uniform(0.4, 1.0)
            t += m
        t += int(rng.uniform(0.15, 0.8) * rate)  # pause
    x *= rng.uniform(0.25, 0.7) / max(np.abs(x).max(), 1e-9)  # the reader's level
    x += 10 ** (-60 / 20) * signal.lfilter([1.0], [1.0, -0.9], rng.standard_normal(n)) * 0.3
    return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)


EXT = "flac"
CHUNK = 32


def lengths(config: dict) -> np.ndarray:
    """Each pool file's length in samples: the ``pool_files`` mid-quantiles
    of a gamma distribution of shape ``length_shape`` with the corpus's
    mean, clipped to its shortest and longest, in an order shuffled once
    by ``pool_seed``."""
    n = int(config["pool_files"])
    q = stats.gamma.ppf((np.arange(n) + 0.5) / n, float(config["length_shape"]))
    s = np.clip(q / q.mean() * float(config["mean_length_s"]),
                float(config["min_length_s"]), float(config["max_length_s"]))
    order = np.random.default_rng([int(config["pool_seed"]), n]).permutation(n)
    return np.round(s[order] * int(config["sample_rate"])).astype(np.int64)


def truth(config: dict, i: int) -> np.ndarray:
    """Utterance ``i``'s int16 samples [frames, 1]."""
    rate = int(config["sample_rate"])
    rng = np.random.default_rng([int(config["pool_seed"]), i])
    return speech(rng, int(lengths(config)[i]), rate)[:, None]


def make_files(config: dict, indices) -> list[tuple[bytes, dict]]:
    samples = [truth(config, i)[:, 0] for i in indices]
    blobs = encode_many(samples, int(config["sample_rate"]))
    return [(b, {"frames": len(s)}) for b, s in zip(blobs, samples)]

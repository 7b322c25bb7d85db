"""Peaks of one NVIDIA H100 SXM and the least work of each hand kernel.

Peaks are the data sheet's: 3.35 TB/s of HBM and 67 TFLOP/s of float32
outside the tensor cores, at the full 700 W (the run prints the card's
power limit beside them).  A kernel's least time is the larger of its
bytes over the bandwidth and its float32 operations over the peak, counting
each input byte read once and each output byte written once, whatever the
kernel reads again; where the work depends on the data, what these inputs
need.  The counts come from the files decoded, not from the program.
"""

from __future__ import annotations

import functools

from .reference import mp3

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def seconds(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS)


@functools.lru_cache(maxsize=64)
def _mp3_shape(blob: bytes) -> tuple[int, int, int, int]:
    """(granule-channels, coded bits, frames, channels) of a Layer III stream."""
    frames = mp3.find_frames(blob)
    lanes, coded = mp3.huffman_bits(blob)
    return lanes, coded, len(frames), frames[0][1]["channels"] if frames else 0


def k1_seconds(blob: bytes) -> float:
    """K1, the Layer III entropy decode: the coded part2_3 bits read, 576
    int16 lines written per granule-channel."""
    lanes, coded, _, _ = _mp3_shape(blob)
    return seconds(coded / 8 + lanes * 576 * 2)


def k2_seconds(blob: bytes) -> float:
    """K2, the synthesis filterbank: float32 subband samples read and PCM
    written (4 + 4 bytes a sample); 32→64 matrixing (64 × 32 MACs) and the
    16-tap window (32 × 16 MACs) per 32 samples, 160 operations a sample."""
    _, _, frames, channels = _mp3_shape(blob)
    samples = frames * 1152 * channels
    return seconds(8 * samples, 160 * samples)


def k3_seconds(samples: int) -> float:
    """K3, FLAC's PCM assembly: each float32 sample read once and written
    once."""
    return seconds(8 * samples)


def k4_seconds(samples: int) -> float:
    """K4, FLAC's value assembly: each int32 residual or warm-up value read
    once and written once."""
    return seconds(8 * samples)

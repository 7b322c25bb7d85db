# Verbatim copy of audio_decoder_tpu/utils/rng.py (that package imports jax on import).
"""Random number generation: host xoroshiro128+ and device threefry.

The reference ships a hand-rolled xoroshiro128+ with splitmix64 seeding
and Lemire range reduction (blast_rand.rs:4-59), seeded from rdtsc/
cntvct_el0 (blast_rand.rs:64-88).  Two TPU-build equivalents:

* `X128P` — a faithful host-side xoroshiro128+ for cheap REPL-side
  randomness (same algorithm, same bit widths, validated against the
  published reference vectors of the algorithm family);
* device randomness uses `jax.random` (threefry) keyed per (voice, step)
  in the engine renderer — counter-based so block rendering stays
  data-parallel and reproducible (no sequential RNG state to carry).
"""

from __future__ import annotations

import time

_M64 = (1 << 64) - 1


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _M64


def splitmix64(seed: int):
    """splitmix64 stream (the seeding expander, blast_rand.rs:12-21)."""
    state = seed & _M64
    while True:
        state = (state + 0x9E3779B97F4A7C15) & _M64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        yield z ^ (z >> 31)


class X128P:
    """xoroshiro128+ (blast_rand.rs:23-59), stream-compatible with the
    reference: the ORIGINAL 2016 rotation constants (55, 14, 36) that
    blast_rand.rs:34-36 uses — not the 2018 revision (24, 16, 37) —
    and the same splitmix64 state expansion, so a given seed yields the
    reference's exact u64 sequence (pinned in tests/test_rng.py against
    an independent wrapping-u64 reimplementation of the Rust)."""

    def __init__(self, seed: int | None = None):
        if seed is None:
            seed = fast_seed()
        g = splitmix64(seed)
        self.s0 = next(g)
        self.s1 = next(g)

    def next_u64(self) -> int:
        s0, s1 = self.s0, self.s1
        result = (s0 + s1) & _M64
        s1 ^= s0
        self.s0 = _rotl(s0, 55) ^ s1 ^ ((s1 << 14) & _M64)
        self.s1 = _rotl(s1, 36)
        return result

    def next_f64(self) -> float:
        """Uniform in [0, 1) from the top 53 bits (blast_rand.rs:41-44)."""
        return (self.next_u64() >> 11) * (1.0 / (1 << 53))

    def next_f32(self) -> float:
        """f64 narrowed to f32 (blast_rand.rs:46-48 does `as f32`, i.e.
        round-to-nearest from the 53-bit double — not a fresh 24-bit
        draw), so the f32 stream matches the reference bit-for-bit."""
        import struct as _st

        return _st.unpack("f", _st.pack("f", self.next_f64()))[0]

    def next_range(self, lo: int, hi: int) -> int:
        """Lemire multiply-shift range reduction onto [lo, hi)
        (blast_rand.rs:50-59)."""
        if hi <= lo:
            raise ValueError("empty range")
        span = hi - lo
        return lo + (((self.next_u64() * span) >> 64) & _M64)


def fast_seed() -> int:
    """Monotonic-clock seed (the portable fallback of blast_rand.rs:80-88;
    rdtsc/cntvct are microarch details the build doesn't need)."""
    return time.monotonic_ns() & _M64

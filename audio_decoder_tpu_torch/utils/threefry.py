"""Threefry-2x32 counter-based random numbers, bit for bit those of
``jax.random`` with ``jax_threefry_partitionable`` on (JAX 0.9's default).

The JAX package draws the renderer's chance rolls and jitter seed and the
encoder's TPDF dither from ``jax.random``; this module reproduces those
draws on any torch device, so both packages render and encode the same
bits.  Keys are int64 tensors ``[2]`` carrying uint32 values (the raw key
data of a legacy ``jax.random.PRNGKey``), and every uint32 quantity is
carried in int64 and masked with ``& 0xFFFFFFFF``: torch has no logical
uint32 shift on the CPU.

The functions follow ``jax/_src/prng.py`` and ``jax/_src/random.py``:

* ``threefry2x32``: the 20-round hash (``_threefry2x32_lowering``);
* ``prng_key(seed)``: ``threefry_seed`` of a 32-bit seed, ``[0, seed]``;
* ``fold_in(key, data)``: ``threefry_2x32(key, threefry_seed(uint32(data)))``;
* ``random_bits(key, shape)``: per-element counters (``iota_2x32_shape``:
  high word 0, low word the flat index), then ``bits1 ^ bits2``;
* ``split(key, n)``: the fold-like split, key ``i`` = the hash of counter ``i``;
* ``uniform``: ``bits >> 9 | 0x3F800000`` read as f32, minus 1, scaled;
* ``randint``: two draws from ``split(key)``, combined modulo the span in
  uint32 arithmetic, for int32 results.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def mul32(a, b):
    """``a * b`` modulo 2**32 for uint32 values in int64 (the plain product
    could pass 2**63)."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & M32) | (v >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counters ``(x1, x2)`` under key ``(k1, k2)``
    (uint32 values in int64 tensors that broadcast together)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & M32
    x1 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int, *, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as raw key data ``[hi, lo]``.  Without
    x64, JAX holds the seed in 32 bits: the high word is 0."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def _u32(data, device) -> torch.Tensor:
    """A scalar as uint32 in int64: negative int32 values wrap as in JAX's
    int32 → uint32 conversion."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.int64) & M32
    return torch.tensor(int(data) & M32, dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a scalar ``data`` (an int or a
    0-d integer tensor on the key's device)."""
    d = _u32(data, key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([y0, y1])


def _counters(key: torch.Tensor, shape) -> torch.Tensor:
    n = math.prod(shape)
    if n >= 1 << 32:
        raise NotImplementedError("more than 2**32 random values in one draw")
    return torch.arange(n, dtype=torch.int64, device=key.device)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (``jax.random.bits``, uint32
    values in int64)."""
    lo = _counters(key, shape)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape(tuple(shape))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[num, 2]`` keys."""
    lo = _counters(key, (num,))
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], dim=1)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _urem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 remainder as XLA defines it: ``a % 0`` is ``a``."""
    return torch.where(b == 0, a, a % torch.where(b == 0, 1, b))


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with int32 bounds
    and results."""
    lo, hi = int(minval), int(maxval)
    if not (-(1 << 31) <= lo < 1 << 31 and -(1 << 31) <= hi < 1 << 31):
        raise OverflowError("randint bounds must fit in int32")
    span = (hi - lo) & M32 if hi > lo else 1
    k1, k2 = split(key)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    sp = torch.tensor(span, dtype=torch.int64, device=key.device)
    mult = _urem(torch.tensor(1 << 16, dtype=torch.int64, device=key.device), sp)
    mult = _urem(mul32(mult, mult), sp)
    off = mul32(_urem(higher, sp), mult) + _urem(lower, sp)
    off = _urem(off & M32, sp)
    val = ((lo & M32) + off) & M32
    return torch.where(val >= 1 << 31, val - (1 << 32), val).to(torch.int32)

"""PyTorch port: utils/threefry.py bit for bit against ``jax.random``.

The renderer's chance rolls and jitter seed and the encoder's dither are
``jax.random`` draws in the JAX package; the port reproduces them with its
own threefry.  Every comparison here is exact, over several seeds, shapes
(odd sizes and 0-d included) and fold-in data (negative int32 clocks
included), on the CPU, but one: ``normal`` is held to ``jax.random.normal``
within ``NORMAL_BAR`` (2e-6; the port follows XLA's ``erf_inv`` polynomial
but its ``log1p`` rounds as torch's does, 4.8e-7 is the worst seen).
``uniform`` over any range equals JAX's bit for bit (XLA:CPU computes
``floats * (hi - lo) + lo`` as one FMA, and so does the port).  ``uniform``
and ``normal`` put nothing on the device and equal the same draws with
their bounds and constants as float32 tensors.  The host xoroshiro128+ (utils/rng.py, a verbatim
copy) is held to tests/test_rng.py's vectors and to the JAX package's
streams.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_decoder_tpu.utils import rng as JRNG
from audio_decoder_tpu_torch.utils import rng as PRNG
from audio_decoder_tpu_torch.utils import threefry as TF
from audio_decoder_tpu_torch.utils import trace

from .test_rng import _ref_x128p_stream

SEEDS = [0, 1, 7, 0xB1A57, 2**31 - 1, 2**32 - 1, -1, -12345]
SHAPES = [(), (1,), (2,), (5,), (3, 7), (96, 128), (2, 1001)]
CLOCKS = [0, 7, 128, 4096 * 63, 2**31 - 1, -1, -(2**31), -4096, 123456789]
NORMAL_BAR = 2e-6


def _key(seed):
    return jax.random.PRNGKey(seed), TF.prng_key(seed, device="cpu")


def test_jax_draws_are_partitionable():
    """The port copies the partitionable mode; a JAX that flips the flag
    must fail here, not drift."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    jk, pk = _key(seed)
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), pk.numpy())


@pytest.mark.parametrize("clock", CLOCKS)
def test_fold_in_int32_data(clock):
    jk, pk = _key(0xB1A57)
    want = np.asarray(jax.random.fold_in(jk, jnp.int32(clock)))
    assert np.array_equal(want.astype(np.int64), TF.fold_in(pk, clock).numpy())
    # a 0-d int32 tensor (the engine's clock) folds in the same
    got = TF.fold_in(pk, torch.tensor(clock, dtype=torch.int32))
    assert np.array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform(seed, shape):
    jk, pk = _key(seed)
    jb = np.asarray(jax.random.bits(jk, shape))
    pb = TF.random_bits(pk, shape).numpy()
    assert pb.shape == jb.shape
    np.testing.assert_array_equal(jb.astype(np.int64), pb)
    ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    pu = TF.uniform(pk, shape).numpy()
    assert pu.dtype == np.float32 and pu.shape == ju.shape
    np.testing.assert_array_equal(ju.view(np.uint32), pu.view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(0, 2**31 - 1), (0, 10), (-5, 5), (3, 3),
                                   (10, 2), (-(2**31), 2**31 - 1), (7, 2**31 - 1),
                                   (0, 1 << 16)])
def test_randint(lo, hi):
    for seed in (0, 0xB1A57):
        jk, pk = _key(seed)
        for shape in [(), (17,), (4, 3)]:
            want = np.asarray(jax.random.randint(jk, shape, lo, hi))
            got = TF.randint(pk, shape, lo, hi)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(want, got.numpy())


def test_split():
    jk, pk = _key(42)
    for n in (1, 2, 3, 8):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(jk, n)).astype(np.int64),
            TF.split(pk, n).numpy())


@pytest.mark.parametrize("clock", CLOCKS)
def test_the_renderers_draws(clock):
    """The two draws render_block makes: the jitter seed and the lane-keyed
    chance uniforms at a (possibly negative) clock."""
    jk, pk = _key(0xB1A57)
    want = np.asarray(jax.random.randint(
        jax.random.fold_in(jk, 7), (), 0, 2**31 - 1))
    assert int(want) == int(TF.randint(TF.fold_in(pk, 7), (), 0, 2**31 - 1))
    ju = np.asarray(jax.random.uniform(
        jax.random.fold_in(jk, jnp.int32(clock)), (96, 257), dtype=jnp.float32))
    pu = TF.uniform(TF.fold_in(pk, torch.tensor(clock, dtype=torch.int32)),
                    (96, 257)).numpy()
    np.testing.assert_array_equal(ju.view(np.uint32), pu.view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(1000.0, 87200.0), (-3.0, 5.5), (0.0, 1.0)])
def test_uniform_over_a_range_equals_jax(lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(12), (100_000,),
                                         jnp.float32, lo, hi))
    got = TF.uniform(TF.prng_key(12, device="cpu"), (100_000,), lo, hi).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_normal_within_its_bar_of_jax():
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (8, 4410, 2)))
    got = TF.normal(TF.prng_key(11, device="cpu"), (8, 4410, 2))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= NORMAL_BAR


def test_erf_inv_edges():
    """±1 give ±inf, 0 gives 0, and the output is odd (as XLA's)."""
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.5, 0.999], dtype=torch.float32)
    y = TF.erf_inv(x)
    assert y[0] == -np.inf and y[1] == np.inf and y[2] == 0.0
    assert y[3] == -y[4]
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy()[3:])))
    np.testing.assert_allclose(y[3:].numpy(), want, rtol=0, atol=NORMAL_BAR)


#: every (minval, maxval) the port draws over: the render's, ``normal``'s,
#: the render benchmark's positions, and two more
RANGES = [(0.0, 1.0), (float(np.nextafter(np.float32(-1.0), np.float32(0.0))), 1.0),
          (1000.0, 87200.0), (-3.3, 7.1), (0.25, 0.5)]


def _h2d():
    s = trace.TRACE.stats.get("h2d")
    return (s.calls, s.items) if s is not None else (0, 0.0)


def _uniform_with_tensor_bounds(key, shape, lo, hi):
    """``uniform`` with its bounds as float32 tensors beside the draw."""
    bits = TF.random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = torch.tensor(lo, dtype=torch.float32), torch.tensor(hi, dtype=torch.float32)
    return torch.maximum(lo, TF._fma(floats, hi - lo, lo))


@pytest.mark.parametrize("lo,hi", RANGES)
def test_uniform_puts_nothing_and_equals_the_draw_with_tensor_bounds(lo, hi):
    key = TF.prng_key(0xB1A57, device="cpu")
    before = _h2d()
    got = TF.uniform(key, (4097,), lo, hi)
    assert _h2d() == before
    want = _uniform_with_tensor_bounds(key, (4097,), lo, hi)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_normal_puts_nothing_and_equals_the_draw_with_tensor_constants():
    """``normal`` against the same draw with ``sqrt(2)`` and every
    ``erf_inv`` coefficient as a float32 tensor: bit for bit."""
    key = TF.prng_key(11, device="cpu")
    before = _h2d()
    got = TF.normal(key, (8, 4410, 2))
    assert _h2d() == before

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    x = _uniform_with_tensor_bounds(key, (8, 4410, 2), RANGES[1][0], 1.0)
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    t = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, f32(TF._ERFINV_LT5[0]), f32(TF._ERFINV_GE5[0]))
    for a, b in zip(TF._ERFINV_LT5[1:], TF._ERFINV_GE5[1:]):
        p = TF._fma(p, t, torch.where(lt, f32(a), f32(b)))
    want = f32(math.sqrt(2)) * torch.where(x.abs() == 1.0, x * math.inf, p * x)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, size=1000, dtype=np.uint64)
    b = rng.integers(0, 2**32, size=1000, dtype=np.uint64)
    want = (a.astype(np.uint32) * b.astype(np.uint32)).astype(np.int64)
    got = TF.mul32(torch.as_tensor(a.astype(np.int64)),
                   torch.as_tensor(b.astype(np.int64)))
    np.testing.assert_array_equal(want, got.numpy())


# ---------------------------------------------------------------- host RNG


def test_host_splitmix64_known_vectors():
    g = PRNG.splitmix64(0)
    assert [next(g) for _ in range(3)] == [
        0xE220A8397B1DCDAF, 0x6E789E6AA1B965F4, 0x06C45D188009454F]


@pytest.mark.parametrize("seed", [0, 1, 42, 0xDEADBEEF, (1 << 64) - 1])
def test_host_xoroshiro_streams(seed):
    with np.errstate(over="ignore"):
        want = _ref_x128p_stream(seed, 64)
    r, j = PRNG.X128P(seed=seed), JRNG.X128P(seed=seed)
    assert [r.next_u64() for _ in range(64)] == want
    for _ in range(64):
        j.next_u64()
    assert [r.next_f64() for _ in range(16)] == [j.next_f64() for _ in range(16)]
    assert [r.next_f32() for _ in range(16)] == [j.next_f32() for _ in range(16)]
    assert ([r.next_range(10, 20) for _ in range(64)]
            == [j.next_range(10, 20) for _ in range(64)])
    with pytest.raises(ValueError):
        r.next_range(3, 3)

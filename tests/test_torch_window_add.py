"""PyTorch port, window-add (K3/K4): the plain torch twins of the CUDA
kernels against the JAX package's Pallas kernels, run in interpret mode on
the CPU, and against the ``lax.scatter_add`` oracle.

Inputs are made from a numpy seed with the FLAC contract: live windows
tile ``[0, X)`` contiguously, updates past each live count are zero, and
padding lanes at the tail carry start 0 and zero updates.  Every result
must match exactly, in int32 and in float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from audio_decoder_tpu.ops import window_add as JW
from audio_decoder_tpu_torch.ops import window_add as PW

from .test_torch_cuda import (WINDOW1_CASES, WINDOW_CASES, window1_case,
                              window_case)


def _oracle(starts, upd, n_out):
    dn = lax.ScatterDimensionNumbers(
        update_window_dims=(1,), inserted_window_dims=(),
        scatter_dims_to_operand_dims=(0,))
    x = jnp.zeros((n_out,), upd.dtype)
    return np.asarray(lax.scatter_add(
        x, jnp.asarray(starts)[:, None], jnp.asarray(upd), dn,
        indices_are_sorted=False, unique_indices=False,
        mode=lax.GatherScatterMode.CLIP))


_case = window_case


def _port(fn, *arrays_and_n):
    *arrays, n_out = arrays_and_n
    return fn(*[torch.from_numpy(a) for a in arrays], n_out).numpy()


@pytest.mark.parametrize("seed,L,W,n_live", WINDOW_CASES)
def test_window_add_plain_matches_jax(seed, L, W, n_live):
    rng = np.random.default_rng(seed)
    starts, upd, n_out = _case(rng, L, W, n_live, tile_elems=512)
    jax_out = np.asarray(JW.window_add(jnp.asarray(starts), jnp.asarray(upd),
                                       n_out, interpret=True))
    got = _port(PW.window_add_plain, starts, upd, n_out)
    assert got.dtype == np.int32 and got.shape == (n_out,)
    np.testing.assert_array_equal(got, jax_out)
    np.testing.assert_array_equal(got, _oracle(starts, upd, n_out))


def test_window_add_plain_f32_frame_assembly():
    """The f32 PCM-assembly shape: wide windows, few lanes."""
    rng = np.random.default_rng(7)
    starts, upd, n_out = _case(rng, 48, 2048, 31, tile_elems=512,
                               dtype=np.float32)
    jax_out = np.asarray(JW.window_add(jnp.asarray(starts), jnp.asarray(upd),
                                       n_out, interpret=True))
    got = _port(PW.window_add_plain, starts, upd, n_out)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_out)
    np.testing.assert_array_equal(got, _oracle(starts, upd, n_out))


def test_window_add_plain_cross_tile_halo():
    """Windows straddling the TPU kernel's output-tile boundaries."""
    tile = JW.TILE_R * 512
    W = 512
    starts = np.asarray([0, tile - 100, tile - 1, 2 * tile - W + 1], np.int32)
    rng = np.random.default_rng(11)
    upd = rng.integers(-9, 9, size=(4, W)).astype(np.int32)
    n_out = 2 * tile + W
    jax_out = np.asarray(JW.window_add(jnp.asarray(starts), jnp.asarray(upd),
                                       n_out, interpret=True))
    got = _port(PW.window_add_plain, starts, upd, n_out)
    np.testing.assert_array_equal(got, jax_out)
    np.testing.assert_array_equal(got, _oracle(starts, upd, n_out))


@pytest.mark.parametrize("cid", WINDOW1_CASES)
def test_window_add_plain_k3_edges_match_jax(cid):
    """K3's own edges (``window1_case``: rows 2-3 tiles of 4096 wide, starts
    that are not multiples of 4, a pile-up of 320 padding rows, re-pointed
    lanes with nonzero updates, windows cut by n_out, no lanes) == JAX
    window_add in interpret mode, exactly, in int32 and float32.  JAX's
    kernel takes no n_out of 0; there the twin gives an empty array."""
    starts, upd, n_out = window1_case(cid)
    got = _port(PW.window_add_plain, starts, upd, n_out)
    assert got.dtype == upd.dtype and got.shape == (n_out,)
    if n_out == 0:
        return
    jax_out = np.asarray(JW.window_add(jnp.asarray(starts), jnp.asarray(upd),
                                       n_out, interpret=True))
    np.testing.assert_array_equal(got, jax_out)
    # the oracle neither re-points starts nor cuts windows at n_out (CLIP
    # moves them): it applies where every nonzero lane is in order and fits
    live = np.any(upd != 0, axis=1)
    s = starts.astype(np.int64)
    if upd.shape[1] <= n_out and np.all(
            (s == np.maximum.accumulate(s))[live]) and np.all(
            (s + upd.shape[1] <= n_out)[live]):
        np.testing.assert_array_equal(got, _oracle(starts, upd, n_out))


@pytest.mark.parametrize("seed,Wa,Wb", [(5, 256, 8), (6, 520, 96)])
def test_window_add2_plain_matches_jax(seed, Wa, Wb):
    """Two lane sets of different widths into one output (the FLAC value
    assembly's rice + fixed-width pair) == JAX window_add2 == the sum of
    two single-set scatters."""
    rng = np.random.default_rng(seed)
    sa, ua, na = _case(rng, 192, Wa, 150, tile_elems=512)
    sb, ub, nb = _case(rng, 64, Wb, 40, tile_elems=512)
    n_out = max(na, nb)
    jax_out = np.asarray(JW.window_add2(
        jnp.asarray(sa), jnp.asarray(ua), jnp.asarray(sb), jnp.asarray(ub),
        n_out, interpret=True))
    got = _port(PW.window_add2_plain, sa, ua, sb, ub, n_out)
    np.testing.assert_array_equal(got, jax_out)
    want = (_oracle(sa, ua, n_out).astype(np.int64)
            + _oracle(sb, ub, n_out).astype(np.int64))
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_window_add_truncates_past_n_out():
    """Windows running past ``n_out`` drop their tail, as in the JAX
    kernel's ``[:n_out]``; an empty lane set gives zeros."""
    starts = np.asarray([0, 6, 9], np.int32)
    upd = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
    jax_out = np.asarray(JW.window_add(jnp.asarray(starts), jnp.asarray(upd),
                                       11, interpret=True))
    got = _port(PW.window_add_plain, starts, upd, 11)
    np.testing.assert_array_equal(got, jax_out)
    empty = _port(PW.window_add_plain, starts[:0], upd[:0], 5)
    np.testing.assert_array_equal(empty, np.zeros(5, np.int32))


def test_window_add_repoints_starts_through_running_max():
    """A start below an earlier one is re-pointed to the running maximum,
    as the JAX kernel's wrapper does, even for a lane with nonzero updates."""
    starts = np.asarray([0, 10, 5, 0], np.int32)
    upd = np.arange(1, 17, dtype=np.int32).reshape(4, 4)
    jax_out = np.asarray(JW.window_add(jnp.asarray(starts), jnp.asarray(upd),
                                       20, interpret=True))
    got = _port(PW.window_add_plain, starts, upd, 20)
    np.testing.assert_array_equal(got, jax_out)
    assert got[10] == 5 + 9 + 13


def test_cpu_wrappers_run_the_plain_twins():
    """On CPU tensors the wrappers compute the twins' result and launch no
    kernel; a device that is neither CPU nor CUDA raises."""
    rng = np.random.default_rng(3)
    sa, ua, na = _case(rng, 96, 64, 80, tile_elems=512)
    sb, ub, nb = _case(rng, 32, 8, 20, tile_elems=512)
    n_out = max(na, nb)
    before = dict(PW.launches)
    one = _port(PW.window_add, sa, ua, n_out)
    two = _port(PW.window_add2, sa, ua, sb, ub, n_out)
    assert PW.launches == before
    np.testing.assert_array_equal(one, _port(PW.window_add_plain, sa, ua, n_out))
    np.testing.assert_array_equal(
        two, _port(PW.window_add2_plain, sa, ua, sb, ub, n_out))
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        PW.window_add(torch.from_numpy(sa).to(meta),
                      torch.from_numpy(ua).to(meta), n_out)

"""PyTorch port, the host-built tables of the two MP3 CUDA kernels.

K1 (csrc/mp3_entropy.cu) looks big-values codes up in a two-level table in
shared memory, and count1 quads in a table of 10-bit windows; K2
(csrc/mp3_synth.cu) multiplies by SYNTH_N folded over its symmetry.
Neither kernel runs here, so these tests hold what they are built from:

* the two-level table against the flat prefix LUT, which is the JAX
  package's own (``huffman_device._BIGLUT``), for every prefix of every
  big table: code length, x and y exactly (every table is a complete
  code, so neither form has a bad-code entry, ln == 0);
* the count1 table against the ISO count1 codes, for every window;
* the tables' sizes against the constants the ``.cu`` source compiles in;
* the folded matrix against SYNTH_N: exact in f32, except row 16, which
  is dropped (|N[16]| < 1e-14);
* a plain torch emulation of the kernel's folded matrixing and FIR
  against ``synthesis_plain`` (atol 1e-6 at outputs of magnitude ~1: the
  sums run in another order, float32 round-off is ~1e-7 there) and
  against the JAX package's Pallas kernel in interpret mode (atol 1e-4,
  rtol 1e-5, the JAX package's own kernel-vs-XLA bar).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_decoder_tpu.codecs.mpeg import huffman_device as JHD
from audio_decoder_tpu.codecs.mpeg import tables as JT
from audio_decoder_tpu.codecs.mpeg.dsp import _G2 as JG2
from audio_decoder_tpu.ops.pallas_synth import TILE_T, polyphase_synthesis_pallas
from audio_decoder_tpu_torch.codecs.mpeg import dsp as PD
from audio_decoder_tpu_torch.codecs.mpeg import huffman_device as HD
from audio_decoder_tpu_torch.codecs.mpeg import huffman_tables as HT
from audio_decoder_tpu_torch.ops import synth_kernel as SK

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "audio_decoder_tpu_torch", "csrc")


def _cu_constants(name: str) -> dict:
    """``constexpr int kName = value;`` lines of a .cu source (ints, hex too)."""
    text = open(os.path.join(CSRC, name)).read()
    return {k: int(v, 0) for k, v in
            re.findall(r"constexpr int (k\w+) = (0x[0-9a-fA-F]+|\d+);", text)}


def _two_level_lookup(table_id: int, prefix: np.ndarray, width: int) -> np.ndarray:
    """The kernel's lookup of ``width``-bit prefixes, emulated in numpy."""
    lut = HD._LUT2.astype(np.int64)
    w1 = min(width, HD.L1_BITS)
    e = lut[HD._L1_BASE[table_id] + (prefix >> (width - w1))]
    sub = (e & HD.SUB_FLAG) != 0
    s = e & 15
    rest = width - w1
    # the next s bits after the first w1 (rest >= s where a subtable exists)
    nxt = (prefix >> np.maximum(rest - s, 0)) & ((1 << s) - 1)
    e2 = lut[HD._L1_ENTRIES + ((e >> 4) & 0x7FF) + np.where(sub, nxt, 0)]
    return np.where(sub, e2, e)


@pytest.mark.parametrize("table_id", sorted(HT.BIG_TABLES))
def test_two_level_table_matches_the_flat_lut(table_id):
    width = int(HD._BIG_WIDTH[table_id])
    assert width == int(JHD._BIG_WIDTH[table_id])
    prefix = np.arange(1 << width, dtype=np.int64)
    flat = JHD._BIGLUT[JHD._BIG_BASE[table_id] + prefix].astype(np.int64)
    got = _two_level_lookup(table_id, prefix, width)
    np.testing.assert_array_equal(got >> 8, flat >> 8)          # code length
    np.testing.assert_array_equal((got >> 4) & 15, (flat >> 4) & 15)
    np.testing.assert_array_equal(got & 15, flat & 15)
    assert (flat >> 8).min() >= 0 and ((got & HD.SUB_FLAG) == 0).all()


def test_no_prefix_is_a_bad_code_in_either_form():
    """Every big table is a complete code (Kraft sum 1), so no prefix
    decodes to the bad-code entry (ln == 0), flat or two-level, and no
    subtable has a hole; the kernel's ln == 0 check guards nothing else."""
    for t in sorted(HT.BIG_TABLES):
        assert sum(2.0 ** -ln for ln, _c in HT.BIG_TABLES[t].values()) == 1.0
        w = int(HD._BIG_WIDTH[t])
        prefix = np.arange(1 << w, dtype=np.int64)
        assert (JHD._BIGLUT[JHD._BIG_BASE[t] + prefix] >> 8).min() > 0
        assert (_two_level_lookup(t, prefix, w) >> 8).min() > 0
    assert (HD._LUT2 >> 8).min() > 0


@pytest.mark.parametrize("sel", [0, 1])
def test_count1_table_matches_the_iso_codes(sel):
    """Each 10-bit window's entry against COUNT1_TABLES read directly: the
    one code that prefixes the window, then one sign bit per nonzero value
    (value k is bit 3-k of the code's (v, w, x, y) nibble)."""
    codes = HT.COUNT1_TABLES[sel]
    for w10 in range(1024):
        (v, ln), = [(v, ln) for v, (ln, c) in codes.items()
                    if w10 >> (10 - ln) == c]
        want_signs, o = 0, ln
        for k in range(4):
            if (v >> (3 - k)) & 1:
                want_signs |= (1 | (((w10 >> (9 - o)) & 1) << 1)) << (2 * k)
                o += 1
        e = int(HD._C1_LUT[sel, w10])
        assert (e >> 8, e & 0xFF) == (o, want_signs), w10


def test_table_sizes_are_what_the_cuda_source_assumes():
    k = _cu_constants("mp3_entropy.cu")
    assert k["kC1Entries"] == HD._C1_LUT.size == 2048
    assert k["kL1Bits"] == HD.L1_BITS
    assert k["kSubFlag"] == HD.SUB_FLAG
    assert k["kLevel1Entries"] == HD._L1_ENTRIES == 10248
    assert k["kTableEntries"] == HD._LUT2.size == 11440
    assert HD._LUT2.dtype == np.uint16 and HD._LUT2.nbytes == 22880
    assert HD._LUT2.nbytes % 16 == 0  # the kernel copies 16-byte words
    tb = HD.device_tables("cpu")
    assert tb["lut2"].dtype == torch.int16 and tb["lut2"].numel() == 11440
    # each first level holds 2^min(width, 10) entries
    widths = [int(HD._BIG_WIDTH[t]) for t in sorted(HT.BIG_TABLES)]
    assert sum(1 << min(w, HD.L1_BITS) for w in widths) == HD._L1_ENTRIES


def _unfold(nf: np.ndarray) -> np.ndarray:
    """SYNTH_N [64, 32] rebuilt from the folded matrix by the kernel's row
    map: which folded row each of the 64 rows is, with which sign; row 48
    is the all -1 row (B16), row 16 is zero."""
    half = np.zeros((64, 16), np.float32)
    row_of = {int(r): i for i, r in enumerate(SK.FOLD_ROWS)}
    for n in range(64):
        if n in row_of:
            half[n] = nf[row_of[n]]
        elif 17 <= n <= 31:
            half[n] = -nf[row_of[32 - n]]
        elif 49 <= n <= 63:
            half[n] = nf[row_of[96 - n]]
        elif n == 48:
            half[n] = -1.0
    parity = np.where(np.arange(64) % 2 == 0, 1.0, -1.0).astype(np.float32)
    return np.concatenate([half, parity[:, None] * half[:, ::-1]], axis=1)


def test_folded_rows_rebuild_synth_n():
    n = np.asarray(JT.SYNTH_N, np.float32)
    got = _unfold(SK.fold_synth_n(n))
    rows = np.r_[0:16, 17:64]
    np.testing.assert_array_equal(got[rows], n[rows])
    assert np.abs(n[16]).max() < 1e-14 and not got[16].any()


def test_fold_refuses_a_matrix_without_the_symmetry():
    n = np.asarray(JT.SYNTH_N, np.float32).copy()
    SK.fold_synth_n(n)
    n[40, 3] += 1e-3
    with pytest.raises(ValueError, match="symmetry"):
        SK.fold_synth_n(n)
    with pytest.raises(ValueError, match="64, 32"):
        SK.fold_synth_n(n[:32])


def _folded_synthesis(ts: torch.Tensor, nf: torch.Tensor, g2: torch.Tensor):
    """The kernel's arithmetic in plain torch: S/D over mirrored k, the 32
    folded dot products and B16 = -sum(S), then the FIR on the folded
    columns, each feeding outputs m and 32 - m (0 and 16 for m = 0)."""
    T = ts.shape[1]
    s = ts[..., :16] + ts[..., 16:].flip(-1)
    d = ts[..., :16] - ts[..., 16:].flip(-1)
    even = torch.einsum("btk,rk->btr", s, nf[:16])   # A0,A2..A14,B0..B14
    odd = torch.einsum("btk,rk->btr", d, nf[16:])    # A1..A15,B1..B15
    a = torch.zeros(ts.shape[:2] + (16,))
    b = torch.zeros(ts.shape[:2] + (17,))
    a[..., 0::2], b[..., 0:16:2] = even[..., :8], even[..., 8:]
    a[..., 1::2], b[..., 1:16:2] = odd[..., :8], odd[..., 8:]
    b[..., 16] = -s.sum(-1)
    a = torch.nn.functional.pad(a, (0, 0, 15, 0))    # zero history
    b = torch.nn.functional.pad(b, (0, 0, 15, 0))
    m = torch.arange(1, 16)
    out = torch.zeros(ts.shape)
    for k in range(16):
        va, vb = a[:, 15 - k:15 - k + T], b[:, 15 - k:15 - k + T]
        if k % 2 == 0:
            out[..., 0] += g2[k, 0] * va[..., 0]
            out[..., m] += g2[k, m] * va[..., m]
            out[..., 32 - m] -= g2[k, 32 - m] * va[..., m]
        else:
            out[..., 0] += g2[k, 0] * vb[..., 0]
            out[..., 16] += g2[k, 16] * vb[..., 16]
            out[..., m] += g2[k, m] * vb[..., m]
            out[..., 32 - m] += g2[k, 32 - m] * vb[..., m]
    return out


@pytest.mark.parametrize("T", [1, 16, 17, 40])
def test_folded_synthesis_matches_plain(T):
    rng = np.random.default_rng(T)
    ts = torch.as_tensor((0.05 * rng.standard_normal((3, T, 32))).astype(np.float32))
    c = PD._consts("cpu")
    nf = torch.as_tensor(SK.fold_synth_n(c["synth_n"].numpy()))
    got = _folded_synthesis(ts, nf, c["g2"])
    ref = SK.synthesis_plain(ts, c["synth_n"], c["g2"])
    assert T < 16 or float(ref.abs().max()) > 0.3
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_folded_synthesis_matches_the_pallas_kernel():
    rng = np.random.default_rng(21)
    ts = (0.3 * rng.standard_normal((2, TILE_T, 32))).astype(np.float32)
    want = polyphase_synthesis_pallas(
        jnp.asarray(ts), jnp.asarray(JT.SYNTH_N, jnp.float32),
        jnp.asarray(JG2, jnp.float32), interpret=True)
    nf = torch.as_tensor(SK.fold_synth_n(np.asarray(JT.SYNTH_N, np.float32)))
    got = _folded_synthesis(torch.as_tensor(ts), nf,
                            torch.as_tensor(np.asarray(JG2, np.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)

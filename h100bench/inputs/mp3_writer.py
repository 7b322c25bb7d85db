"""A vectorised NumPy MPEG-1 Layer III writer for the benchmark's corpora.

Written from ISO/IEC 11172-3: the analysis filterbank and MDCT of its
Annex C, the bitstream of clause 2.4.  It has no psychoacoustic model:
long blocks only, every scalefactor 0, one global gain per granule (both
channels), the smallest that lets the granule's Huffman bits fit its half
of the frame at the stream's constant bitrate.  Joint stereo, with M/S in
each frame whose side signal is the weaker, no intensity stereo, no bit
reservoir (``main_data_begin`` 0) and no CRC, so each frame's main data is
its own.  Per region the Huffman table that takes the fewest bits is used,
and count1 table A or B likewise.  Every frame of a stream is analysed and
packed at once, as arrays.

The tables are the reference decoder's copy of the standard's
(``reference/mp3_tables``).  Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np

from ..reference import mp3_tables as T

FRAME = 1152
RATE = 44100
_BR_INDEX = {int(k): i + 1 for i, k in enumerate(T.BITRATE_KBPS[:, 2])}
_SFB = T.SFB_LONG[RATE]
REGION0_COUNT, REGION1_COUNT = 7, 7
_R1 = int(_SFB[REGION0_COUNT + 1]) // 2                      # first pair of region 1
_R2 = int(_SFB[REGION0_COUNT + REGION1_COUNT + 2]) // 2      # first pair of region 2
MAX_IX = 15 + (1 << 13) - 1

# --- Huffman tables as arrays ----------------------------------------------------

_TIDS = sorted(T.BIG_TABLES)                        # the 15 code tables
#: code lengths by pair index x * 16 + y; index 256 (a pair past the big
#: values) costs nothing, a pair a table cannot code costs 2^20
_LEN = np.full((len(_TIDS), 257), 1 << 20, np.int64)
_LEN[:, 256] = 0
_CODE = np.zeros((len(_TIDS), 257), np.int64)
for _j, _t in enumerate(_TIDS):
    for (_x, _y), (_l, _c) in T.BIG_TABLES[_t].items():
        _LEN[_j, _x * 16 + _y], _CODE[_j, _x * 16 + _y] = _l, _c
_MAXV = np.array([max(max(x, y) for x, y in T.BIG_TABLES[t]) for t in _TIDS])

# every table_select but 0, 4 and 14: (row of _LEN, linbits, largest value)
_SELECTS = [s for s in range(1, 32) if T.TABLE_INFO[s][0] > 0]
_SEL_ROW = np.array([_TIDS.index(T.TABLE_INFO[s][0]) for s in _SELECTS])
_SEL_LIN = np.array([T.TABLE_INFO[s][1] for s in _SELECTS])
_SEL_MAX = np.where(_SEL_LIN > 0, 15 + (1 << _SEL_LIN) - 1, _MAXV[_SEL_ROW])
_SEL = np.array(_SELECTS)

_C1_LEN = np.array([[T.COUNT1_TABLES[s][v][0] for v in range(16)] for s in (0, 1)])
_C1_CODE = np.array([[T.COUNT1_TABLES[s][v][1] for v in range(16)] for s in (0, 1)])

# --- analysis -----------------------------------------------------------------------

#: analysis window C (ISO Table 3-C.1) is the synthesis window D over 32,
#: here reversed into time order over the last 512 samples, in 8 rows of
#: 64; the matrixing M[k, i] = cos((2k + 1)(i - 16) π / 64) likewise
_C_ROWS = (T.SYNTH_D / 32.0)[::-1].reshape(8, 64)
_M_REV = np.cos((2 * np.arange(32)[None, :] + 1) * (47 - np.arange(64)[:, None]) * np.pi / 64)
_I36, _K18 = np.arange(36), np.arange(18)
#: windowed MDCT of a normal long block, scaled so the decoder's IMDCT
#: and overlap-add give the subband samples back
_MDCT = (np.sin(np.pi / 36 * (_I36 + 0.5))[:, None]
         * np.cos(np.pi / 72 * (2 * _I36[:, None] + 1 + 18) * (2 * _K18[None, :] + 1))) / 9.0


def analysis(x: np.ndarray) -> np.ndarray:
    """Polyphase analysis of one channel: samples [n] (n a multiple of 32)
    → subband samples [n / 32, 32]."""
    xp = np.concatenate([np.zeros(480), x])
    win = np.lib.stride_tricks.sliding_window_view(xp, 512)[::32].reshape(-1, 8, 64)
    return np.einsum("tba,ba->ta", win, _C_ROWS) @ _M_REV


def mdct(sub: np.ndarray) -> np.ndarray:
    """Subband samples [18 g, 32] → the spectra of g granules [g, 576],
    after the frequency inversion and the encoder's alias reduction."""
    s = sub.copy()
    s[1::2, 1::2] *= -1.0
    g = len(s) // 18
    cur = s.reshape(g, 18, 32).transpose(0, 2, 1)                  # [g, 32, 18]
    prev = np.concatenate([np.zeros((1, 32, 18)), cur[:-1]])
    z = np.concatenate([prev, cur], axis=2).reshape(g * 32, 36)
    X = (z @ _MDCT).reshape(g, 32, 18)
    a, b = X[:, :31, 17:9:-1].copy(), X[:, 1:, :8].copy()
    X[:, :31, 17:9:-1] = a * T.AA_CS + b * T.AA_CA
    X[:, 1:, :8] = b * T.AA_CS - a * T.AA_CA
    return X.reshape(g, 576)


# --- quantisation and bit counts -------------------------------------------------


def _quantize(xr34: np.ndarray, gain: np.ndarray) -> np.ndarray:
    """|xr|^(3/4) [G, 576] at global gains [G] → |ix|, rounded as LAME does."""
    scale = 2.0 ** (-0.1875 * (gain.astype(np.float64) - 210))
    return np.floor(xr34 * scale[:, None] + 0.4054).astype(np.int64)


def _layout(ix: np.ndarray):
    """(count1 start c, zero start z) per row of |ix| [G, 576]: lines
    [0, c) are big values, [c, z) count1 quads of values <= 1."""
    n = ix.shape[1]
    nz = ix > 0
    last = np.where(nz.any(1), n - 1 - np.argmax(nz[:, ::-1], axis=1), -1)
    z = (last + 2) // 2 * 2
    big = (ix > 1) & (np.arange(n)[None, :] < z[:, None])
    q = np.where(big.any(1), n - 1 - np.argmax(big[:, ::-1], axis=1), -1)
    c = z - 4 * ((z - (q + 1)) // 4)
    return c, z


def _choose(m, e, bits_by_row):
    """The table_select with the fewest bits for regions of largest value
    ``m``, ``e`` escapes and per-table code bits [15, G]: (select, bits)."""
    cost = bits_by_row[_SEL_ROW] + _SEL_LIN[:, None] * e[None, :]
    cost = np.where(_SEL_MAX[:, None] >= m[None, :], cost, np.iinfo(np.int64).max // 4)
    best = np.argmin(cost, axis=0)
    sel = np.where(m > 0, _SEL[best], 0)
    return sel, np.where(m > 0, cost[best, np.arange(len(m))], 0)


def _count1(ix: np.ndarray, c: np.ndarray, z: np.ndarray):
    """The count1 quads: (values [G, 144] of 4 bits, live mask)."""
    j = np.arange(144)[None, :]
    live = j < ((z - c) // 4)[:, None]
    base = np.minimum(c[:, None] + 4 * j, 572)
    v = np.zeros((len(ix), 144), np.int64)
    for k in range(4):
        v = (v << 1) | np.take_along_axis(ix, base + k, axis=1)
    return np.where(live, v, 0), live


_REGION_OF_PAIR = (np.arange(288) >= _R1).astype(np.int64) + (np.arange(288) >= _R2)


def bits(ix: np.ndarray):
    """Huffman bits of each row of |ix| [G, 576] with the best tables, and
    what packing needs."""
    G = len(ix)
    c, z = _layout(ix)
    pairs = ix.reshape(G, 288, 2)
    live = np.arange(288)[None, :] < (c // 2)[:, None]
    pidx = np.where(live, np.minimum(pairs[..., 0], 15) * 16 + np.minimum(pairs[..., 1], 15),
                    256)
    # each region's count of every pair index, then its bits under every table
    slot = (np.arange(G)[:, None] * 3 + _REGION_OF_PAIR[None, :]) * 257 + pidx
    hist = np.bincount(slot.reshape(-1), minlength=G * 3 * 257).reshape(G, 3, 257)
    by_table = (hist.astype(np.float64) @ _LEN.T.astype(np.float64)).astype(np.int64)
    esc = np.where(live, (pairs[..., 0] >= 15).astype(np.int64) + (pairs[..., 1] >= 15), 0)
    pmax = np.where(live, pairs.max(2), 0)
    sels, total = [], np.zeros(G, np.int64)
    for r, (lo, hi) in enumerate(((0, _R1), (_R1, _R2), (_R2, 288))):
        s, n = _choose(pmax[:, lo:hi].max(1), esc[:, lo:hi].sum(1), by_table[:, r].T)
        sels.append(s)
        total += n
    quads, qlive = _count1(ix, c, z)
    c1 = [np.where(qlive, _C1_LEN[s][quads], 0).sum(1) for s in (0, 1)]
    c1sel = (c1[1] < c1[0]).astype(np.int64)
    total += np.minimum(c1[0], c1[1])
    total += ((ix > 0) & (np.arange(576)[None, :] < z[:, None])).sum(1)   # signs
    return total, dict(c=c, sels=np.stack(sels, 1), c1sel=c1sel, quads=quads, qlive=qlive,
                       pidx=pidx)


def _fit_gains(xr34: np.ndarray, budget: np.ndarray) -> np.ndarray:
    """Per granule ([F, 2]) of spectra [F, 2, 2, 576]: the smallest global
    gain at which both channels' bits fit the budget, by bisection."""
    F = xr34.shape[0]
    flat = xr34.reshape(F * 4, 576)
    lo = np.full((F, 2), -1, np.int64)
    hi = np.full((F, 2), 255, np.int64)
    for _ in range(8):
        mid = (lo + hi) // 2
        g = np.repeat(mid.reshape(-1), 2)
        ix = _quantize(flat, g)
        n, _ = bits(ix)
        ok = (n.reshape(F, 2, 2).sum(2) <= budget) & (ix.max(1).reshape(F, 2, 2).max(2) <= MAX_IX)
        hi = np.where(ok, mid, hi)
        lo = np.where(ok, lo, mid)
    return hi


# --- the bitstream -----------------------------------------------------------------


def _write_bits(total: int, pos, val, ln) -> bytes:
    keep = ln > 0
    pos, val, ln = pos[keep], val[keep], ln[keep]
    rep = np.repeat(np.arange(len(ln)), ln)
    k = np.arange(rep.size) - np.repeat(np.cumsum(ln) - ln, ln)
    out = np.zeros(total, np.uint8)
    out[pos[rep] + k] = (val[rep] >> (ln[rep] - 1 - k)) & 1
    return np.packbits(out).tobytes()


def frame_lengths(n_frames: int, kbps: int) -> np.ndarray:
    """Byte length of each frame at a constant bitrate (padding as the
    standard's running remainder gives it)."""
    f = np.arange(n_frames + 1, dtype=np.int64)
    total = (f * 144 * kbps * 1000) // RATE
    return np.diff(total)


def encode(pcm: np.ndarray, kbps: int) -> tuple[bytes, np.ndarray]:
    """Stereo float PCM [n, 2] in [-1, 1] at 44.1 kHz → (a Layer III stream
    of ceil(n / 1152) frames, each frame's byte offset)."""
    if kbps not in _BR_INDEX:
        raise ValueError(f"no MPEG-1 Layer III bitrate of {kbps} kbps")
    F = -(-len(pcm) // FRAME)
    x = np.zeros((F * FRAME, 2))
    x[:len(pcm)] = pcm
    spec = np.stack([mdct(analysis(x[:, ch])) for ch in range(2)], axis=1)   # [2F, 2, 576]
    spec = spec.reshape(F, 2, 2, 576)
    mid, side = (spec[:, :, 0] + spec[:, :, 1]) / np.sqrt(2), (spec[:, :, 0] - spec[:, :, 1]) / np.sqrt(2)
    ms = (side ** 2).sum((1, 2)) < 0.5 * (mid ** 2).sum((1, 2))
    spec = np.where(ms[:, None, None, None], np.stack([mid, side], 2), spec)
    flen = frame_lengths(F, kbps)
    main = (flen - 36) * 8
    budget = np.stack([main // 2, main - main // 2], 1)
    xr34 = np.abs(spec) ** 0.75
    gains = _fit_gains(xr34, budget)
    gflat = np.repeat(gains.reshape(-1), 2)
    ix = _quantize(xr34.reshape(-1, 576), gflat)
    n, p = bits(ix)
    if not (n.reshape(F, 2, 2).sum(2) <= budget).all():
        raise AssertionError("a granule overran its bits")
    signs = (spec.reshape(-1, 576) < 0).astype(np.int64)
    G = F * 4

    # big-value pairs: code, linbits x, sign x, linbits y, sign y
    pairs = ix.reshape(G, 288, 2)
    sgn = signs.reshape(G, 288, 2)
    j = np.arange(288)[None, :]
    region = (j >= _R1).astype(np.int64) + (j >= _R2)
    sel = np.take_along_axis(p["sels"], np.broadcast_to(region, (G, 288)), axis=1)
    live = j < (p["c"] // 2)[:, None]
    row = np.array([_TIDS.index(T.TABLE_INFO[s][0]) if T.TABLE_INFO[s][0] > 0 else 0
                    for s in range(32)])[sel]
    lin = np.array([T.TABLE_INFO[s][1] for s in range(32)])[sel]
    code_len = np.where(live & (sel > 0), _LEN[row, p["pidx"]], 0)
    code_val = _CODE[row, p["pidx"]]
    fx, fy = pairs[..., 0], pairs[..., 1]
    big_val = np.stack([code_val, fx - 15, sgn[..., 0], fy - 15, sgn[..., 1]], 2)
    big_len = np.stack([code_len,
                        np.where(live & (fx >= 15), lin, 0),
                        np.where(live & (fx > 0), 1, 0),
                        np.where(live & (fy >= 15), lin, 0),
                        np.where(live & (fy > 0), 1, 0)], 2)
    # count1 quads: code, then a sign per nonzero value
    c1s = p["c1sel"][:, None]
    quads, qlive = p["quads"], p["qlive"]
    qbase = np.minimum(p["c"][:, None] + 4 * np.arange(144)[None, :], 572)
    qs = [np.take_along_axis(signs.reshape(G, 576), qbase + k, axis=1) for k in range(4)]
    qv = [(quads >> (3 - k)) & 1 for k in range(4)]
    q_val = np.stack([_C1_CODE[c1s, quads]] + qs, 2)
    q_len = np.stack([np.where(qlive, _C1_LEN[c1s, quads], 0)]
                     + [np.where(qlive & (v > 0), 1, 0) for v in qv], 2)
    val = np.concatenate([big_val, q_val], 1).reshape(G, -1)
    ln = np.concatenate([big_len, q_len], 1).reshape(G, -1)
    p23 = ln.sum(1)
    if not np.array_equal(p23, n):
        raise AssertionError("bit count and packing disagree")

    fstart = np.concatenate([[0], np.cumsum(flen)[:-1]]) * 8
    # main data: the four granule-channels of a frame back to back, from bit 288
    gc_off = np.concatenate([[0], np.cumsum(p23)[:-1]]).reshape(F, 4)
    gc_off = gc_off - gc_off[:, :1] + fstart[:, None] + 288
    within = np.cumsum(ln, 1) - ln
    m_pos = (gc_off.reshape(G, 1) + within).reshape(-1)

    # header and side info
    pad = flen - (144 * kbps * 1000) // RATE
    hdr = (0xFFFB << 16) | (_BR_INDEX[kbps] << 12) | (0 << 10) | (pad << 9) \
        | (1 << 6) | (np.where(ms, 2, 0) << 4) | (1 << 2)
    si_val = [hdr, np.zeros(F, np.int64)]
    si_len = [32, 20]
    big_values = (p["c"] // 2).reshape(F, 4)
    sels = p["sels"].reshape(F, 4, 3)
    c1sel = p["c1sel"].reshape(F, 4)
    for k in range(4):
        for v, ln_ in ((p23.reshape(F, 4)[:, k], 12), (big_values[:, k], 9),
                       (gflat.reshape(F, 4)[:, k], 8), (0, 4), (0, 1),
                       (sels[:, k, 0], 5), (sels[:, k, 1], 5), (sels[:, k, 2], 5),
                       (REGION0_COUNT, 4), (REGION1_COUNT, 3), (0, 1), (0, 1),
                       (c1sel[:, k], 1)):
            si_val.append(np.broadcast_to(np.asarray(v, np.int64), (F,)))
            si_len.append(ln_)
    si_len = np.array(si_len)
    h_val = np.stack(si_val, 1)
    h_len = np.broadcast_to(si_len, h_val.shape)
    h_pos = fstart[:, None] + (np.cumsum(si_len) - si_len)[None, :]
    blob = _write_bits(int(flen.sum()) * 8,
                       np.concatenate([h_pos.reshape(-1), m_pos]),
                       np.concatenate([h_val.reshape(-1), val.reshape(-1)]),
                       np.concatenate([h_len.reshape(-1), ln.reshape(-1)]))
    return blob, fstart // 8

"""Lane-parallel MPEG Layer III Huffman decode on torch tensors.

The host walks frames and parses only the fixed-size structures (headers,
side info, scalefactors) and ships the raw concatenated main_data bytes
to the device; the variable-length entropy decode runs here, one lane
per granule-channel.  Every lane's ``[start_bit, end_bit)`` is known from
side info before any entropy decode, so lanes are independent.

Two implementations of the scan compute the same ``(big576, c1, fail)``
triple, bit for bit:

* ``scan_plain`` (below): plain torch ops, a Python loop over pair and
  quad steps vectorised over lanes, with bit windows in int64.  It runs
  for CPU tensors and is the reference the CUDA kernel is held to.
* the CUDA kernel ``csrc/mp3_entropy.cu``, one thread per lane, behind
  the wrapper ``huffman_kernel.entropy_scan``, which runs for CUDA tensors.
  It looks codes up in ``_two_level_big_luts``, the same codes as the flat
  LUT in a form that fits in shared memory.

Both follow the JAX package's XLA scan (``decode_spectra(impl="xla")``):
big-values pairs beyond 288 are decoded for their bit consumption but not
stored; crossing ``end_bit`` during big-values or ``limit_bit`` during
count1 fails the lane; a count1 quad that straddles ``end_bit`` is
dropped; count1 decodes at most ``ceil(n_c1/32)*32`` quads, capped at 144.
``_assemble`` then places the lines in final order on either path.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.bytes import peek32
from ...utils.trace import to_device
from . import huffman_tables as HT
from . import tables as T

# ---------------------------------------------------------------------------
# Constant tables
# ---------------------------------------------------------------------------


def _flat_big_luts():
    """Concatenate per-table prefix LUTs: entry = len<<8 | x<<4 | y."""
    ids = sorted(HT.BIG_TABLES)
    base = np.zeros(33, np.int32)  # indexed by table id (0..24 used)
    width = np.zeros(33, np.int32)
    chunks = [np.zeros(1, np.uint16)]  # slot 0: safe row for tid==0
    off = 1
    for t in ids:
        codes = HT.BIG_TABLES[t]
        maxlen = max(l for (l, _c) in codes.values())
        lut = np.zeros(1 << maxlen, np.uint16)
        for (x, y), (length, code) in codes.items():
            lo = code << (maxlen - length)
            hi = (code + 1) << (maxlen - length)
            lut[lo:hi] = (length << 8) | (x << 4) | y
        base[t] = off
        width[t] = maxlen
        chunks.append(lut)
        off += lut.size
    return np.concatenate(chunks), base, width


_BIGLUT, _BIG_BASE, _BIG_WIDTH = _flat_big_luts()

#: bits of the CUDA kernel's first-level lookup (csrc/mp3_entropy.cu kL1Bits)
L1_BITS = 10
#: a first-level entry with this bit set points into the second level
SUB_FLAG = 0x8000


def _two_level_big_luts():
    """The big-values tables as two lookup levels small enough for shared
    memory (the flat LUT's tables 13 and 16 alone need 2^19 + 2^17 entries).

    Each table gets a first level indexed by its top ``min(width, 10)``
    bits.  An entry is either the flat LUT's ``len<<8 | x<<4 | y`` (0 for a
    bad code) or, where only codes longer than 10 bits start with those 10
    bits, ``SUB_FLAG | offset<<4 | s``: the next ``s`` bits index the
    subtable at ``offset`` in the second level, which follows every first
    level in the returned array.  Returns (u16 table, per-table-id first
    level base, number of first-level entries)."""
    first, second = [], []
    base = np.zeros(33, np.int32)
    n1 = n2 = 0
    for t in sorted(HT.BIG_TABLES):
        codes = HT.BIG_TABLES[t]
        w1 = min(max(ln for (ln, _c) in codes.values()), L1_BITS)
        lvl = np.zeros(1 << w1, np.uint16)
        longer: dict[int, list] = {}
        for (x, y), (ln, code) in codes.items():
            e = (ln << 8) | (x << 4) | y
            if ln <= w1:
                lvl[code << (w1 - ln):(code + 1) << (w1 - ln)] = e
            else:
                rest = ln - w1
                longer.setdefault(code >> rest, []).append(
                    (rest, code & ((1 << rest) - 1), e))
        for prefix, tails in sorted(longer.items()):
            s = max(rest for rest, _c, _e in tails)
            sub = np.zeros(1 << s, np.uint16)
            for rest, code, e in tails:
                sub[code << (s - rest):(code + 1) << (s - rest)] = e
            if s > 15 or n2 >= 1 << 11:
                raise ValueError("second level outgrows its 11-bit offsets")
            lvl[prefix] = SUB_FLAG | (n2 << 4) | s
            second.append(sub)
            n2 += sub.size
        base[t] = n1
        first.append(lvl)
        n1 += lvl.size
    return np.concatenate(first + second), base, n1


_LUT2, _L1_BASE, _L1_ENTRIES = _two_level_big_luts()

_KTID = np.array([max(HT.TABLE_INFO[i][0], 0) for i in range(32)], np.int32)
_KTID_RESERVED = np.array(
    [1 if HT.TABLE_INFO[i][0] < 0 else 0 for i in range(32)], np.int32
)
_KLIN = np.array([HT.TABLE_INFO[i][1] for i in range(32)], np.int32)


def _c1_canonical_consts():
    """Count1 threshold-decode constants from COUNT1_TABLES.

    Both count1 trees are complete and threshold-decodable: at every
    depth the still-incomplete prefixes form one value interval strictly
    below the finished codes (checked here), so a quad's (length, value)
    follows from a few compares on the next 6 bits.  Select B is the
    degenerate case: every code is 4 bits with ``v = ~code & 15``.
    Select A's per-length value maps are packed as nibble strings indexed
    by the code's rank above the length's first code.

    Returns (lo4, lo5, nib4, nib5, nib6)."""
    codes = HT.COUNT1_TABLES[0]
    bylen: dict[int, list] = {}
    for v, (ln, c) in codes.items():
        bylen.setdefault(ln, []).append((c, v))
    if sorted(bylen) != [1, 4, 5, 6] or bylen[1] != [(1, 0)]:
        raise ValueError("count1 table A is not the ISO tree")
    packs = {}
    los = {}
    for ln in (4, 5, 6):
        ent = sorted(bylen[ln])
        cs = [c for c, _ in ent]
        if cs != list(range(cs[0], cs[0] + len(cs))):
            raise ValueError("count1 table A is not canonical")
        los[ln] = cs[0]
        packs[ln] = sum(v << (4 * r) for r, (_c, v) in enumerate(ent))
    # completeness / threshold checks: len-4 codes sit at [lo4, 8) under
    # the len-1 code's half, len-5 at [lo5, 2*lo4), len-6 at [0, 2*lo5)
    if not (los[4] + len(bylen[4]) == 8
            and los[5] + len(bylen[5]) == 2 * los[4]
            and len(bylen[6]) == 2 * los[5]):
        raise ValueError("count1 table A is not threshold-decodable")
    return los[4], los[5], packs[4], packs[5], packs[6]


_C1_LO4, _C1_LO5, _C1_NIB4, _C1_NIB5, _C1_NIB6 = _c1_canonical_consts()


def _count1_lut() -> np.ndarray:
    """Count1 quads as one lookup per 10-bit window (the longest code plus
    its signs), for the CUDA kernel: u16 [2, 1024] by select, entry =
    ``o<<8 | signs`` where ``o`` is the bits the quad takes and bits 2k and
    2k+1 of ``signs`` say value k is nonzero and negative.  Built by the
    threshold rule the plain scan uses."""
    lut = np.zeros((2, 1024), np.uint16)
    for sel in (0, 1):
        for w10 in range(1024):
            top4 = w10 >> 6
            if sel:
                v, o = (~top4) & 15, 4
            elif w10 >> 9:
                v, o = 0, 1
            elif top4 >= _C1_LO4:
                v, o = (_C1_NIB4 >> (4 * (top4 - _C1_LO4))) & 15, 4
            elif (w10 >> 5) >= _C1_LO5:
                v, o = (_C1_NIB5 >> (4 * ((w10 >> 5) - _C1_LO5))) & 15, 5
            else:
                v, o = (_C1_NIB6 >> (4 * (w10 >> 4))) & 15, 6
            signs = 0
            for k in range(4):
                if (v >> (3 - k)) & 1:
                    signs |= (1 | ((w10 >> (9 - o)) & 1) << 1) << (2 * k)
                    o += 1
            lut[sel, w10] = (o << 8) | signs
    return lut


_C1_LUT = _count1_lut()


def _reorder_perms():
    """Short-block reorder permutations in gather form out = in[perm],
    [9 rates, 3 cfgs, 576]; cfg 0 (long) rows are identity."""
    rates = T.RATE_ORDER
    p = np.tile(np.arange(576, dtype=np.int32), (len(rates), 3, 1))
    for r, sr in enumerate(rates):
        bands = T.SFB_SHORT[sr]
        for cfg, mixed in ((1, 0), (2, 1)):
            for sfb in range(3 if mixed else 0, 13):
                lo, hi = int(bands[sfb]), int(bands[sfb + 1])
                w_ = hi - lo
                base = lo * 3
                for i in range(w_):
                    for w in range(3):
                        p[r, cfg, base + i * 3 + w] = base + w * w_ + i
    return p


_REORDER = _reorder_perms()

_TABLES = {}


def device_tables(device) -> dict:
    """The scan's constant tables as tensors on ``device`` (cached)."""
    device = torch.device(device)
    t = _TABLES.get(device)
    if t is None:
        def put(a, dtype=torch.int32):
            return to_device(np.asarray(a), device, dtype)

        t = dict(
            biglut=put(_BIGLUT.view(np.int16), torch.int16),
            big_base=put(_BIG_BASE),
            lut2=put(_LUT2.view(np.int16), torch.int16),
            l1_base=put(_L1_BASE),
            c1lut=put(_C1_LUT.view(np.int16), torch.int16),
            big_width=put(_BIG_WIDTH),
            ktid=put(_KTID),
            klin=put(_KLIN),
            kres=put(_KTID_RESERVED),
            reorder=put(_REORDER, torch.int64),
        )
        _TABLES[device] = t
    return t


def count1_quads(n_c1: int) -> int:
    """Quads the scan decodes for a static ``n_c1``: whole steps of 32,
    capped at the 144 quads that fit 576 lines."""
    n_c1 = min(max(n_c1, 1), 144)
    return min(-(-n_c1 // 32) * 32, 144)


# ---------------------------------------------------------------------------
# Plain scan (the CUDA kernel's twin)
# ---------------------------------------------------------------------------


def _take(win: torch.Tensor, off, n: torch.Tensor) -> torch.Tensor:
    """n bits (0 <= n, off + n <= 32) at offset off of a 32-bit window."""
    v = (win >> (32 - off - n).clamp(min=0)) & ((1 << n) - 1)
    return torch.where(n > 0, v, torch.zeros_like(v))


def scan_plain(
    main_u8: torch.Tensor,
    file_idx: torch.Tensor,
    start_bit: torch.Tensor,
    end_bit: torch.Tensor,
    limit_bit: torch.Tensor,
    big_values: torch.Tensor,
    region1: torch.Tensor,
    region2: torch.Tensor,
    tsel: torch.Tensor,
    c1sel: torch.Tensor,
    valid: torch.Tensor,
    *,
    n_big: int = 512,
    n_c1: int = 144,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Entropy scan in plain torch ops → (big576 i16 [N, 576],
    c1 i16 [N, 144, 4], fail bool [N]).

    Lane vectors are int ``[N]`` (tsel ``[N, 3]``); main_u8 is u8 ``[B, M]``.
    Pair p of big576 holds lines (2p, 2p+1); quad q of c1 holds the q-th
    count1 quad, not yet moved to its line offset."""
    dev = main_u8.device
    N = start_bit.shape[0]
    i64 = torch.int64
    tb = device_tables(dev)
    n_big = min(max(n_big, 1), 512)
    nq = count1_quads(n_c1)

    fidx = file_idx.to(i64).clamp(0, main_u8.shape[0] - 1)
    ok = valid.to(i64) > 0
    zero = torch.zeros(N, dtype=i64, device=dev)
    pos = torch.where(ok, start_bit.to(i64), zero)
    fail = ~ok
    end = end_bit.to(i64)
    limit = limit_bit.to(i64)
    bv = big_values.to(i64)
    big_pairs = torch.clamp(bv, max=n_big)
    r1 = region1.to(i64)
    r2 = region2.to(i64)
    ts = tsel.to(i64).clamp(0, 31)
    tid = tb["ktid"][ts].to(i64)          # [N, 3] big-table id per region
    res = tb["kres"][ts].to(i64)
    lin = tb["klin"][ts].to(i64)
    kbase = tb["big_base"][tid].to(i64)
    kwidth = tb["big_width"][tid].to(i64)
    biglut = tb["biglut"]

    big = torch.zeros((N, 288, 2), dtype=torch.int16, device=dev)
    n_iter = int(big_pairs.max()) if N else 0
    for p in range(n_iter):
        act = (p < big_pairs) & ~fail
        line = 2 * p
        region = ((line >= r1).to(i64) + (line >= r2).to(i64))[:, None]
        width = kwidth.gather(1, region)[:, 0]
        base = kbase.gather(1, region)[:, 0]
        linb = lin.gather(1, region)[:, 0]
        t_res = res.gather(1, region)[:, 0]
        has = width > 0
        win = peek32(main_u8, fidx, pos)
        idx = torch.where(has, base + (win >> (32 - width.clamp(min=1))), zero)
        entry = biglut[idx].to(i64) & 0xFFFF
        ln = entry >> 8
        bad = act & ((t_res > 0) | (has & (ln == 0)))
        x = (entry >> 4) & 15
        y = entry & 15
        w2 = peek32(main_u8, fidx, pos + torch.where(has, ln, zero))
        o = zero
        xesc = (x == 15) & (linb > 0)
        nx = torch.where(xesc, linb, zero)
        x = x + _take(w2, o, nx)
        o = o + nx
        sx = (x > 0).to(i64)
        x = torch.where(_take(w2, o, sx) == 1, -x, x)
        o = o + sx
        yesc = (y == 15) & (linb > 0)
        ny = torch.where(yesc, linb, zero)
        y = y + _take(w2, o, ny)
        o = o + ny
        sy = (y > 0).to(i64)
        y = torch.where(_take(w2, o, sy) == 1, -y, y)
        o = o + sy
        pos = pos + torch.where(act & has, ln + o, zero)
        fail = fail | bad | (act & (pos > end))
        if p < 288:
            wr = act & ~fail
            big[:, p, 0] = torch.where(wr, x, zero).to(torch.int16)
            big[:, p, 1] = torch.where(wr, y, zero).to(torch.int16)

    idx0 = torch.clamp(2 * bv, max=576)
    sel_b = c1sel.to(i64) > 0
    c1 = torch.zeros((N, 144, 4), dtype=torch.int16, device=dev)
    for q in range(nq):
        act = (pos < end) & (idx0 + 4 * q < 576) & ~fail
        w10 = peek32(main_u8, fidx, pos) >> 22
        top4 = w10 >> 6
        top5 = w10 >> 5
        w6 = w10 >> 4
        is1 = (w10 >> 9) == 1
        is4 = top4 >= _C1_LO4
        is5 = top5 >= _C1_LO5
        v_a = torch.where(
            is1, zero,
            torch.where(
                is4, (_C1_NIB4 >> (4 * (top4 - _C1_LO4)).clamp(min=0)) & 15,
                torch.where(is5,
                            (_C1_NIB5 >> (4 * (top5 - _C1_LO5)).clamp(min=0)) & 15,
                            (_C1_NIB6 >> (4 * w6)) & 15)))
        l_a = torch.where(is1, 1, torch.where(is4, 4, torch.where(is5, 5, 6)))
        v = torch.where(sel_b, (~top4) & 15, v_a)
        o = torch.where(sel_b, 4, l_a).to(i64)
        vals = []
        for k in range(4):
            bit = (v >> (3 - k)) & 1
            sgn = (w10 >> (9 - o).clamp(min=0)) & 1
            vals.append(torch.where(bit == 1, 1 - 2 * sgn, zero))
            o = o + bit
        o = torch.where(act, o, zero)
        fail = fail | (act & (pos + o > limit))
        # a quad straddling the part2_3 boundary is discarded
        wr = act & ~fail & (pos + o <= end)
        for k in range(4):
            c1[:, q, k] = torch.where(wr, vals[k], zero).to(torch.int16)
        pos = pos + o
    return big.reshape(N, 576), c1, fail


# ---------------------------------------------------------------------------
# Line assembly and the public entry
# ---------------------------------------------------------------------------


def _assemble(big576, c1_out, big_values, fail, rate_idx, cfg):
    """Stitch big-values pairs + count1 quads into 576 lines, reordered.

    Big pairs are already line-ordered; the count1 block moves to its
    per-lane offset ``2*big_values`` and the short-block reorder applies
    each lane's (rate, cfg) permutation — both as gathers."""
    N = big576.shape[0]
    dev = big576.device
    j = torch.arange(576, device=dev)[None, :]
    bv2 = torch.clamp(2 * big_values.to(torch.int64), max=576)[:, None]
    c1 = c1_out.reshape(N, 576)
    shifted = torch.gather(c1, 1, (j - bv2).clamp(min=0))
    lines = torch.where(j < bv2, big576, shifted)
    lines = torch.where(fail[:, None], torch.zeros_like(lines), lines)
    perm = device_tables(dev)["reorder"][rate_idx.to(torch.int64),
                                         cfg.to(torch.int64)]
    return torch.gather(lines, 1, perm).to(torch.int16), fail


def decode_spectra(
    main_u8: torch.Tensor,
    file_idx: torch.Tensor,
    start_bit: torch.Tensor,
    end_bit: torch.Tensor,
    limit_bit: torch.Tensor,
    big_values: torch.Tensor,
    region1: torch.Tensor,
    region2: torch.Tensor,
    tsel: torch.Tensor,
    c1sel: torch.Tensor,
    valid: torch.Tensor,
    rate_idx: torch.Tensor,
    cfg: torch.Tensor,
    *,
    n_big: int = 512,
    n_c1: int = 144,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode all granule-channel lanes' quantized spectra.

    Args (N = number of lanes = B*G*C):
      main_u8: uint8 [B, M] concatenated main_data streams.
      file_idx: int32 [N] lane → file row.
      start_bit/end_bit: int32 [N] Huffman bit range (post-scalefactors).
      limit_bit: int32 [N] end of readable data for the lane's frame.
      big_values / region1 / region2: int32 [N] (region* = line bounds).
      tsel: int32 [N, 3] table selects; c1sel: int32 [N] count1 select.
      valid: int [N] lane decodable (reservoir present etc).
      rate_idx: int32 [N] sample-rate index; cfg: int32 [N] 0 long, 1
        short, 2 mixed — selects the reorder permutation.

    The scan runs as the CUDA kernel for CUDA tensors and as
    ``scan_plain`` for CPU tensors (huffman_kernel.entropy_scan).

    Returns:
      (lines int16 [N, 576] in final line order, fail bool [N]).
    """
    from .huffman_kernel import entropy_scan

    big576, c1_out, fail = entropy_scan(
        main_u8, file_idx, start_bit, end_bit, limit_bit, big_values,
        region1, region2, tsel, c1sel, valid, n_big=n_big, n_c1=n_c1)
    return _assemble(big576, c1_out, big_values, fail, rate_idx, cfg)

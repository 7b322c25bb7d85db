"""Batched MPEG Layer III DSP on torch tensors.

The decode splits at the entropy boundary: frame sync, side info, the bit
reservoir and scalefactors run on the host front-end (the C++ ``mp3fe``
library); the Huffman scan and everything after it runs here on the
tensors' device:

* requantize: elementwise ``sign(is) * |is|^(4/3) * 2^(exp/4)``;
* stereo: per-line 2x2 mixing (LR / MS / intensity as one multiply-add);
* antialias: the 8 ISO butterflies across all 31 subband boundaries;
* hybrid IMDCT: windowed 36x18 basis products, one per block type;
* overlap-add: granule ``g`` adds granule ``g-1``'s tail (a shift);
* synthesis filterbank: ops/synth_kernel (the CUDA kernel on the GPU).

Every float product runs in full f32: the package pins
``torch.backends.cuda.matmul.allow_tf32 = False`` and float32 matmul
precision "highest" at import (``audio_decoder_tpu_torch/__init__.py``),
the counterpart of the JAX package's ``Precision.HIGHEST``.  The one-hot
band→line selections below are exact only in full f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.trace import span, to_device
from . import tables as T

# ---------------------------------------------------------------------------
# Derived constant tables (host numpy; device copies cached per device)
# ---------------------------------------------------------------------------


def _w_all() -> np.ndarray:
    """[4, 36, 18] windowed IMDCT matrices indexed by block type.

    Index 2 (short) is the composition of the three 12-point IMDCTs with
    their +6/+12 output placement and the window-interleaved input pick:
    raw[6+6w+r] += WIN12[r, j] * X[3j + w]."""
    w = np.zeros((4, 36, 18))
    for bt in (0, 1, 3):
        w[bt] = T.WIN_IMDCT36[bt]
    for win in range(3):
        for r in range(12):
            for j in range(6):
                w[2, 6 + 6 * win + r, 3 * j + win] += T.WIN_IMDCT12[r, j]
    return w


_W_ALL = _w_all()

#: frequency inversion: odd subband, odd time sample → negate
_FREQINV = np.where(
    (np.arange(32)[:, None] % 2 == 1) & (np.arange(18)[None, :] % 2 == 1), -1.0, 1.0
)

#: FIR taps over V-block history: out[t, j] = sum_k _G2[k, j] * V[t-k, half(k)+j]
#: (even lag k=2i reads D[64i+j], odd lag k=2i+1 reads D[64i+32+j])
_G2 = np.stack(
    [
        T.SYNTH_D[64 * (k // 2) + 32 * (k % 2): 64 * (k // 2) + 32 * (k % 2) + 32]
        for k in range(16)
    ]
)


def _line2band() -> np.ndarray:
    """Line → exponent-band slot maps, [9 rates, 3 cfgs, 576] (cfg 0 long,
    1 short, 2 mixed), in final (reordered) line order.  Slot layout per
    granule-channel: 0..21 long sfb, 22 + sfb*3 + w short (sfb, window)."""
    m = np.zeros((len(T.RATE_ORDER), 3, 576), np.int32)
    for r, sr in enumerate(T.RATE_ORDER):
        lb = T.SFB_LONG[sr]
        sb = T.SFB_SHORT[sr]
        for sfb in range(22):
            m[r, 0, lb[sfb]: lb[sfb + 1]] = sfb
        for sfb in range(13):
            lo, hi = int(sb[sfb]), int(sb[sfb + 1])
            w_ = hi - lo
            for w in range(3):
                m[r, 1, lo * 3 + w: lo * 3 + 3 * w_: 3] = 22 + sfb * 3 + w
        # mixed: long sfbs below line 36 (8 MPEG-1 / 6 LSF), short above
        m[r, 2] = m[r, 1]
        for sfb in range(8 if r < 3 else 6):
            m[r, 2, lb[sfb]: lb[sfb + 1]] = sfb
    return m


_LINE2BAND = _line2band()


def _used_slots() -> np.ndarray:
    """[9 rates, 3 cfgs, 61] bool — slots the band→line map can select."""
    u = np.zeros(_LINE2BAND.shape[:2] + (61,), bool)
    for r in range(_LINE2BAND.shape[0]):
        for c in range(3):
            u[r, c, np.unique(_LINE2BAND[r, c])] = True
    return u


_USED_SLOTS = _used_slots()


def _l2b_variants() -> list:
    """Distinct band→line maps as one-hot [61, 576] f32 matrices, each with
    the flat variant ids (rate*3 + cfg) that use it."""
    flat = _LINE2BAND.reshape(-1, 576)
    seen: dict[bytes, list[int]] = {}
    for v in range(flat.shape[0]):
        seen.setdefault(flat[v].tobytes(), []).append(v)
    out = []
    for kb, vs in seen.items():
        l2b = np.frombuffer(kb, dtype=flat.dtype)
        onehot = np.zeros((61, 576), np.float32)
        onehot[l2b, np.arange(576)] = 1.0
        out.append((onehot, vs))
    return out


_L2B_VARIANTS = _l2b_variants()


def _st_lut() -> np.ndarray:
    """Stereo-mode byte → (aL, bL, aR, bR) mixing coefficients; rows:
    0 identity LR, 1 mid/side, 2+k MPEG-1 intensity with is_pos = k,
    18 + scale*32 + k LSF intensity."""
    lut = np.zeros((18 + 64, 4))
    lut[0] = (1.0, 0.0, 0.0, 1.0)
    s = 1.0 / np.sqrt(2.0)
    lut[1] = (s, s, s, -s)
    for k in range(16):
        r = float(T.IS_RATIO[k])
        lut[2 + k] = (r / (1.0 + r), 0.0, 1.0 / (1.0 + r), 0.0)
    for p in range(2):
        fac = T.lsf_is_factors(p)
        for k in range(32):
            lut[18 + p * 32 + k] = (fac[k, 0], 0.0, fac[k, 1], 0.0)
    return lut


_ST_LUT = _st_lut()


def _seg_maps() -> tuple[np.ndarray, np.ndarray]:
    """Reordered-line → (short sfb, window) maps, [9 rates, 576]: line j of
    band sfb (lines [lo*3, hi*3)) belongs to window (j - lo*3) % 3."""
    rates = T.RATE_ORDER
    sfb_map = np.zeros((len(rates), 576), np.int32)
    win_map = np.zeros((len(rates), 576), np.int32)
    for r, sr in enumerate(rates):
        sb = T.SFB_SHORT[sr]
        for sfb in range(13):
            lo3, hi3 = int(sb[sfb]) * 3, int(sb[sfb + 1]) * 3
            for j in range(lo3, hi3):
                sfb_map[r, j] = sfb
                win_map[r, j] = (j - lo3) % 3
    return sfb_map, win_map


_SEG_SFB, _SEG_WIN = _seg_maps()
_LB = np.stack([T.SFB_LONG[sr] for sr in T.RATE_ORDER])  # [9, 23]
#: mixed-block long/short boundary line per rate (= 3*short_bands[3])
_MIXED_SPLIT = np.array(
    [int(T.SFB_SHORT[sr][3]) * 3 for sr in T.RATE_ORDER], np.int32
)

_DEV_CONSTS: dict = {}


def _consts(device) -> dict:
    """The DSP's constant tables as tensors on ``device`` (cached)."""
    device = torch.device(device)
    c = _DEV_CONSTS.get(device)
    if c is None:
        def f32(a):
            return to_device(np.asarray(a), device, torch.float32)

        c = dict(
            w_all=f32(_W_ALL),
            freqinv=f32(_FREQINV),
            g2=f32(_G2),
            synth_n=f32(T.SYNTH_N),
            st_lut=f32(_ST_LUT),
            aa_cs=f32(T.AA_CS),
            aa_ca=f32(T.AA_CA),
            l2b=[(f32(oh), vs) for oh, vs in _L2B_VARIANTS],
            seg_id=to_device(_SEG_SFB * 3 + _SEG_WIN, device, torch.int64),
            lb=to_device(_LB, device, torch.int64),
        )
        _DEV_CONSTS[device] = c
    return c


def reference_constants() -> dict:
    """The port's constant tables as numpy arrays, under the JAX package's
    names (``_L2B_VARIANTS`` as a list of (onehot, ids) pairs)."""
    from . import huffman_device as HD

    return {
        "SYNTH_N": np.asarray(T.SYNTH_N),
        "_G2": _G2,
        "_W_ALL": _W_ALL,
        "_FREQINV": _FREQINV,
        "_ST_LUT": _ST_LUT,
        "_L2B_VARIANTS": _L2B_VARIANTS,
        "_USED_SLOTS": _USED_SLOTS,
        "_LINE2BAND": _LINE2BAND,
        "_SEG_SFB": _SEG_SFB,
        "_SEG_WIN": _SEG_WIN,
        "_LB": _LB,
        "_MIXED_SPLIT": _MIXED_SPLIT,
        "_REORDER": HD._REORDER,
        "_BIGLUT": HD._BIGLUT,
        "_BIG_BASE": HD._BIG_BASE,
        "_BIG_WIDTH": HD._BIG_WIDTH,
        "_KTID": HD._KTID,
        "_KLIN": HD._KLIN,
        "_KTID_RESERVED": HD._KTID_RESERVED,
        "_C1_LO4": HD._C1_LO4,
        "_C1_LO5": HD._C1_LO5,
        "_C1_NIB4": HD._C1_NIB4,
        "_C1_NIB5": HD._C1_NIB5,
        "_C1_NIB6": HD._C1_NIB6,
    }


# ---------------------------------------------------------------------------
# The DSP tail
# ---------------------------------------------------------------------------


def mp3_dsp_tail(
    is_q: torch.Tensor,
    exp_b: torch.Tensor,
    st_mode: torch.Tensor | None,
    blockcfg: torch.Tensor,
    rate_idx: torch.Tensor,
    *,
    channels: int,
    joint_stereo: bool,
) -> torch.Tensor:
    """Quantized spectra → PCM, batch-parallel.

    Args:
      is_q: int16 ``[B, G*C, 576]`` signed quantized spectrum, in final
        line order (short-block reorder applied), linbits folded.
      exp_b: int16 ``[B, G*C*61]`` 4x requantizer exponent per band slot.
      st_mode: int8 ``[B, G*576]`` per-line stereo mode byte, or None.
      blockcfg: int8 ``[B, G*C]`` block_type | mixed<<2.
      rate_idx: int ``[B]`` sample-rate index (tables.RATE_ORDER).
      channels: channel count C.

    Returns:
      f32 flat interleaved PCM ``[B, G*576*C]``.
    """
    B = is_q.shape[0]
    C = channels
    G = is_q.shape[1] // C
    is_q = is_q.reshape(B, G, C, 576)
    exp_b = exp_b.reshape(B, G, C, 61)
    blockcfg = blockcfg.reshape(B, G, C)

    dev = is_q.device
    cfg, win_idx, aa_bound = _expand_blockcfg(blockcfg)
    with span("mp3.requantize", dev):
        x = _requantize(is_q, exp_b, cfg, rate_idx)
    if C == 2 and joint_stereo and st_mode is not None:
        with span("mp3.stereo", dev):
            st = _consts(dev)["st_lut"][st_mode.reshape(B, G, 576).to(torch.int64)]
            x = _apply_stereo_coeffs(x, st)
    return _hybrid_synthesis(x, win_idx, aa_bound)


def _expand_blockcfg(blockcfg: torch.Tensor):
    """block_type | mixed<<2 → (cfg id, IMDCT window selects, AA bounds)."""
    bc = blockcfg.to(torch.int64)
    block_type = bc & 3
    mixed = bc >> 2
    short = block_type == 2
    cfg = torch.where(short, torch.where(mixed == 1, 2, 1), 0)  # [B,G,C]
    sb_iota = torch.arange(32, device=bc.device)
    win_idx = torch.where(
        short[..., None],
        torch.where((mixed[..., None] == 1) & (sb_iota < 2), 0, 2),
        block_type[..., None],
    )  # [B,G,C,32]
    aa_bound = torch.where(short, mixed, 31)  # [B,G,C]
    return cfg, win_idx, aa_bound


def _variant_mask(key: torch.Tensor, vs) -> torch.Tensor:
    """True where ``key`` (flat rate*3+cfg ids) matches any id in ``vs``."""
    m = torch.zeros_like(key, dtype=torch.bool)
    for v in vs:
        m = m | (key == v)
    return m


def _band_to_lines(slot_vals, cfg, rate_idx):
    """Expand per-band-slot values [..., 61] to per-line values [..., 576]
    by a product with each distinct constant one-hot map plus a masked
    select over the (rate, cfg) variants present; exact in full f32."""
    key = rate_idx.to(torch.int64)[:, None, None] * 3 + cfg  # [B,G,C]
    sv = slot_vals.to(torch.float32)
    out = torch.zeros(sv.shape[:-1] + (576,), dtype=torch.float32,
                      device=sv.device)
    for onehot, vs in _consts(sv.device)["l2b"]:
        out = torch.where(_variant_mask(key, vs)[..., None],
                          torch.matmul(sv, onehot), out)
    return out


def _requantize(is_q, exp_b, cfg, rate_idx):
    """sign(is) * |is|^(4/3) * 2^(exp4/4), exponents expanded per band.

    The per-band gain is computed on the 61 band slots and expanded to
    lines by the exact one-hot selection."""
    f = torch.float32
    # clamp so no (unused, never-selected) slot can produce inf — the
    # one-hot product multiplies unselected slots by 0.0 and 0*inf = NaN
    gain_b = torch.exp2(torch.clamp(exp_b.to(f), -500.0, 500.0) * 0.25)
    gain = _band_to_lines(gain_b, cfg, rate_idx)  # [B,G,C,576]
    mag = torch.abs(is_q).to(f)
    return torch.sign(is_q).to(f) * mag ** (4.0 / 3.0) * gain


def _apply_stereo_coeffs(x, st):
    """[B,G,2,576] spectra × [B,G,576,4] (aL,bL,aR,bR) → 2x2 mixed."""
    x0, x1 = x[:, :, 0], x[:, :, 1]
    L = st[..., 0] * x0 + st[..., 1] * x1
    R = st[..., 2] * x0 + st[..., 3] * x1
    return torch.stack([L, R], dim=2)


#: rows of every IMDCT product call.  cuBLAS picks its SGEMM kernel by the
#: row count, and the kernels round differently (on the H100 a product of
#: fewer than ~3,300 rows differs from a larger one in the last bits), so
#: the product runs in calls of exactly this many rows: a granule's result
#: then never depends on how many granules one call decodes, and a stream's
#: chunk equals the one-shot decode bit for bit.  2^18 is the count whose
#: calls take least time on the 16-file stereo group's 786,432 rows (three
#: calls), and a 512-granule stream chunk pads to it (PERF.md, measured by
#: tools/torch_imdct_rows.py).
_MM_ROWS = 1 << 18


def _fixed_rows_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., K] @ b [K, N]`` in calls of exactly ``_MM_ROWS`` rows (the
    last one zero-padded)."""
    K, N = b.shape
    flat = a.reshape(-1, K)
    n = flat.shape[0]
    out = torch.empty((n, N), dtype=a.dtype, device=a.device)
    full = n - n % _MM_ROWS
    for i in range(0, full, _MM_ROWS):
        torch.mm(flat[i:i + _MM_ROWS], b, out=out[i:i + _MM_ROWS])
    if full < n:
        tail = a.new_zeros((_MM_ROWS, K))
        tail[: n - full] = flat[full:]
        out[full:] = torch.mm(tail, b)[: n - full]
    return out.reshape(*a.shape[:-1], N)


def _hybrid_synthesis(x, win_idx, aa_bound):
    """Antialias → hybrid IMDCT → overlap-add → polyphase synthesis, in the
    spans ``mp3.imdct`` and ``mp3.synth``."""
    with span("mp3.imdct", x.device):
        ts = _hybrid_subbands(x, win_idx, aa_bound)
    with span("mp3.synth", x.device):
        return polyphase_synthesis(ts)


def _hybrid_subbands(x, win_idx, aa_bound):
    """Antialias → hybrid IMDCT → overlap-add: spectra ``[B,G,C,576]`` →
    time-major subband samples ``[B, C, G*18, 32]``."""
    B, G, C, _ = x.shape
    c = _consts(x.device)
    xb = x.reshape(B, G, C, 32, 18)

    # antialias butterflies across subband boundaries (ISO 2.4.3.4.10.1)
    cs, ca = c["aa_cs"], c["aa_ca"]
    a = xb[..., :31, 10:18].flip(-1)  # i ↔ line 18*sb - 1 - i
    b = xb[..., 1:, :8]                # i ↔ line 18*sb + i
    na = a * cs - b * ca
    nb = b * cs + a * ca
    m = (torch.arange(31, device=x.device) < aa_bound[..., None])[..., None]
    xb = xb.clone()
    xb[..., :31, 10:18] = torch.where(m, na, a).flip(-1)
    xb[..., 1:, :8] = torch.where(m, nb, b)

    # hybrid IMDCT: per-block-type windowed basis products, masked + summed
    raw = torch.zeros((B, G, C, 32, 36), dtype=torch.float32, device=x.device)
    for bt in range(4):
        mw = (win_idx == bt)[..., None]
        raw = raw + _fixed_rows_mm(torch.where(mw, xb, 0.0), c["w_all"][bt].t())

    # overlap-add: granule g's head + granule g-1's tail
    prev = torch.cat([torch.zeros_like(raw[:, :1]), raw[:, :-1]], dim=1)
    ts = raw[..., :18] + prev[..., 18:]
    ts = ts * c["freqinv"]

    # time-major [B, C, T, 32], T = G*18 filterbank steps
    return ts.permute(0, 2, 1, 4, 3).reshape(B, C, G * 18, 32)


def polyphase_synthesis(TS: torch.Tensor) -> torch.Tensor:
    """Polyphase synthesis filterbank over every time step at once.

    TS: f32 ``[B, C, T, 32]`` subband samples → flat interleaved PCM
    ``[B, T*32*C]`` (the AudioBatch layout).  The matrixing + FIR run in
    ops/synth_kernel: the CUDA kernel for CUDA tensors, its plain torch
    twin for CPU tensors."""
    from ...ops.synth_kernel import polyphase_synthesis_blocks

    B, C, Tsteps, _ = TS.shape
    c = _consts(TS.device)
    out = polyphase_synthesis_blocks(
        TS.reshape(B * C, Tsteps, 32).contiguous(), c["synth_n"], c["g2"])
    # [B, C, S] → interleave to flat [B, S*C]
    return out.reshape(B, C, Tsteps * 32).transpose(1, 2).reshape(B, -1)


# ---------------------------------------------------------------------------
# On-device stereo-mode derivation (for the fused decode)
# ---------------------------------------------------------------------------


def derive_stereo_coeffs(
    is_r: torch.Tensor,
    st_flags: torch.Tensor,
    sfr_bands: torch.Tensor,
    blockcfg_r: torch.Tensor,
    rate_idx: torch.Tensor,
) -> torch.Tensor:
    """Per-line (aL, bL, aR, bR) stereo coefficients (ISO 2.4.3.4.9),
    derived in band-slot space and then expanded to lines.

    MS over the full spectrum (or below the intensity bound), intensity
    ratio bands above the right channel's zero region, detected per
    window segment for short blocks.  Stereo modes are piecewise-constant
    over scalefactor bands, so the derivation runs on the 61 band slots
    (22 long sfb, then 22 + sfb*3 + w short) and the (rate, cfg) band→line
    map of the right channel picks the family per region (which also
    covers the mixed-block long/short split).

    Args:
      is_r: int ``[B, G, 576]`` right-channel quantized spectrum.
      st_flags: int8 ``[B, G]`` bit0 joint, bit1 ms, bit2 intensity,
        bit3 LSF intensity_scale.
      sfr_bands: int8 ``[B, G, 61]`` right-channel scalefactors.
      blockcfg_r: int8 ``[B, G]`` right channel block_type | mixed<<2.
      rate_idx: int ``[B]``.

    Returns:
      f32 ``[B, G, 576, 4]`` mixing coefficients (the _ST_LUT rows).
    """
    i64 = torch.int64
    f = torch.float32
    dev = is_r.device
    c = _consts(dev)
    B, G, _ = is_r.shape
    flags = st_flags.to(i64)
    joint = (flags & 1) > 0
    ms = (flags & 2) > 0
    inten = (flags & 4) > 0
    base_mode = torch.where(joint & ms, 1, 0)[..., None]  # [B,G,1]

    nz = is_r != 0
    r = rate_idx.to(i64)
    # LSF streams (rate families 1/2) use io^x one-channel scaling rows
    lsf = (r >= 3)[:, None, None]  # [B,1,1]
    is_base = torch.where(lsf, 18 + ((flags >> 3) & 1)[..., None] * 32, 2)
    is_cap = torch.where(lsf, 31, 15)

    def is_mode(is_pos):
        return is_base + torch.minimum(is_pos, is_cap)

    # ---- long slots 0..21: bound past the right channel's last nonzero
    # line; slot 21 has no scalefactor → is_pos 7 (MS/passthrough) ----
    j1 = torch.arange(1, 577, device=dev)
    rzero = torch.where(nz, j1, 0).amax(dim=-1)  # [B,G]
    lb = c["lb"][r]  # [B, 23]
    bound_sfb = 1 + (lb[:, None, 1:22] < rzero[..., None]).to(i64).sum(-1)
    # fully empty right channel: band 0 is intensity too
    bound_sfb = torch.where(rzero == 0, 0, bound_sfb)
    sfb_iota22 = torch.arange(22, device=dev)[None, None, :]
    is_pos_l = torch.where(sfb_iota22 < 21, sfr_bands.to(i64)[..., :22], 7)
    zone_l = sfb_iota22 >= bound_sfb[..., None]
    mode_long = torch.where(
        zone_l,
        torch.where(is_pos_l == 7, base_mode, is_mode(is_pos_l)),
        base_mode,
    )  # [B,G,22]

    # ---- short slots 22 + sfb*3 + w: per-window bound past the window's
    # last nonzero band; segment support reduced by a one-hot product ----
    seg_oh = F.one_hot(c["seg_id"][r], 39).to(f)  # [B,576,39]
    seg_nz = torch.bmm(nz.to(f), seg_oh).reshape(B, G, 13, 3)
    sfb_iota = torch.arange(13, device=dev)[None, None, :, None]
    bound_w = torch.where(seg_nz > 0, sfb_iota + 1, 0).amax(dim=2)  # [B,G,3]
    # sfb 12 transmits no scalefactor: its is_pos reads sfb 11's slots
    sfr_s = sfr_bands.to(i64)[..., 22:]  # [B,G,39]
    is_pos_s = torch.cat([sfr_s[..., :36], sfr_s[..., 33:36]], dim=-1)
    in_zone_s = sfb_iota >= bound_w[:, :, None, :]  # [B,G,13,3]
    mode_short = torch.where(
        in_zone_s.reshape(B, G, 39),
        torch.where(is_pos_s == 7, base_mode, is_mode(is_pos_s)),
        base_mode,
    )  # [B,G,39]

    mode = torch.cat([mode_long, mode_short], dim=-1)  # [B,G,61]
    mode = torch.where(inten[..., None], mode, base_mode)
    mode = torch.where(joint[..., None], mode, 0)

    # slot mode → coefficients (exact one-hot selection), then band→line
    # expansion keyed by the RIGHT channel's block cfg
    moh = F.one_hot(mode, _ST_LUT.shape[0]).to(f)  # [B,G,61,82]
    coeff_slots = torch.matmul(moh, c["st_lut"])  # [B,G,61,4]

    bcr = blockcfg_r.to(i64)
    short_r = (bcr & 3) == 2
    mixed_r = ((bcr >> 2) & 1) > 0
    cfg_r = torch.where(short_r, torch.where(mixed_r, 2, 1), 0)  # [B,G]
    key = r[:, None] * 3 + cfg_r  # [B,G]
    cs_t = coeff_slots.transpose(2, 3)  # [B,G,4,61]
    out = torch.zeros((B, G, 576, 4), dtype=f, device=dev)
    for onehot, vs in c["l2b"]:
        expanded = torch.matmul(cs_t, onehot).transpose(2, 3)  # [B,G,576,4]
        out = torch.where(_variant_mask(key, vs)[..., None, None], expanded, out)
    return out


# ---------------------------------------------------------------------------
# Fused decode: raw main_data bits → PCM
# ---------------------------------------------------------------------------


def compact_lane_wire(start, end, limit, exp_b, blockcfg, rate_idx):
    """Host-side (numpy) wire compaction for ``mp3_decode_fused``.

    Returns (end_rel u16, limit_rel u16, exp_base i16, exp_d u8, ok bool).
    exp_base is the max exponent over the lane's USED band slots (the
    slots the (rate, cfg) band→line map can select, ``_USED_SLOTS``), so
    the uint8 delta is exact for every selectable slot; unselectable
    slots may saturate at 255.  ``ok`` is False for a lane whose used-slot
    range exceeds 255 (impossible for spec-legal streams); the caller
    drops such a lane to the invalid path."""
    st = np.asarray(start, np.int64)
    end_rel = np.clip(np.asarray(end, np.int64) - st, 0, 65535).astype(np.uint16)
    lim_rel = np.clip(np.asarray(limit, np.int64) - st, 0, 65535).astype(np.uint16)
    e = np.asarray(exp_b, np.int32)  # [..., 61]
    bc = np.asarray(blockcfg, np.int32)
    shortb = (bc & 3) == 2
    cfg = np.where(shortb, np.where(((bc >> 2) & 1) == 1, 2, 1), 0)
    rate = np.broadcast_to(
        np.asarray(rate_idx, np.int32).reshape((-1,) + (1,) * (cfg.ndim - 1)),
        cfg.shape,
    )
    used = _USED_SLOTS[rate, cfg]  # [..., 61]
    base = np.where(used, e, -(1 << 30)).max(axis=-1).astype(np.int16)
    dr = base[..., None].astype(np.int32) - e
    ok = ~np.any((dr > 255) & used, axis=-1)
    return end_rel, lim_rel, base, np.clip(dr, 0, 255).astype(np.uint8), ok


def fused_subband_samples(
    main_u8: torch.Tensor,
    start_bit: torch.Tensor,
    end_rel: torch.Tensor,
    limit_rel: torch.Tensor,
    big_values: torch.Tensor,
    region1: torch.Tensor,
    region2: torch.Tensor,
    tsel: torch.Tensor,
    c1sel: torch.Tensor,
    valid: torch.Tensor,
    exp_base: torch.Tensor,
    exp_d: torch.Tensor,
    blockcfg: torch.Tensor,
    st_flags: torch.Tensor,
    sfr_bands: torch.Tensor,
    rate_idx: torch.Tensor,
    perm: torch.Tensor | None = None,
    *,
    channels: int,
    joint_stereo: bool,
    n_big: int = 512,
    n_c1: int = 144,
    granules_per_frame: int = 2,
    buckets: tuple | None = None,
) -> torch.Tensor:
    """Raw concatenated main_data + per-lane side metadata → PCM.

    The whole Layer III decode below the frame/scalefactor layer runs on
    the tensors' device: the lane-parallel Huffman scan
    (huffman_device.decode_spectra), band exponent expansion, stereo
    derivation, antialias, hybrid IMDCT and the polyphase synthesis.

    Lane array shapes are flat ``[B, G*C]`` (tsel ``[B, G*C*3]``);
    exp_d is ``[B, G*C*61]``, st_flags ``[B, G]``, sfr ``[B, G*61]``.
    ``end_rel``/``limit_rel`` are offsets from start_bit and band
    exponents arrive as a per-lane ``exp_base`` minus an ``exp_d`` delta
    (``compact_lane_wire``).

    Lane bucketing: the host may pass ``perm`` (a lane sort by descending
    big_values) plus ``buckets``, a tuple of (lane_count, n_big, n_c1)
    covering the permuted lanes in order; each bucket runs its own scan
    lengths and one row scatter restores lane order
    (decoder._plan_buckets).  Without ``buckets``, one scan of
    ``n_big``/``n_c1`` covers all lanes.

    Returns the f32 subband samples ``[B, C, G*18, 32]`` that
    ``polyphase_synthesis`` turns into PCM (``mp3_decode_fused``).
    """
    i32 = torch.int32
    dev = main_u8.device
    B = start_bit.shape[0]
    C = channels
    G = start_bit.shape[1] // C
    N = B * G * C

    blockcfg_ = blockcfg.reshape(B, G, C)
    cfg, win_idx, aa_bound = _expand_blockcfg(blockcfg_)
    if buckets is None:
        buckets = ((N, n_big, n_c1),)
    with span("mp3.entropy", dev):
        lane_args = wire_lane_args(start_bit, end_rel, limit_rel, big_values,
                                   region1, region2, tsel, c1sel, valid,
                                   rate_idx, cfg)
        lines, fail = decode_buckets(main_u8, lane_args, perm, buckets)
        # an entropy failure silences the whole frame (2 granules for
        # MPEG-1, 1 for LSF); failed-but-invalid lanes are already zero
        gpf = granules_per_frame
        fail_real = fail & (valid.reshape(N) > 0)
        fail_f = fail_real.reshape(B, G // gpf, gpf * C).any(dim=-1)
        fail_g = fail_f.repeat_interleave(gpf, dim=1)  # [B, G]
        is_q = torch.where(fail_g[..., None, None],
                           torch.zeros((), dtype=lines.dtype, device=dev),
                           lines.reshape(B, G, C, 576))

    with span("mp3.requantize", dev):
        exp_b = (
            exp_base.reshape(B, G, C, 1).to(i32)
            - exp_d.reshape(B, G, C, 61).to(i32)
        ).to(torch.int16)
        x = _requantize(is_q, exp_b, cfg, rate_idx)
    if C == 2 and joint_stereo:
        with span("mp3.stereo", dev):
            st = derive_stereo_coeffs(
                is_q[:, :, 1], st_flags, sfr_bands.reshape(B, G, 61),
                blockcfg_[:, :, 1], rate_idx,
            )
            x = _apply_stereo_coeffs(x, st)
    with span("mp3.imdct", dev):
        return _hybrid_subbands(x, win_idx, aa_bound)


def wire_lane_args(start_bit, end_rel, limit_rel, big_values, region1,
                   region2, tsel, c1sel, valid, rate_idx, cfg) -> list:
    """The wire's ``[B, G*C]`` lane arrays (and per-file ``rate_idx``, the
    ``[B, G, C]`` block cfg) → decode_spectra's int32 ``[N]`` lane tensors,
    file_idx first and cfg last, with absolute bit positions."""
    i32 = torch.int32
    B, L = start_bit.shape
    N = B * L
    start_i = start_bit.reshape(N).to(i32)
    return [
        torch.arange(B, dtype=i32, device=start_bit.device).repeat_interleave(L),
        start_i,
        start_i + end_rel.reshape(N).to(i32),
        start_i + limit_rel.reshape(N).to(i32),
        big_values.reshape(N).to(i32),
        region1.reshape(N).to(i32),
        region2.reshape(N).to(i32),
        tsel.reshape(N, 3).to(i32),
        c1sel.reshape(N).to(i32),
        valid.reshape(N).to(i32),
        rate_idx.to(i32).repeat_interleave(L),
        cfg.reshape(N).to(i32),
    ]


def decode_buckets(main_u8, lane_args, perm, buckets):
    """Entropy-decode lanes bucket by bucket → (lines, fail) in lane order.

    ``lane_args`` are decode_spectra's [N] lane tensors; ``buckets`` is a
    tuple of (lane_count, n_big, n_c1).  With more than one bucket the
    lanes run in the order ``perm`` and one row scatter restores it."""
    from .huffman_device import decode_spectra

    if len(buckets) == 1:
        _cnt, nb, nc = buckets[0]
        return decode_spectra(main_u8, *lane_args, n_big=nb, n_c1=nc)
    p = perm.to(torch.int64)
    pa = [a[p].contiguous() for a in lane_args]
    parts = []
    start = 0
    for cnt, nb, nc in buckets:
        sl = slice(start, start + cnt)
        start += cnt
        parts.append(decode_spectra(
            main_u8, *[a[sl].contiguous() for a in pa], n_big=nb, n_c1=nc))
    # un-permute by scatter: row p[k] of the result is sorted row k
    lines_p = torch.cat([x for x, _ in parts], dim=0)
    fail_p = torch.cat([x for _, x in parts], dim=0)
    lines = torch.zeros_like(lines_p)
    lines[p] = lines_p
    fail = torch.zeros_like(fail_p)
    fail[p] = fail_p
    return lines, fail


def mp3_decode_fused(*args, **kwargs) -> torch.Tensor:
    """Raw main_data + lane metadata → f32 flat interleaved PCM
    ``[B, G*576*C]``; arguments as ``fused_subband_samples``.  Spans, each
    timed on the device under a profiler: ``mp3.entropy`` (K1),
    ``mp3.requantize``, ``mp3.stereo``, ``mp3.imdct`` and ``mp3.synth``
    (K2)."""
    ts = fused_subband_samples(*args, **kwargs)
    with span("mp3.synth", ts.device):
        return polyphase_synthesis(ts)

# Host parts copied verbatim from audio_decoder_tpu/codecs/flac/encode.py (that package imports jax on import); the two device passes are plain torch.
"""FLAC encoder — device-side analysis, host-side vectorized bit packing.

The export half of the FLAC family (decode lives in device.py/frontend.py).
The bytes are those of the JAX package's encoder wherever the two device
passes agree (see ``flac_cost_batch`` for where their f32 sums may not).

Split of labor, as in ``io.encode.pack_pcm``:

  * **Device, pass A** (``flac_cost_batch``): quantization, the four
    stereo-decorrelation candidates (L/R/side/mid), the FIXED-predictor
    residual ladder and its closed-form rice cost per order, CONSTANT
    detection, and the windowed autocorrelation that LPC analysis reads.
    Integer arithmetic is exact; the cost sums and the autocorrelation
    are f32 and only pick parameters (any pick is a valid stream).
  * **Host planner** (``_plan_predictors``): Levinson-Durbin, coefficient
    quantization, the LPC/FIXED/CONSTANT and stereo-mode choice.
  * **Device, pass B** (``flac_residual_batch``): the exact residuals of
    the chosen predictors and the per-partition zigzag sums.
  * **Host packer** (``_pack_tokens``): the serial bitstream emit, every
    subframe lowered to flat (leading_zeros, value, nbits) token arrays
    and packed with one ``np.bincount`` per frame.

Output is spec-clean FLAC (RFC 9639): fixed-blocksize strategy, FIXED
0-4 / LPC / CONSTANT / VERBATIM subframes, all four stereo modes chosen
per frame, rice method 0/1 with per-partition parameters, stamped
STREAMINFO MD5 and real min/max frame sizes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn.functional import pad as _pad

from ...ops.bytes import _exp2_xla, f32_to_i32
from ...utils import threefry
from ...utils.threefry import _fma
from ...utils.trace import span
from .frontend import crc8, crc16, pcm_md5

__all__ = ["encode_flac"]

_ORDERS = 5       # FIXED predictor orders 0..4
_KMAX = 30        # largest rice parameter considered (method-1 space)
_LPC_PREC = 15    # quantized LPC coefficient precision (field = prec-1)
MAX_LPC_ORDER = 8  # default -5-ish analysis depth (encode_flac knob)

#: level → (max LPC order, apodization windows): the familiar flac(1)
#: effort ladder.  Levels 0-2 are FIXED-only; 8 is the full search —
#: order 12 with the three-window bank (whole-block Tukey + two
#: partial-Tukeys + three punchout-Tukeys = 6 analysis windows/frame,
#: libFLAC's -8 bank) — every (window, order) pair competes per frame.
LEVELS = {
    0: (0, ("tukey(0.5)",)),
    1: (0, ("tukey(0.5)",)),
    2: (0, ("tukey(0.5)",)),
    3: (6, ("tukey(0.5)",)),
    4: (8, ("tukey(0.5)",)),
    5: (8, ("tukey(0.5)",)),
    6: (8, ("tukey(0.5)",)),
    7: (12, ("tukey(0.5)",)),
    8: (12, ("tukey(0.5)", "partial_tukey(2)", "punchout_tukey(3)")),
}


def _tukey(n: int, p: float) -> np.ndarray:
    """Tukey (tapered-cosine) window, taper fraction ``p``."""
    if n == 1:
        return np.ones(1)
    t = np.arange(n) / (n - 1)
    edge = p / 2.0
    w = np.ones(n)
    lo = t < edge
    hi = t > 1.0 - edge
    w[lo] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[lo] / p - 1.0)))
    w[hi] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * (1.0 - t[hi]) / p - 1.0)))
    return w


def window_bank(names: tuple[str, ...], nmax: int) -> np.ndarray:
    """Apodization names → f32 ``[NW, nmax]`` window bank.

    ``tukey(p)`` — whole-block taper; ``partial_tukey(n)`` — n Tukey
    windows each covering 1/n of the block (non-stationary frames:
    analyze each region separately and let the best fit win);
    ``punchout_tukey(n)`` — n windows each EXCLUDING 1/n of the block
    (a transient in the punched-out region stops poisoning the fit)."""
    rows: list[np.ndarray] = []
    for name in names:
        kind, _, arg = name.partition("(")
        arg = arg.rstrip(")")
        if kind == "tukey":
            rows.append(_tukey(nmax, float(arg)))
        elif kind == "partial_tukey":
            parts = int(arg)
            for i in range(parts):
                w = np.zeros(nmax)
                a, b = (nmax * i) // parts, (nmax * (i + 1)) // parts
                w[a:b] = _tukey(b - a, 0.1)
                rows.append(w)
        elif kind == "punchout_tukey":
            parts = int(arg)
            for i in range(parts):
                a, b = (nmax * i) // parts, (nmax * (i + 1)) // parts
                w = _tukey(nmax, 0.1).copy()
                w[a:b] = 0.0
                rows.append(w)
        else:
            raise ValueError(f"unknown apodization {name!r}")
    return np.stack(rows).astype(np.float32)
_BS_CODE = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9,
            1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14, 32768: 15}
_RATE_CODE = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
              24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
_BPS_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}
# stereo mode → (first, second) decorrelation candidate (L, R, side, mid)
_MODE_A = np.array([0, 0, 2, 3], np.int32)   # indep, left/side, side/right,
_MODE_B = np.array([1, 2, 1, 2], np.int32)   # mid/side
_MODE_CODE = np.array([0, 8, 9, 10], np.int32)


def _zigzag(r: torch.Tensor) -> torch.Tensor:
    """int32 ``(r << 1) ^ (r >> 31)`` read as uint32, carried in int64 (torch
    has no uint32 shift on the CPU)."""
    r = r.long()
    return ((r << 1) ^ (r >> 63)) & threefry.M32


def flac_cost_batch(
    pcm: torch.Tensor,      # f32 [F, nmax, C] frame-blocked PCM (padding 0)
    nvalid: torch.Tensor,   # i32 [F] valid samples per frame
    windows: torch.Tensor | None = None,  # f32 [NW, nmax] apodization bank
    *,
    bits: int,
    channels: int,
    nmax: int,
    maxo: int,
    dither: int | None = None,
) -> dict:
    """Encode pass A — per-frame predictor economics, on the PCM's device.

    Returns the JAX package's keys, dtypes and shapes:
      ints        i32 [F, C, nmax]     quantized input (MD5/verbatim src)
      cands       i32 [F, NC, nmax]    decorrelation candidates (feed pass B)
      fixed_cost  f32 [F, NC]          best modeled FIXED subframe bits
      fixed_order i32 [F, NC]          arg of that minimum (0..4)
      is_const    bool [F, NC]         all-equal detector
      acorr       f32 [F, NC, NW, maxo+1]  per-window autocorrelation

    The integers are JAX's exactly (the dither is its threefry draw bit for
    bit).  ``fixed_cost`` and ``acorr`` are f32 sums that run in another
    order than XLA's, so they agree within about 1e-7 relative (of lag 0
    for ``acorr``); a near-tied FIXED order or a quantized LPC coefficient
    can then flip, which changes the bytes but never the decoded samples.
    """
    F, C = pcm.shape[0], channels
    dev = pcm.device
    f32 = torch.float32
    scale = float(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    x = pcm * scale
    if dither is not None:  # same TPDF formula as io.encode.pack_pcm
        u = threefry.uniform(threefry.prng_key(dither, device=dev),
                             (2,) + tuple(pcm.shape))
        x = x + (u[0] - u[1])
    # round half to even, clip, then XLA's cast (NaN → 0, saturating)
    q = f32_to_i32(torch.clamp(torch.round(x), -scale, hi))
    x = q.transpose(1, 2)  # [F, C, nmax]
    idx = torch.arange(nmax, device=dev)
    valid = idx[None, :] < nvalid[:, None]  # [F, nmax]
    x = torch.where(valid[:, None, :], x, 0)

    if C == 2:
        L, R = x[:, 0], x[:, 1]
        cands = torch.stack([L, R, L - R, (L + R) >> 1], dim=1)
        cbps = [bits, bits, bits + 1, bits]
    else:
        cands = x
        cbps = [bits] * C
    NC = cands.shape[1]

    # FIXED residual ladder: order-o residual = o-th first difference
    rs = [cands]
    for _ in range(1, _ORDERS):
        prev = rs[-1]
        rs.append(prev - _pad(prev, (1, 0))[:, :, :nmax])
    zz = _zigzag(torch.stack(rs, dim=0))               # [5, F, NC, nmax]

    omask = (idx[None, None, None, :]
             >= torch.arange(_ORDERS, device=dev)[:, None, None, None])
    m = omask & valid[None, :, None, :]                # [5, F, NC, nmax]
    cnt = m.sum(-1).to(f32)                            # [5, F, NC]

    # the closed-form rice size  cnt·(k+1) + Σzz/2^k  minimized over k;
    # 2^-k and the fused multiply-add as XLA computes them
    sums = torch.where(m, zz, 0).to(f32).sum(-1)
    ks = torch.arange(_KMAX + 1, dtype=f32, device=dev)[:, None, None, None]
    kbits = _fma(sums[None], _exp2_xla(-ks), cnt[None] * (ks + 1.0))
    cost = kbits.amin(0) + (
        torch.arange(_ORDERS, dtype=f32, device=dev)[:, None, None]
        * torch.tensor(cbps, dtype=f32, device=dev)[None, None, :])
    fixed_order = torch.argmin(cost, dim=0).to(torch.int32)  # first minimum
    fixed_cost = cost.amin(0)

    is_const = torch.where(valid[:, None, :], cands == cands[:, :, :1],
                           True).all(-1)

    # windowed autocorrelation for LPC analysis: one lag loop over the
    # whole [F, NC, NW, nmax] bank
    if maxo > 0:
        if windows is None:
            windows = torch.as_tensor(window_bank(("tukey(0.5)",), nmax),
                                      device=dev)
        xw = cands.to(f32)[:, :, None, :] * windows[None, None, :, :]
        xw = torch.where(valid[:, None, None, :], xw, 0.0)
        acorr = torch.stack(
            [(xw[..., : nmax - lag] * xw[..., lag:]).sum(-1)
             for lag in range(maxo + 1)], dim=-1)      # [F, NC, NW, maxo+1]
    else:
        acorr = torch.zeros((F, NC, 1, 1), dtype=f32, device=dev)

    return dict(ints=x, cands=cands, fixed_cost=fixed_cost,
                fixed_order=fixed_order, is_const=is_const, acorr=acorr)


def flac_residual_batch(
    cands: torch.Tensor,    # i32 [F, NC, nmax] pass-A candidates
    nvalid: torch.Tensor,   # i32 [F]
    sel: torch.Tensor,      # i32 [F, C] chosen candidate per subchannel
    order: torch.Tensor,    # i32 [F, C] predictor order (0..maxo)
    coeffs: torch.Tensor,   # i32 [F, C, maxo] quantized predictor coefficients
    shift: torch.Tensor,    # i32 [F, C] predictor right-shift (0 for FIXED)
    *,
    channels: int,
    nmax: int,
    npart: int,
    maxo: int,
) -> dict:
    """Encode pass B — exact residuals for the host-chosen predictors.

    One scheme serves FIXED and LPC: residual[i] = x[i] −
    (Σ_j c_j·x[i−1−j] >> shift) for i ≥ order.  The dot is exact in
    int64 (|c| < 2^15, |x| < 2^26, at most 32 taps: under 2^46) and the
    arithmetic shift is its floor; the residual wraps to int32 as JAX's.

    Returns dict(sub i32 [F,C,nmax], resid i32 [F,C,nmax],
    psums f32 [F,C,npart] — Σ zigzag(residual) per partition cell)."""
    F, C = cands.shape[0], channels
    dev = cands.device
    sub = torch.gather(cands, 1, sel.long()[:, :, None].expand(F, C, nmax))
    x = sub.long()
    acc = torch.zeros((F, C, nmax), dtype=torch.int64, device=dev)
    for j in range(maxo):
        acc += _pad(x, (j + 1, 0))[:, :, :nmax] * coeffs[:, :, j, None].long()
    pred = acc >> shift.long()[:, :, None]
    idx = torch.arange(nmax, device=dev)
    warm = idx[None, None, :] < order[:, :, None]
    valid = idx[None, :] < nvalid[:, None]              # [F, nmax]
    resid = torch.where(warm, x, x - pred).to(torch.int32)
    resid = torch.where(valid[:, None, :], resid, 0)

    mres = ~warm & valid[:, None, :]
    psize = nmax // npart
    psums = (torch.where(mres, _zigzag(resid), 0).to(torch.float32)
             .reshape(F, C, npart, psize).sum(-1))
    return dict(sub=sub, resid=resid, psums=psums)


def _levinson(r: np.ndarray, maxo: int):
    """Vectorized Levinson-Durbin over M lanes.

    ``r`` f64 [M, maxo+1] autocorrelation lags.  Returns
    (lpc f64 [M, maxo, maxo] — row o-1 holds the order-o coefficients
    in c_0..c_{o-1}, and err f64 [M, maxo+1] — modeled residual energy
    per order, err[:, 0] = r[:, 0]).  Degenerate lanes (r0 ≤ 0 or a
    non-positive error, e.g. constant frames) freeze: their remaining
    orders keep the last valid coefficients and error."""
    M = r.shape[0]
    lpc = np.zeros((M, maxo, maxo))
    err = np.zeros((M, maxo + 1))
    err[:, 0] = np.maximum(r[:, 0], 0.0)
    a = np.zeros((M, maxo))
    for o in range(1, maxo + 1):
        acc = r[:, o] - np.sum(a[:, : o - 1] * r[:, o - 1:0:-1][:, : o - 1],
                               axis=1)
        ok = err[:, o - 1] > 0.0
        k = np.where(ok, acc / np.where(ok, err[:, o - 1], 1.0), 0.0)
        k = np.clip(k, -1.0, 1.0)
        new = a.copy()
        new[:, o - 1] = k
        if o > 1:
            new[:, : o - 1] = a[:, : o - 1] - k[:, None] * a[:, o - 2::-1]
        a = np.where(ok[:, None], new, a)
        err[:, o] = np.where(ok, err[:, o - 1] * (1.0 - k * k),
                             err[:, o - 1])
        lpc[:, o - 1, :] = a
    return lpc, err


def _quantize_lpc(c: np.ndarray, order: np.ndarray, prec: int):
    """Quantize float LPC coefficients with error feedback.

    ``c`` f64 [M, O] (taps past ``order[m]`` are ignored and quantize to
    exactly 0 — the bitstream carries only ``order`` coefficients, so a
    nonzero tail would desynchronize encoder and decoder predictions).
    Returns (q i32 [M, O] in [-2^(prec-1), 2^(prec-1)), shift i32 [M]
    in [0, 15])."""
    M, O = c.shape
    live0 = np.arange(O)[None, :] < order[:, None]     # [M, O]
    cm = np.where(live0, c, 0.0)
    cmax = np.abs(cm).max(axis=1)
    # shift chosen so max|c|·2^shift just fits prec-1 integer bits
    safe = np.where(cmax > 0, cmax, 1.0)
    shift = (prec - 1) - (np.floor(np.log2(safe)).astype(np.int64) + 1)
    shift = np.clip(shift, 0, 15).astype(np.int64)
    lo, hi = -(1 << (prec - 1)), (1 << (prec - 1)) - 1
    q = np.zeros((M, O), np.int64)
    e = np.zeros((M,))
    for j in range(O):
        live = live0[:, j]
        v = cm[:, j] * np.exp2(shift.astype(np.float64)) + e
        qj = np.where(live, np.clip(np.rint(v), lo, hi), 0.0)
        e = np.where(live, v - qj, e)
        q[:, j] = qj.astype(np.int64)
    return q.astype(np.int32), shift.astype(np.int32)


def _plan_predictors(out: dict, nvalid: np.ndarray, *, bits: int,
                     channels: int, maxo: int, nmax: int):
    """Host half of the encode analysis: Levinson-Durbin on the pass-A
    autocorrelation, coefficient quantization, LPC-vs-FIXED-vs-CONSTANT
    selection under one rice cost model, and stereo-mode choice.

    Returns (mode i32 [F], sel/kind/order/shift i32 [F, C],
    coeffs i32 [F, C, maxo], prec int).  kind: 0 = FIXED, 1 = CONSTANT,
    2 = LPC (coeffs/shift meaningful for 0 and 2; FIXED rows carry the
    spec coefficients with shift 0 so pass B runs one scheme)."""
    F = out["fixed_cost"].shape[0]
    C = channels
    fixed_cost = np.asarray(out["fixed_cost"])          # [F, NC]
    fixed_order = np.asarray(out["fixed_order"])
    is_const = np.asarray(out["is_const"])
    NC = fixed_cost.shape[1]
    if C == 2:
        cbps = np.array([bits, bits, bits + 1, bits], np.int32)
    else:
        cbps = np.full((C,), bits, np.int32)
    n = nvalid.astype(np.float64)[:, None]              # [F, 1]

    prec = _LPC_PREC
    if maxo > 0:
        acorr = np.asarray(out["acorr"], np.float64)  # [F, NC, NW, maxo+1]
        NW = acorr.shape[2]
        M = F * NC * NW
        lpc, errs = _levinson(acorr.reshape(M, maxo + 1), maxo)
        # modeled bits per (window, order): residual entropy ~
        # ½log2(err/n) per sample plus warmup/coefficient/header
        # overhead (the estimate every production encoder uses —
        # selection only, any pick is a valid stream).  Every window's
        # fit competes on the same grid, so the joint argmin IS the
        # apodization search.
        nM = n.repeat(NC * NW, 1).reshape(-1, 1)        # [M, 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            sigma2 = errs[:, 1:] / np.maximum(nM, 1.0)
            bps_est = 0.5 * np.log2(np.maximum(sigma2, 1e-9)) + 2.0
        ordv = np.arange(1, maxo + 1, dtype=np.float64)[None, :]
        cbpsv = np.broadcast_to(
            cbps[None, :, None], (F, NC, NW)).reshape(-1, 1).astype(
                np.float64)
        lbits = (np.maximum(bps_est, 1.0) * (nM - ordv)
                 + ordv * (cbpsv + prec) + 4 + 5)       # [M, maxo]
        flat = lbits.reshape(F * NC, NW * maxo)
        jbest = np.argmin(flat, axis=1)                 # [F·NC]
        lcost = flat[np.arange(F * NC), jbest].reshape(F, NC)
        wbest = jbest // maxo
        obest = jbest % maxo                            # order-1
        lorder = (obest + 1).reshape(F, NC).astype(np.int32)
        csel = lpc.reshape(F * NC, NW, maxo, maxo)[
            np.arange(F * NC), wbest, obest]            # [F·NC, maxo]
        qc, qshift = _quantize_lpc(csel, obest + 1, prec)
        qc = qc.reshape(F, NC, maxo)
        qshift = qshift.reshape(F, NC)
    else:
        lcost = np.full((F, NC), np.inf)
        lorder = np.zeros((F, NC), np.int32)
        qc = np.zeros((F, NC, max(maxo, 1)), np.int32)
        qshift = np.zeros((F, NC), np.int32)

    # per-candidate best coding + cost (same overhead model as pass A)
    use_lpc = lcost < fixed_cost
    # degenerate/short frames: no LPC when order ≥ n
    use_lpc &= lorder < nvalid[:, None]
    ch_cost = np.where(use_lpc, lcost, fixed_cost) + 14.0
    ch_cost = np.where(is_const, cbps[None].astype(np.float64) + 8.0,
                       ch_cost)

    if C == 2:
        tot = ch_cost[:, _MODE_A] + ch_cost[:, _MODE_B]  # [F, 4]
        mi = np.argmin(tot, axis=1)
        mode = _MODE_CODE[mi]
        sel = np.stack([_MODE_A[mi], _MODE_B[mi]], axis=1).astype(np.int32)
    else:
        mode = np.zeros((F,), np.int32)
        sel = np.broadcast_to(np.arange(C, dtype=np.int32)[None],
                              (F, C)).copy()

    fi = np.arange(F)[:, None]
    kind = np.where(is_const[fi, sel], 1,
                    np.where(use_lpc[fi, sel], 2, 0)).astype(np.int32)
    order = np.where(kind == 2, lorder[fi, sel],
                     fixed_order[fi, sel]).astype(np.int32)
    shift = np.where(kind == 2, qshift[fi, sel], 0).astype(np.int32)
    W = max(maxo, _ORDERS - 1)  # room for FIXED coefficients either way
    fixed_tab = np.zeros((_ORDERS, W), np.int32)
    for o, cs in enumerate(((), (1,), (2, -1), (3, -3, 1), (4, -6, 4, -1))):
        fixed_tab[o, : len(cs)] = cs
    if maxo > 0:
        lpc_rows = np.zeros((F, C, W), np.int32)
        lpc_rows[:, :, :maxo] = qc[fi, sel]
    else:
        lpc_rows = np.zeros((F, C, W), np.int32)
    coeffs = np.where((kind == 2)[:, :, None], lpc_rows,
                      fixed_tab[np.minimum(order, _ORDERS - 1)])
    return mode, sel, kind, order, shift, coeffs.astype(np.int32), prec


class _Tokens:
    """Flat (leading_zeros, value, nbits) token accumulator.

    A token writes ``zeros`` 0-bits then the low ``nbits`` of ``value``
    (1 ≤ nbits ≤ 32).  Zeros cost nothing to emit — the buffer starts
    zeroed — so a rice code is ONE token: q leading zeros, then the
    (1 << k) | remainder suffix of k+1 bits."""

    def __init__(self):
        self.z: list = []
        self.v: list = []
        self.n: list = []
        self.bits = 0

    def u(self, val: int, nbits: int, zeros: int = 0) -> None:
        self.z.append(zeros)
        self.v.append(val)
        self.n.append(nbits)
        self.bits += zeros + nbits

    def s(self, val: int, nbits: int) -> None:
        self.u(int(val) & ((1 << nbits) - 1), nbits)

    def arrays(self, zeros, vals, nbits) -> None:
        """Append token vectors (numpy arrays, same length)."""
        self.z.append(zeros)
        self.v.append(vals)
        self.n.append(nbits)
        self.bits += int(np.sum(zeros) + np.sum(nbits))

    def align(self) -> None:
        pad = (-self.bits) % 8
        if pad:
            self.u(0, 1, zeros=pad - 1)

    def pack(self) -> bytes:
        assert self.bits % 8 == 0
        z = np.concatenate([np.atleast_1d(np.asarray(a, np.int64))
                            for a in self.z]) if self.z else np.zeros(0, np.int64)
        v = np.concatenate([np.atleast_1d(np.asarray(a, np.uint64))
                            for a in self.v]) if self.v else np.zeros(0, np.uint64)
        n = np.concatenate([np.atleast_1d(np.asarray(a, np.int64))
                            for a in self.n]) if self.n else np.zeros(0, np.int64)
        return _pack_tokens(z, v, n)


def _pack_tokens(zeros: np.ndarray, vals: np.ndarray,
                 nbits: np.ndarray) -> bytes:
    """Vectorized MSB-first bit packing of a token stream.

    Each value spans ≤ 32 bits at a ≤ 7-bit byte offset — 5 output
    bytes.  Distinct tokens occupy disjoint bit ranges, so OR across
    tokens equals ADD, and one ``np.bincount`` per byte-slot materializes
    the buffer (exact: each byte sums ≤ 8 disjoint bits ≤ 255 < 2^53)."""
    end = np.cumsum(zeros + nbits)
    total = int(end[-1]) if end.size else 0
    assert total % 8 == 0
    nb = total // 8
    if not nb:
        return b""
    pos = end - nbits
    off = (pos & 7).astype(np.uint64)
    contrib = vals << (np.uint64(64) - nbits.astype(np.uint64) - off)
    base = (pos >> 3).astype(np.int64)
    idx = (base[None, :] + np.arange(5, dtype=np.int64)[:, None]).ravel()
    byts = np.stack(
        [((contrib >> np.uint64(56 - 8 * j)) & np.uint64(0xFF))
         .astype(np.float64) for j in range(5)]).ravel()
    acc = np.bincount(idx, weights=byts, minlength=nb + 8)
    return acc[:nb].astype(np.uint8).tobytes()


def _utf8_tokens(t: _Tokens, val: int) -> None:
    """UTF-8-style frame-number coding (RFC 9639 §9.1.1)."""
    if val < 0x80:
        t.u(val, 8)
        return
    n = 1
    while val >= (1 << (6 + 5 * n)):
        n += 1
    lead = ((1 << (n + 1)) - 1) << (7 - n)
    t.u(lead | (val >> (6 * n)), 8)
    for k in range(n - 1, -1, -1):
        t.u(0x80 | ((val >> (6 * k)) & 0x3F), 8)


def _residual_tokens(t: _Tokens, res: np.ndarray, n: int, order: int,
                     psums: np.ndarray, full: bool, npart: int) -> None:
    """Emit the coded-residual section for one subframe.

    ``res`` holds the whole frame's residual array (positions < order
    are predictor warmup — never read).  ``psums`` is the device's
    [npart] Σ-zigzag partition-cell grid (cells of n/npart only when
    ``full``); partition order and per-partition rice parameters
    minimize the modeled bit count  cnt·(k+1) + Σzz/2^k  and the method
    (4- vs 5-bit parameters) follows the largest parameter chosen."""
    zz = res.astype(np.int64)
    zz = (zz << 1) ^ (zz >> 63)
    ks = np.arange(_KMAX + 1, dtype=np.float64)

    def plan(po: int):
        parts = 1 << po
        psize = n >> po
        cnts = np.full(parts, psize, np.float64)
        cnts[0] -= order
        s = psums.reshape(parts, npart // parts).sum(-1)
        bits_pk = s[None] * np.exp2(-ks)[:, None] \
            + cnts[None, :] * (ks[:, None] + 1.0)
        kp = np.argmin(bits_pk, axis=0)
        cost = bits_pk[kp, np.arange(parts)].sum()
        pbits = 4 if kp.max() <= 14 else 5
        return cost + parts * pbits, kp, pbits

    best = None
    max_po = npart.bit_length() - 1 if full else 0
    for po in range(max_po + 1):
        if (n % (1 << po)) or (n >> po) <= order:
            break
        cand = (*plan(po), po)
        if best is None or cand[0] < best[0]:
            best = cand
    _, kp, pbits, po = best
    method = 0 if pbits == 4 else 1
    t.u((method << 4) | po, 6)
    parts = 1 << po
    psize = n >> po
    for p in range(parts):
        k = int(kp[p])
        t.u(k, pbits)
        lo = p * psize + (order if p == 0 else 0)
        part = zz[lo:(p + 1) * psize]
        t.arrays((part >> k).astype(np.int64),
                 ((1 << k) | (part & ((1 << k) - 1))).astype(np.uint64),
                 np.full(part.shape, k + 1, np.int64))


def _subframe_tokens(t: _Tokens, sub: np.ndarray, res: np.ndarray,
                     kind: int, order: int, bpc: int, n: int,
                     psums: np.ndarray, full: bool, npart: int,
                     coefs: np.ndarray | None = None, shift: int = 0,
                     prec: int = _LPC_PREC) -> None:
    if kind == 1:          # CONSTANT
        t.u(0, 8)          # reserved(1)=0, type(6)=0, wasted-flag(1)=0
        t.s(int(sub[0]), bpc)
        return
    if n <= order:         # no room for warmup + residual → VERBATIM
        t.u(1 << 1, 8)
        for v in sub[:n]:
            t.s(int(v), bpc)
        return
    if kind == 2:          # LPC
        t.u((32 | (order - 1)) << 1, 8)
        for v in sub[:order]:
            t.s(int(v), bpc)
        t.u(prec - 1, 4)
        t.u(shift, 5)      # s(5), always ≥ 0 here
        for c in coefs[:order]:
            t.s(int(c), prec)
    else:                  # FIXED
        t.u((8 | order) << 1, 8)
        for v in sub[:order]:
            t.s(int(v), bpc)
    _residual_tokens(t, res[:n], n, order, psums, full, npart)


def _emit(plan: tuple, fetched: dict, nvalid: np.ndarray, *, S: int, C: int,
          bits: int, blocksize: int, npart: int, sample_rate: int) -> bytes:
    """The frames and STREAMINFO from the plan and pass B's fetched arrays
    (``sub``, ``resid``, ``psums``, and pass A's ``ints``), as numpy."""
    mode_a, sel, kind, order, shift, coeffs, prec = plan
    sub_h, resid_h, psums_h = fetched["sub"], fetched["resid"], fetched["psums"]
    F = -(-S // blocksize)
    frames = []
    for f in range(F):
        n = int(nvalid[f])
        mode = int(mode_a[f])
        t = _Tokens()
        t.u((0x3FFE << 2) | 0, 16)  # sync, reserved, fixed-blocksize
        full = n == blocksize
        bs_code = _BS_CODE.get(n, 6 if n <= 256 else 7)
        t.u(bs_code, 4)
        t.u(_RATE_CODE.get(int(sample_rate), 0), 4)
        t.u((C - 1) if mode == 0 else mode, 4)
        t.u(_BPS_CODE[bits], 3)
        t.u(0, 1)
        _utf8_tokens(t, f)
        if bs_code == 6:
            t.u(n - 1, 8)
        elif bs_code == 7:
            t.u(n - 1, 16)
        hdr = t.pack()
        t = _Tokens()
        side = {8: 1, 9: 0, 10: 1}.get(mode, -1)
        for c in range(C):
            _subframe_tokens(
                t, sub_h[f, c], resid_h[f, c],
                int(kind[f, c]), int(order[f, c]),
                bits + (1 if c == side else 0), n,
                psums_h[f, c], full, npart,
                coefs=coeffs[f, c], shift=int(shift[f, c]), prec=prec)
        t.align()
        body = hdr + bytes([crc8(hdr)]) + t.pack()
        frames.append(body + crc16(body).to_bytes(2, "big"))

    payload = b"".join(frames)
    ints = np.transpose(fetched["ints"], (0, 2, 1)).reshape(-1, C)[:S]
    t = _Tokens()
    t.u(blocksize, 16)
    t.u(blocksize, 16)
    t.u(min(len(fr) for fr in frames), 24)
    t.u(max(len(fr) for fr in frames), 24)
    t.u(int(sample_rate), 20)
    t.u(C - 1, 3)
    t.u(bits - 1, 5)
    t.u((S >> 32) & 0xF, 4)   # 36-bit total-samples field, split so every
    t.u(S & 0xFFFFFFFF, 32)   # token fits the packer's 32-bit contract
    info = t.pack() + pcm_md5(ints, bits)
    return (b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big")
            + info + payload)


def _fetch(out: dict, keys: tuple) -> dict:
    return {k: out[k].cpu().numpy() for k in keys}


def _npart(blocksize: int) -> int:
    """The partition grid of pass B's zigzag sums: 16 cells, halved until
    they divide the block and hold more than 4 samples."""
    npart = 16
    while npart > 1 and (blocksize % npart or blocksize // npart <= 4):
        npart //= 2
    return npart


def encode_flac(
    pcm, sample_rate: int, *, bits: int = 16, blocksize: int = 4096,
    dither: int | None = None, lpc_order: int | None = None,
    level: int | None = None,
    apodizations: tuple[str, ...] | None = None,
    device="cuda",
) -> bytes:
    """f32 PCM ``[S, C]`` (or ``[S]``) → FLAC bytes, the two analysis passes
    on ``device``.

    Quantization matches ``io.encode.pack_pcm`` (scale 2^(bits-1),
    round-half-even, clip; optional seeded TPDF dither), so integer PCM
    decoded by this framework round-trips losslessly:
    decode → encode_flac → decode is bit-exact.

    ``level``: the flac(1)-style effort ladder (see ``LEVELS``; default
    5 ≈ order-8 single-window; 8 = order-12 with the three-apodization
    bank).  ``lpc_order`` / ``apodizations`` override the level's
    defaults; ``lpc_order=0`` restricts subframes to CONSTANT/FIXED/
    VERBATIM.  Every (window, order ≤ lpc_order) pair competes per
    frame under one modeled-bits grid.
    """
    x = np.asarray(pcm, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    S, C = x.shape
    if not 1 <= C <= 8:
        raise ValueError(f"FLAC supports 1-8 channels, got {C}")
    if bits not in _BPS_CODE:
        raise ValueError(f"unsupported bit depth {bits} (have "
                         f"{sorted(_BPS_CODE)})")
    if not 16 <= blocksize <= 32768:
        raise ValueError(f"blocksize {blocksize} out of range [16, 32768]")
    if S < 1:
        raise ValueError("empty PCM")
    if not 1 <= int(sample_rate) < (1 << 20):
        raise ValueError(f"sample rate {sample_rate} out of STREAMINFO range")

    if level is not None and level not in LEVELS:
        raise ValueError(f"level {level} out of range [0, 8]")
    lvl_order, lvl_apod = LEVELS[5 if level is None else level]
    if lpc_order is None:
        lpc_order = lvl_order
    if apodizations is None:
        apodizations = lvl_apod

    npart = _npart(blocksize)
    F = -(-S // blocksize)
    Fb = max(1, 1 << (F - 1).bit_length())  # JAX's bucket: the dither's shape
    pad = Fb * blocksize - S
    xb = np.pad(x, ((0, pad), (0, 0))).reshape(Fb, blocksize, C)
    nvalid = np.clip(S - np.arange(Fb) * blocksize, 0, blocksize)

    maxo = int(lpc_order)
    if not 0 <= maxo <= 32:
        raise ValueError(f"lpc_order {maxo} out of range [0, 32]")
    maxo = min(maxo, blocksize - 1)

    from ..registry import resolve_device

    dev = resolve_device(device)
    nv = torch.as_tensor(nvalid.astype(np.int32), device=dev)
    with span("flac.encode.pass_a"):
        wins = (torch.as_tensor(window_bank(tuple(apodizations), blocksize),
                                device=dev) if maxo > 0 else None)
        out = flac_cost_batch(
            torch.as_tensor(xb, device=dev), nv, wins,
            bits=bits, channels=C, nmax=blocksize, maxo=maxo, dither=dither)
    with span("flac.encode.plan"):
        plan = _plan_predictors(
            _fetch(out, ("fixed_cost", "fixed_order", "is_const", "acorr")),
            nvalid, bits=bits, channels=C, maxo=maxo, nmax=blocksize)
    _mode, sel, _kind, order, shift, coeffs, _prec = plan
    with span("flac.encode.pass_b"):
        res = flac_residual_batch(
            out["cands"], nv, *(torch.as_tensor(a, device=dev)
                                for a in (sel, order, coeffs, shift)),
            channels=C, nmax=blocksize, npart=npart,
            maxo=max(maxo, _ORDERS - 1))
    with span("flac.encode.pack"):
        fetched = _fetch(res, ("sub", "resid", "psums"))
        fetched["ints"] = out["ints"].cpu().numpy()
        return _emit(plan, fetched, nvalid, S=S, C=C, bits=bits,
                     blocksize=blocksize, npart=npart, sample_rate=sample_rate)

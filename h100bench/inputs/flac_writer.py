"""A vectorised NumPy FLAC encoder for the benchmark's corpora.

Written from the FLAC format (RFC 9639).  Every frame of every stream is
analysed and packed at once, as arrays, with the choices of libFLAC's
level 5 for 16-bit audio: fixed blocksize 4096, LPC up to order 8 on a
Tukey(0.5) window, the order picked from the Levinson errors by libFLAC's
expected-bits rule, coefficients quantised at 12 bits with error feedback,
the best FIXED order (0-4, by the sum of absolute residuals) tried beside
it, and rice partition orders 0-5 picked by libFLAC's bit estimate from
the partitions' sums.  A stream's last, short frame codes its residual in
one partition.  Only the data is vectorised: the bitstream is the one the
format defines, so any decoder reads it.

It imports nothing of the program under test, so later changes to the
program cannot move the benchmark's inputs.
"""

from __future__ import annotations

import hashlib

import numpy as np

BLOCKSIZE = 4096
MAX_LPC_ORDER = 8
QLP_PRECISION = 12
MAX_PARTITION_ORDER = 5
MAX_RICE = 14  # 4-bit parameters; 15 is the escape code

_RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
               24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
_BLOCK_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9,
                1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14, 32768: 15}


def _crc8_table() -> np.ndarray:
    t = np.zeros(256, np.int64)
    for b in range(256):
        r = b
        for _ in range(8):
            r = ((r << 1) ^ 0x07) & 0xFF if r & 0x80 else (r << 1) & 0xFF
        t[b] = r
    return t


def _crc16_table() -> np.ndarray:
    t = np.zeros(256, np.int64)
    for b in range(256):
        r = b << 8
        for _ in range(8):
            r = ((r << 1) ^ 0x8005) & 0xFFFF if r & 0x8000 else (r << 1) & 0xFFFF
        t[b] = r
    return t


CRC8 = _crc8_table()
CRC16 = _crc16_table()


def crc8(data: bytes) -> int:
    r = 0
    for b in data:
        r = int(CRC8[r ^ b])
    return r


def _utf8_number(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    n = next(n for n in range(1, 7) if v < (1 << (6 + 5 * n)))
    lead = ((0xFF << (7 - n)) & 0xFF) | (v >> (6 * n))
    return bytes([lead] + [0x80 | ((v >> (6 * k)) & 0x3F) for k in range(n - 1, -1, -1)])


def _frame_header(frame_no: int, n: int, rate: int) -> bytes:
    """Header of a fixed-blocksize mono 16-bit frame, with its CRC-8."""
    code = _BLOCK_CODES.get(n, 7)
    tail = b"" if code != 7 else (n - 1).to_bytes(2, "big")
    h = bytes([0xFF, 0xF8, (code << 4) | _RATE_CODES[rate], (0 << 4) | (4 << 1)])
    h += _utf8_number(frame_no) + tail
    return h + bytes([crc8(h)])


def _levinson(R: np.ndarray, order: int):
    """Prediction coefficients for every order 1..``order`` (x[n] ≈ Σ a_j
    x[n-1-j]) and their errors, for each row of autocorrelations ``R``."""
    F = R.shape[0]
    a = np.zeros((F, order))
    err = R[:, 0].copy()
    coefs = np.zeros((order, F, order))
    errs = np.zeros((order, F))
    for i in range(order):
        acc = R[:, i + 1] - np.einsum("fj,fj->f", a[:, :i], R[:, i:0:-1]) if i else R[:, 1].copy()
        k = np.divide(acc, err, out=np.zeros(F), where=err > 0)
        a_prev = a[:, :i].copy()
        a[:, i] = k
        a[:, :i] = a_prev - k[:, None] * a_prev[:, ::-1]
        err = err * (1.0 - k * k)
        coefs[i] = a
        errs[i] = err
    return coefs, errs


def _quantize(lp: np.ndarray, order: np.ndarray):
    """libFLAC's coefficient quantisation at QLP_PRECISION bits with error
    feedback → (int coefficients [F, MAX_LPC_ORDER], shift [F], usable [F])."""
    F = lp.shape[0]
    j = np.arange(MAX_LPC_ORDER)[None, :]
    lp = np.where(j < order[:, None], lp, 0.0)
    cmax = np.abs(lp).max(axis=1)
    _, e = np.frexp(cmax)
    shift = (QLP_PRECISION - 1) - (e - 1) - 1
    usable = (cmax > 0) & (shift >= 0)
    shift = np.clip(shift, 0, 15)
    qmax, qmin = (1 << (QLP_PRECISION - 1)) - 1, -(1 << (QLP_PRECISION - 1))
    q = np.zeros((F, MAX_LPC_ORDER), np.int64)
    error = np.zeros(F)
    scale = np.ldexp(1.0, shift)
    for i in range(MAX_LPC_ORDER):
        error = error + lp[:, i] * scale
        qi = np.clip(np.floor(error + 0.5), qmin, qmax)
        error = error - qi
        q[:, i] = qi.astype(np.int64)
    return q, shift.astype(np.int64), usable


def _zigzag(r: np.ndarray) -> np.ndarray:
    return (r << 1) ^ (r >> 31)


def _partition_plan(zz: np.ndarray, valid: np.ndarray, full: np.ndarray):
    """Pick each frame's partition order and rice parameters by libFLAC's
    estimate → (order [F], params [F, 32] per finest partition, bits [F])."""
    F = zz.shape[0]
    fine = 1 << MAX_PARTITION_ORDER
    z = np.where(valid, zz, 0).reshape(F, fine, -1)
    sums = z.sum(axis=2).astype(np.float64)
    counts = valid.reshape(F, fine, -1).sum(axis=2).astype(np.float64)
    best_bits = np.full(F, np.inf)
    best_p = np.zeros(F, np.int64)
    best_k = np.zeros((F, fine), np.int64)
    for p in range(MAX_PARTITION_ORDER + 1):
        group = fine >> p
        s = sums.reshape(F, 1 << p, group).sum(axis=2)
        c = counts.reshape(F, 1 << p, group).sum(axis=2)
        mean = np.divide(s, c, out=np.zeros_like(s), where=c > 0)
        k = np.clip(np.floor(np.log2(np.maximum(mean, 1.0))), 0, MAX_RICE).astype(np.int64)
        bits = (4 + c * (k + 1) + np.floor(s / np.ldexp(1.0, k))).sum(axis=1)
        # a partition must hold at least one sample past the warm-up, and
        # a short last frame keeps one partition
        ok = (c > 0).all(axis=1) & (full | (p == 0))
        better = ok & (bits < best_bits)
        best_bits = np.where(better, bits, best_bits)
        best_p = np.where(better, p, best_p)
        best_k = np.where(better[:, None], np.repeat(k, group, axis=1), best_k)
    return best_p, best_k, best_bits


class _Fields:
    """Bit fields gathered as (position, value, width) arrays."""

    def __init__(self):
        self.pos, self.val, self.width = [], [], []

    def add(self, pos, val, width):
        pos, val, width = np.broadcast_arrays(np.asarray(pos, np.int64),
                                              np.asarray(val, np.int64),
                                              np.asarray(width, np.int64))
        keep = val != 0
        self.pos.append(pos[keep])
        self.val.append(val[keep])
        self.width.append(width[keep])

    def pack(self, n_bytes: int) -> np.ndarray:
        """Every field written MSB-first into a zeroed byte array."""
        pos, val, width = (np.concatenate(a) for a in (self.pos, self.val, self.width))
        n_words = (n_bytes + 3) // 4 + 1
        word, off = pos >> 5, pos & 31
        end = off + width
        fits = end <= 32
        hi = np.where(fits, val << np.maximum(32 - end, 0), val >> np.maximum(end - 32, 0))
        lo = np.where(fits, 0, (val << np.maximum(64 - end, 0)) & 0xFFFFFFFF)
        words = np.bincount(word, weights=hi.astype(np.float64), minlength=n_words)
        words += np.bincount(word + 1, weights=lo.astype(np.float64), minlength=n_words + 1)[:n_words]
        return np.frombuffer(words.astype(">u4").tobytes(), np.uint8)[:n_bytes].copy()


def encode_many(utterances: list[np.ndarray], rate: int) -> list[bytes]:
    """FLAC streams (mono, 16-bit) of int16 sample arrays."""
    lens = np.array([len(u) for u in utterances], np.int64)
    n_frames = -(-lens // BLOCKSIZE)
    F = int(n_frames.sum())
    file_of = np.repeat(np.arange(len(utterances)), n_frames)
    frame_no = np.arange(F) - np.repeat(np.cumsum(n_frames) - n_frames, n_frames)
    n = np.minimum(lens[file_of] - frame_no * BLOCKSIZE, BLOCKSIZE)
    X = np.zeros((F, BLOCKSIZE), np.int32)  # every sum below fits 32 bits
    for f0, u in zip(np.cumsum(n_frames) - n_frames, utterances):
        flat = np.zeros(-(-len(u) // BLOCKSIZE) * BLOCKSIZE, np.int32)
        flat[:len(u)] = u
        X[f0:f0 + len(flat) // BLOCKSIZE] = flat.reshape(-1, BLOCKSIZE)
    idx = np.arange(BLOCKSIZE)[None, :]
    inside = idx < n[:, None]
    full = n == BLOCKSIZE

    # FIXED: the order with the smallest sum of absolute residuals
    diffs = [X]
    for _ in range(4):
        prev = diffs[-1]
        diffs.append(np.concatenate([prev[:, :1], prev[:, 1:] - prev[:, :-1]], axis=1))
    fixed_abs = np.stack([np.abs(r, dtype=np.int64, where=inside & (idx >= o),
                                 out=np.zeros(r.shape, np.int64)).sum(axis=1)
                          for o, r in enumerate(diffs)], axis=1)
    fixed_order = np.argmin(fixed_abs, axis=1)
    fixed_r = diffs[0]
    for o in range(1, 5):
        fixed_r = np.where((fixed_order == o)[:, None], diffs[o], fixed_r)
    del diffs

    # LPC on a Tukey(0.5) window, order by libFLAC's expected bits
    w = np.zeros((F, BLOCKSIZE))
    for m in np.unique(n):
        t = np.arange(m)
        taper = max(int(0.25 * m), 1)
        win = np.ones(m)
        ramp = 0.5 * (1 - np.cos(np.pi * t[:taper] / taper))
        win[:taper], win[m - taper:] = ramp, ramp[::-1]
        w[n == m, :m] = win
    Xw = X * w
    del w
    R = np.stack([np.einsum("fi,fi->f", Xw[:, l:], Xw[:, :BLOCKSIZE - l])
                  for l in range(MAX_LPC_ORDER + 1)], axis=1)
    coefs, errs = _levinson(R, MAX_LPC_ORDER)
    orders = np.arange(1, MAX_LPC_ORDER + 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_sample = np.maximum(0.5 * np.log2(0.5 / n[None, :] * errs), 0.0)
    per_sample = np.where(errs > 0, per_sample, 0.0)
    est = per_sample * (n[None, :] - orders[:, None]) + orders[:, None] * (16 + QLP_PRECISION)
    lpc_order = orders[np.argmin(est, axis=0)]
    lp = coefs[lpc_order - 1, np.arange(F)]
    qlp, shift, usable = _quantize(lp, lpc_order)
    usable &= n > lpc_order
    qlp = qlp.astype(np.int32)
    Xp = np.concatenate([np.zeros((F, MAX_LPC_ORDER), np.int32), X], axis=1)
    pred = np.zeros((F, BLOCKSIZE), np.int32)
    for j in range(MAX_LPC_ORDER):
        pred += qlp[:, j:j + 1] * Xp[:, MAX_LPC_ORDER - 1 - j:MAX_LPC_ORDER - 1 - j + BLOCKSIZE]
    lpc_r = X - (pred >> shift[:, None].astype(np.int32))
    del pred, Xp

    # keep the cheaper of the two by the partitioned rice estimate
    f_valid = inside & (idx >= fixed_order[:, None])
    l_valid = inside & (idx >= lpc_order[:, None])
    f_plan = _partition_plan(_zigzag(fixed_r), f_valid, full)
    l_plan = _partition_plan(_zigzag(lpc_r), l_valid, full)
    f_bits = f_plan[2] + 16 * fixed_order
    l_bits = np.where(usable, l_plan[2] + 16 * lpc_order + 9 + QLP_PRECISION * lpc_order, np.inf)
    use_lpc = l_bits < f_bits
    order = np.where(use_lpc, lpc_order, fixed_order)
    res = np.where(use_lpc[:, None], lpc_r, fixed_r)
    valid = np.where(use_lpc[:, None], l_valid, f_valid)
    p_order = np.where(use_lpc, l_plan[0], f_plan[0])
    k_fine = np.where(use_lpc[:, None], l_plan[1], f_plan[1])
    constant = (np.where(inside, X, X[:, :1]) == X[:, :1]).all(axis=1)
    verbatim = ~constant & (np.minimum(f_bits, l_bits) >= 16 * n)
    coded = ~constant & ~verbatim

    # bit lengths: the rice code of each residual, the partition parameters
    zz = _zigzag(res)
    k = np.repeat(k_fine.astype(np.int32), BLOCKSIZE >> MAX_PARTITION_ORDER, axis=1)
    q = zz >> k
    code_bits = np.where(valid & coded[:, None], q + 1 + k, 0)
    part_len = BLOCKSIZE >> p_order
    # each partition's parameter precedes its first coded residual
    first_of_part = valid & coded[:, None] & (
        (idx == order[:, None]) | (idx % part_len[:, None] == 0))
    param_bits = np.where(first_of_part, 4, 0)
    headers = [_frame_header(int(fn), int(m), rate) for fn, m in zip(frame_no, n)]
    head_bits = np.array([len(h) * 8 for h in headers], np.int64)
    sub_head = head_bits + 8
    body_fixed = np.where(constant, 16, np.where(verbatim, 16 * n, 16 * order + 6
                          + np.where(use_lpc, 9 + QLP_PRECISION * order, 0)))
    frame_bits = sub_head + body_fixed + (code_bits + param_bits).sum(axis=1)
    frame_bytes = -(-frame_bits // 8) + 2
    # stream layout: each file's 42-byte header, then its frames
    before = np.cumsum(frame_bytes) - frame_bytes
    frame_start = 42 * (file_of + 1) + before
    file_bytes = 42 + np.bincount(file_of, weights=frame_bytes,
                                  minlength=len(lens)).astype(np.int64)
    file_start = np.cumsum(file_bytes) - file_bytes
    at = frame_start * 8  # bit position of each frame

    fields = _Fields()
    hb = np.frombuffer(b"".join(headers), np.uint8)
    h_len = head_bits // 8
    h_at = np.repeat(at, h_len) + 8 * (np.arange(len(hb)) - np.repeat(np.cumsum(h_len) - h_len, h_len))
    fields.add(h_at, hb, 8)
    sub_type = np.where(constant, 0, np.where(verbatim, 1, np.where(use_lpc, 32 | (order - 1),
                                                                     8 | order)))
    fields.add(at + head_bits, sub_type << 1, 8)
    cur = at + sub_head
    u16 = X & 0xFFFF
    fields.add(cur, np.where(constant, u16[:, 0], 0), 16)
    n_raw = np.where(verbatim, n, np.where(coded, order, 0))
    fields.add(cur[:, None] + 16 * idx, np.where(idx < n_raw[:, None], u16, 0), 16)
    cur = cur + 16 * np.where(coded, order, 0)
    lpc = coded & use_lpc
    fields.add(cur, np.where(lpc, QLP_PRECISION - 1, 0), 4)
    fields.add(cur + 4, np.where(lpc, shift, 0), 5)
    jj = np.arange(MAX_LPC_ORDER)[None, :]
    fields.add(cur[:, None] + 9 + QLP_PRECISION * jj,
               np.where(lpc[:, None] & (jj < order[:, None]), qlp & ((1 << QLP_PRECISION) - 1), 0),
               QLP_PRECISION)
    cur = cur + np.where(lpc, 9 + QLP_PRECISION * order, 0)
    fields.add(cur, np.where(coded, p_order, 0), 6)  # method 0, then the order
    cur = cur + 6
    start = cur[:, None] + np.cumsum(code_bits + param_bits, axis=1, dtype=np.int64) - code_bits
    fields.add(start - 4, np.where(first_of_part, k, 0), 4)
    # a rice code: q zeros, then a one and the k low bits as one field
    live = code_bits > 0
    fields.add(start + q, np.where(live, (1 << k) | (zz & ((1 << k) - 1)), 0), k + 1)
    total = int(file_bytes.sum())
    buf = fields.pack(total)

    # CRC-16 of each frame, over every byte before it
    body_len = frame_bytes - 2
    span = int(body_len.max())
    crc = np.zeros(F, np.int64)
    for j in range(span):
        live = j < body_len
        b = buf[np.minimum(frame_start + j, total - 1)].astype(np.int64)
        nxt = ((crc << 8) & 0xFFFF) ^ CRC16[((crc >> 8) ^ b) & 0xFF]
        crc = np.where(live, nxt, crc)
    end = frame_start + body_len
    buf[end] = (crc >> 8).astype(np.uint8)
    buf[end + 1] = (crc & 0xFF).astype(np.uint8)

    out = []
    for i, u in enumerate(utterances):
        s = int(file_start[i])
        info = _streaminfo(len(u), rate, u)
        buf[s:s + 42] = np.frombuffer(info, np.uint8)
        out.append(buf[s:s + int(file_bytes[i])].tobytes())
    return out


def _streaminfo(total: int, rate: int, samples: np.ndarray) -> bytes:
    """``fLaC`` and the STREAMINFO block (last metadata block) with the MD5."""
    bs = BLOCKSIZE
    v = (bs << 16 | bs) << 48  # min/max blocksize, then min/max frame size 0
    word = (rate << 44) | (0 << 41) | (15 << 36) | total
    md5 = hashlib.md5(np.ascontiguousarray(samples, "<i2").tobytes()).digest()
    body = v.to_bytes(10, "big") + word.to_bytes(8, "big") + md5
    return b"fLaC" + bytes([0x80]) + len(body).to_bytes(3, "big") + body

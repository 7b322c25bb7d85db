"""Plain NumPy FLAC decoder: the benchmark's second witness for FLAC.

Written from the FLAC format (RFC 9639): STREAMINFO, frame headers,
CONSTANT, VERBATIM, FIXED and LPC subframes, wasted bits, rice and rice2
residuals with escaped partitions, and the four channel assignments.  The
structural walk and the rice codes are scalar Python over a stream's bits;
the predictor runs over every subframe of the given streams at once, one
sample step at a time.  It imports nothing of the program under test.

``predict="float32"`` sums the predictor in float32 instead of exactly: the
control, which breaks the lossless guarantee the configurations state.
"""

from __future__ import annotations

import numpy as np

_BLOCK = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608, 8: 256, 9: 512, 10: 1024,
          11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768}
_BPS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
FIXED = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]


class _Bits:
    """MSB-first reader over a whole stream, with each position's next set
    bit and 32-bit window precomputed for the rice codes."""

    def __init__(self, data: bytes):
        bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.n = len(bits)
        ones = np.flatnonzero(bits)
        nxt = np.full(self.n + 1, self.n, np.int64)
        nxt[ones] = ones
        self.next1 = np.minimum.accumulate(nxt[::-1])[::-1].tolist()
        byts = np.concatenate([np.frombuffer(data, np.uint8), np.zeros(6, np.uint8)])
        word = np.zeros(len(data) + 1, np.int64)  # the 40 bits from each byte on
        for b in range(5):
            word = (word << 8) | byts[b:b + len(data) + 1]
        p = np.arange(self.n + 1)
        self.win = ((word[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF).tolist()
        self.pos = 0

    def get(self, k: int) -> int:
        v = 0
        while k > 0:
            take = min(k, 32)
            v = (v << take) | (self.win[self.pos] >> (32 - take))
            self.pos += take
            k -= take
        return v

    def signed(self, k: int) -> int:
        v = self.get(k)
        return v - (1 << k) if k and v >> (k - 1) else v

    def unary(self) -> int:
        o = self.next1[self.pos]
        q = o - self.pos
        self.pos = o + 1
        return q

    def rice(self, count: int, k: int) -> list[int]:
        out = []
        nxt, win = self.next1, self.win
        p = self.pos
        for _ in range(count):
            o = nxt[p]
            v = ((o - p) << k) | ((win[o + 1] >> (32 - k)) if k else 0)
            out.append((v >> 1) ^ -(v & 1))
            p = o + 1 + k
        self.pos = p
        return out


def _utf8(bits: _Bits) -> int:
    b = bits.get(8)
    n = 0
    while b & (0x80 >> n):
        n += 1
    v = b & ((1 << (7 - n)) - 1) if n else b
    for _ in range(max(n - 1, 0)):
        v = (v << 6) | (bits.get(8) & 0x3F)
    return v


def _subframe(bits: _Bits, n: int, bps: int) -> dict:
    bits.get(1)
    kind = bits.get(6)
    wasted = 0
    if bits.get(1):
        wasted = bits.unary() + 1
    bps -= wasted
    sub = dict(n=n, wasted=wasted)
    if kind == 0:
        sub.update(kind="constant", value=bits.signed(bps))
        return sub
    if kind == 1:
        sub.update(kind="verbatim", samples=[bits.signed(bps) for _ in range(n)])
        return sub
    if 8 <= kind <= 12:
        order, coefs, shift = kind - 8, FIXED[kind - 8], 0
        warm = [bits.signed(bps) for _ in range(order)]
    elif kind >= 32:
        order = kind - 31
        warm = [bits.signed(bps) for _ in range(order)]
        precision = bits.get(4) + 1
        shift = bits.signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coefs = [bits.signed(precision) for _ in range(order)]
    else:
        raise ValueError(f"reserved subframe type {kind}")
    method = bits.get(2)
    pbits, escape = (4, 15) if method == 0 else (5, 31)
    porder = bits.get(4)
    res: list[int] = []
    for p in range(1 << porder):
        count = (n >> porder) - (order if p == 0 else 0)
        k = bits.get(pbits)
        if k == escape:
            width = bits.get(5)
            res.extend(bits.signed(width) for _ in range(count))
        else:
            res.extend(bits.rice(count, k))
    sub.update(kind="lpc", order=order, coefs=coefs, shift=shift, warm=warm, res=res)
    return sub


def _walk(blob: bytes):
    """(STREAMINFO fields, [(channel assignment, [subframes])]) of a stream."""
    if blob[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    info = None
    while True:
        last, btype = blob[pos] >> 7, blob[pos] & 0x7F
        size = int.from_bytes(blob[pos + 1:pos + 4], "big")
        if btype == 0:
            w = int.from_bytes(blob[pos + 14:pos + 22], "big")
            info = dict(rate=w >> 44, channels=((w >> 41) & 7) + 1,
                        bps=((w >> 36) & 31) + 1, total=w & ((1 << 36) - 1))
        pos += 4 + size
        if last:
            break
    bits = _Bits(blob)
    bits.pos = pos * 8
    frames = []
    done = 0
    while done < info["total"]:
        if bits.get(15) != 0x7FFC:
            raise ValueError("lost frame sync")
        bits.get(1)  # blocking strategy
        bs_code, rate_code = bits.get(4), bits.get(4)
        chan, size_code = bits.get(4), bits.get(3)
        bits.get(1)
        _utf8(bits)
        if bs_code == 6:
            n = bits.get(8) + 1
        elif bs_code == 7:
            n = bits.get(16) + 1
        else:
            n = _BLOCK[bs_code]
        if rate_code == 12:
            bits.get(8)
        elif rate_code in (13, 14):
            bits.get(16)
        bits.get(8)  # CRC-8
        bps = _BPS.get(size_code, info["bps"])
        n_ch = chan + 1 if chan < 8 else 2
        subs = []
        for c in range(n_ch):
            side = (chan == 8 and c == 1) or (chan == 9 and c == 0) or (chan == 10 and c == 1)
            subs.append(_subframe(bits, n, bps + side))
        bits.pos = -(-bits.pos // 8) * 8 + 16  # byte padding, CRC-16
        frames.append((chan, subs))
        done += n
    return info, frames


def _predict(subs: list[dict], predict: str) -> list[np.ndarray]:
    """Every coded subframe reconstructed at once, one sample step at a time."""
    S = len(subs)
    nmax = max(s["n"] for s in subs)
    omax = max([s["order"] for s in subs] + [1])
    order = np.array([s["order"] for s in subs])
    shift = np.array([s["shift"] for s in subs])
    coefs = np.zeros((S, omax), np.int64)
    x = np.zeros((S, nmax + omax), np.int64)  # sample i at column omax + i
    res = np.zeros((S, nmax), np.int64)
    for i, s in enumerate(subs):
        coefs[i, :s["order"]] = s["coefs"]
        x[i, omax:omax + s["order"]] = s["warm"]
        res[i, s["order"]:s["n"]] = s["res"]
    scale = np.ldexp(np.float32(1.0), -shift).astype(np.float32)
    for t in range(nmax):
        col = omax + t
        if predict == "float32":
            acc = np.zeros(S, np.float32)
            for j in range(omax):
                acc = acc + coefs[:, j].astype(np.float32) * x[:, col - 1 - j].astype(np.float32)
            pred = np.floor(acc * scale).astype(np.int64)
        else:
            pred = np.einsum("sj,sj->s", coefs, x[:, col - omax:col][:, ::-1]) >> shift
        live = t >= order
        x[:, col] = np.where(live, res[:, t] + pred, x[:, col])
    return [x[i, omax:omax + s["n"]] for i, s in enumerate(subs)]


def decode_many(blobs: list[bytes], predict: str = "exact") -> list[np.ndarray]:
    """Integer samples ``[frames, channels]`` of each stream."""
    walked = [_walk(b) for b in blobs]
    coded = [s for _, frames in walked for _, subs in frames for s in subs
             if s["kind"] == "lpc"]
    recon = iter(_predict(coded, predict) if coded else [])
    out = []
    for info, frames in walked:
        blocks = []
        for chan, subs in frames:
            chans = []
            for s in subs:
                if s["kind"] == "constant":
                    v = np.full(s["n"], s["value"], np.int64)
                elif s["kind"] == "verbatim":
                    v = np.asarray(s["samples"], np.int64)
                else:
                    v = next(recon)
                chans.append(v << s["wasted"])
            if chan == 8:
                chans = [chans[0], chans[0] - chans[1]]
            elif chan == 9:
                chans = [chans[0] + chans[1], chans[1]]
            elif chan == 10:
                mid = (chans[0] << 1) | (chans[1] & 1)
                chans = [(mid + chans[1]) >> 1, (mid - chans[1]) >> 1]
            blocks.append(np.stack(chans, axis=1))
        out.append(np.concatenate(blocks)[:info["total"]])
    return out

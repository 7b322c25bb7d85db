"""Plain NumPy decoder of MPEG-1 Layer III streams: the benchmark's reference.

A straightforward frame-by-frame decoder written from ISO/IEC 11172-3:
frame sync, side info, bit reservoir, scalefactors, Huffman, requantisation,
reorder, M/S and intensity stereo, antialias, hybrid IMDCT and the
polyphase synthesis filterbank.  It computes in float64 and carries its own
tables (``mp3_tables``); it imports nothing of the program under test.

The Huffman walk is scalar Python; every stage after it is vectorised over
a granule's lines, and the synthesis over a whole channel.  ``rounding``
stores every stage's output through a function (the control passes a
bfloat16 rounding, so the stages compute in the precision below the
float32 the configuration states).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from . import mp3_tables as T

Rounding = Callable[[np.ndarray], np.ndarray]


def _exact(x: np.ndarray) -> np.ndarray:
    return x


# --- frame walk ------------------------------------------------------------


def parse_header(word: int) -> dict | None:
    """An MPEG-1 Layer III header word → its fields, or None."""
    if (word >> 21) & 0x7FF != 0x7FF:
        return None
    version, layer = (word >> 19) & 3, (word >> 17) & 3
    br_idx, sr_idx = (word >> 12) & 0xF, (word >> 10) & 3
    if version != 3 or layer != 1 or br_idx in (0, 15) or sr_idx == 3:
        return None
    bitrate = int(T.BITRATE_KBPS[br_idx - 1][2]) * 1000
    sr = T.SAMPLE_RATES[sr_idx]
    padding = (word >> 9) & 1
    mode = (word >> 6) & 3
    return dict(crc=not ((word >> 16) & 1), bitrate=bitrate, sr=sr,
                padding=padding, mode=mode, mode_ext=(word >> 4) & 3,
                frame_len=144 * bitrate // sr + padding,
                channels=1 if mode == 3 else 2)


def _side_len(channels: int) -> int:
    return 17 if channels == 1 else 32


def _payload_span(blob: bytes) -> tuple[int, int]:
    """[start, end) of the frames: past a leading ID3v2 tag, before a
    trailing ID3v1 tag."""
    start = 0
    if blob[:3] == b"ID3" and len(blob) >= 10:
        size = ((blob[6] & 0x7F) << 21) | ((blob[7] & 0x7F) << 14) \
            | ((blob[8] & 0x7F) << 7) | (blob[9] & 0x7F)
        start = 10 + size
    end = len(blob)
    if end >= 128 and blob[end - 128:end - 125] == b"TAG":
        end -= 128
    return start, end


def find_frames(blob: bytes) -> list[tuple[int, dict]]:
    """Every Layer III frame as (offset, header): a sync walk that steps
    over junk byte by byte and drops a leading Xing/Info/VBRI frame."""
    i, n = _payload_span(blob)
    frames: list[tuple[int, dict]] = []
    while i + 4 <= n:
        if blob[i] == 0xFF and (blob[i + 1] & 0xE0) == 0xE0:
            h = parse_header(int.from_bytes(blob[i:i + 4], "big"))
            if h is not None and i + h["frame_len"] <= n:
                if frames or not _is_info_frame(blob, i, h):
                    frames.append((i, h))
                i += h["frame_len"]
                continue
        i += 1
    return frames


def _is_info_frame(blob: bytes, pos: int, h: dict) -> bool:
    xo = pos + 4 + (2 if h["crc"] else 0) + _side_len(h["channels"])
    return blob[xo:xo + 4] in (b"Xing", b"Info") or blob[pos + 36:pos + 40] == b"VBRI"


# --- bits --------------------------------------------------------------------


class Bits:
    """MSB-first reader over one frame's main data, held as one integer."""

    def __init__(self, data: bytes):
        self.n = len(data) * 8
        self.word = int.from_bytes(data, "big")
        self.pos = 0

    def peek(self, k: int) -> int:
        """The next ``k`` bits (zeros past the end), without moving."""
        shift = self.n - self.pos - k
        if shift >= 0:
            return (self.word >> shift) & ((1 << k) - 1)
        return (self.word << -shift) & ((1 << k) - 1)

    def get(self, k: int) -> int:
        v = self.peek(k) if k else 0
        self.pos += k
        return v


def _lut(codes: dict, maxlen: int) -> list[int]:
    """Prefix table: entry ``peek(maxlen)`` → value << 8 | code length."""
    lut = np.full(1 << maxlen, -1, np.int64)
    for value, (length, code) in codes.items():
        lo = code << (maxlen - length)
        lut[lo:lo + (1 << (maxlen - length))] = (value << 8) | length
    return lut.tolist()


_BIG: dict[int, tuple[int, list[int]]] = {}
_C1: dict[int, list[int]] = {}


def _big_lut(tid: int) -> tuple[int, list[int]]:
    if tid not in _BIG:
        codes = T.BIG_TABLES[tid]
        maxlen = max(length for length, _ in codes.values())
        packed = {(x << 4) | y: lc for (x, y), lc in codes.items()}
        _BIG[tid] = (maxlen, _lut(packed, maxlen))
    return _BIG[tid]


def _count1_lut(sel: int) -> list[int]:
    if sel not in _C1:
        _C1[sel] = _lut(T.COUNT1_TABLES[sel], 6)
    return _C1[sel]


# --- side info, scalefactors, Huffman -------------------------------------


def read_side_info(bits: Bits, channels: int) -> dict:
    si = dict(main_data_begin=bits.get(9))
    bits.get(5 if channels == 1 else 3)  # private bits
    si["scfsi"] = [[bits.get(1) for _ in range(4)] for _ in range(channels)]
    si["gr"] = []
    for _gr in range(2):
        chs = []
        for _ch in range(channels):
            g = dict(part2_3_length=bits.get(12), big_values=bits.get(9),
                     global_gain=bits.get(8), scalefac_compress=bits.get(4),
                     window_switching=bits.get(1))
            if g["window_switching"]:
                g["block_type"] = bits.get(2)
                g["mixed"] = bits.get(1)
                g["table_select"] = [bits.get(5), bits.get(5), 0]
                g["subblock_gain"] = [bits.get(3) for _ in range(3)]
                g["region0_count"], g["region1_count"] = 7, 36
            else:
                g["block_type"], g["mixed"] = 0, 0
                g["table_select"] = [bits.get(5), bits.get(5), bits.get(5)]
                g["subblock_gain"] = [0, 0, 0]
                g["region0_count"] = bits.get(4)
                g["region1_count"] = bits.get(3)
            g["preflag"] = bits.get(1)
            g["scalefac_scale"] = bits.get(1)
            g["count1table_select"] = bits.get(1)
            g["short"] = bool(g["window_switching"] and g["block_type"] == 2)
            chs.append(g)
        si["gr"].append(chs)
    return si


def _scalefacs(bits: Bits, g: dict, gr: int, scfsi, prev) -> dict:
    slen1 = int(T.SLEN1[g["scalefac_compress"]])
    slen2 = int(T.SLEN2[g["scalefac_compress"]])
    sf_l = np.zeros(23, np.int64)
    sf_s = np.zeros((13, 3), np.int64)
    if g["short"]:
        if g["mixed"]:
            for sfb in range(8):
                sf_l[sfb] = bits.get(slen1)
            first = 3
        else:
            first = 0
        for sfb in range(first, 12):
            sl = slen1 if sfb < 6 else slen2
            for w in range(3):
                sf_s[sfb, w] = bits.get(sl)
    else:
        for gi, (lo, hi, sl) in enumerate(((0, 6, slen1), (6, 11, slen1),
                                           (11, 16, slen2), (16, 21, slen2))):
            if gr == 1 and scfsi[gi]:
                sf_l[lo:hi] = prev["l"][lo:hi]
            else:
                for sfb in range(lo, hi):
                    sf_l[sfb] = bits.get(sl)
    return dict(l=sf_l, s=sf_s)


def _huffman(bits: Bits, g: dict, sr: int, part2_start: int) -> np.ndarray:
    """The 576 quantised lines of one granule-channel."""
    is_ = [0] * 576
    if g["window_switching"]:
        region1, region2 = 36, 576
    else:
        bands = T.SFB_LONG[sr]
        region1 = int(bands[g["region0_count"] + 1])
        region2 = int(bands[min(g["region0_count"] + g["region1_count"] + 2, 22)])
    end = part2_start + g["part2_3_length"]
    big = 2 * g["big_values"]
    idx = 0
    while idx < big:
        if bits.pos > end:
            raise ValueError("huffman overrun")
        region = 0 if idx < region1 else (1 if idx < region2 else 2)
        tid, linbits = T.TABLE_INFO[g["table_select"][region]]
        if tid < 0:
            raise ValueError("reserved huffman table")
        x = y = 0
        if tid:
            maxlen, lut = _big_lut(tid)
            hit = lut[bits.peek(maxlen)]
            if hit < 0:
                raise ValueError("invalid huffman code")
            bits.pos += hit & 0xFF
            x, y = (hit >> 12) & 0xF, (hit >> 8) & 0xF
            if x == 15 and linbits:
                x += bits.get(linbits)
            if x and bits.get(1):
                x = -x
            if y == 15 and linbits:
                y += bits.get(linbits)
            if y and bits.get(1):
                y = -y
        if idx < 576:
            is_[idx] = x
        if idx + 1 < 576:
            is_[idx + 1] = y
        idx += 2
    lut = _count1_lut(g["count1table_select"])
    while bits.pos < end and idx < 576:
        hit = lut[bits.peek(6)]
        bits.pos += hit & 0xFF
        v = hit >> 8
        for q in ((v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1):
            if idx >= 576:
                break
            if q and bits.get(1):
                q = -q
            is_[idx] = q
            idx += 1
    if bits.pos > end:  # a quad straddling the end is discarded
        for k in range(max(idx - 4, 0), idx):
            is_[k] = 0
    bits.pos = end
    return np.asarray(is_, np.int64)


# --- the DSP stages --------------------------------------------------------


def _requantize(is_: np.ndarray, g: dict, sf: dict, sr: int) -> np.ndarray:
    exp = np.zeros(576)
    gg = g["global_gain"] - 210
    mult = 0.5 * (1 + g["scalefac_scale"])
    lb, sb = T.SFB_LONG[sr], T.SFB_SHORT[sr]
    if g["short"]:
        if g["mixed"]:
            for sfb in range(8):
                exp[lb[sfb]:lb[sfb + 1]] = 0.25 * gg - mult * (
                    sf["l"][sfb] + g["preflag"] * T.PRETAB[sfb])
        for sfb in range(3 if g["mixed"] else 0, 13):
            lo, hi = int(sb[sfb]), int(sb[sfb + 1])
            w_ = hi - lo
            for w in range(3):
                exp[lo * 3 + w * w_:lo * 3 + (w + 1) * w_] = 0.25 * (
                    gg - 8 * g["subblock_gain"][w]) - mult * sf["s"][sfb, w]
    else:
        for sfb in range(22):
            exp[lb[sfb]:lb[sfb + 1]] = 0.25 * gg - mult * (
                sf["l"][sfb] + g["preflag"] * T.PRETAB[sfb])
    return np.sign(is_) * np.abs(is_).astype(np.float64) ** (4.0 / 3.0) * 2.0 ** exp


def _reorder(xr: np.ndarray, g: dict, sr: int) -> np.ndarray:
    """Short blocks: band-window-line order → line-window order."""
    if not g["short"]:
        return xr
    out = xr.copy()
    sb = T.SFB_SHORT[sr]
    for sfb in range(3 if g["mixed"] else 0, 13):
        lo, hi = int(sb[sfb]), int(sb[sfb + 1])
        w_ = hi - lo
        out[lo * 3:hi * 3] = xr[lo * 3:hi * 3].reshape(3, w_).T.reshape(-1)
    return out


def _stereo(xl, xr, g_r, sf_r, h, sr):
    """M/S and intensity stereo (ISO 2.4.3.4.9)."""
    if h["mode"] != 1:
        return xl, xr
    ms, intensity = bool(h["mode_ext"] & 2), bool(h["mode_ext"] & 1)
    s2 = 1.0 / np.sqrt(2.0)
    if not intensity:
        if ms:
            return (xl + xr) * s2, (xl - xr) * s2
        return xl, xr
    L, R = xl.copy(), xr.copy()
    lb, sb = T.SFB_LONG[sr], T.SFB_SHORT[sr]

    def band(sl, is_pos):
        if is_pos == 7:
            if ms:
                L[sl] = (xl[sl] + xr[sl]) * s2
                R[sl] = (xl[sl] - xr[sl]) * s2
        else:
            ratio = T.IS_RATIO[is_pos]
            L[sl] = xl[sl] * (ratio / (1 + ratio))
            R[sl] = xl[sl] * (1 / (1 + ratio))

    short, mixed = g_r["short"], g_r["short"] and g_r["mixed"]
    bound_line = 0
    if not short or mixed:
        nz = np.nonzero(xr)[0]
        rzero = int(nz[-1]) + 1 if len(nz) else 0
        n_long = 8 if mixed else 22
        bound = 21
        while bound > 0 and int(lb[bound]) >= rzero:
            bound -= 1
        bound = bound + 1 if rzero else 0
        for sfb in range(min(bound, n_long), n_long):
            band(slice(int(lb[sfb]), int(lb[sfb + 1])),
                 int(sf_r["l"][min(sfb, 20)]) if sfb < 21 else 7)
        bound_line = int(lb[min(bound, n_long)])
    if short:
        for w in range(3):
            bound_w = 0
            for sfb in range(13):
                seg = np.arange(int(sb[sfb]) * 3 + w, int(sb[sfb + 1]) * 3, 3)
                if np.any(xr[seg]):
                    bound_w = sfb + 1
            for sfb in range(3 if mixed else 0, 13):
                seg = np.arange(int(sb[sfb]) * 3 + w, int(sb[sfb + 1]) * 3, 3)
                if sfb >= bound_w:
                    band(seg, int(sf_r["s"][min(sfb, 11), w]))
                elif ms:
                    L[seg] = (xl[seg] + xr[seg]) * s2
                    R[seg] = (xl[seg] - xr[seg]) * s2
        if not mixed:
            return L, R
    if ms:
        L[:bound_line] = (xl[:bound_line] + xr[:bound_line]) * s2
        R[:bound_line] = (xl[:bound_line] - xr[:bound_line]) * s2
    return L, R


_AA_LO = np.array([18 * sb - 1 - i for sb in range(1, 32) for i in range(8)])
_AA_HI = np.array([18 * sb + i for sb in range(1, 32) for i in range(8)])
_AA_CS = np.tile(T.AA_CS, 31)
_AA_CA = np.tile(T.AA_CA, 31)


def _antialias(xr: np.ndarray, g: dict) -> np.ndarray:
    if g["short"] and not g["mixed"]:
        return xr
    n = 8 if g["short"] else 8 * 31  # mixed blocks: the first boundary only
    lo, hi = _AA_LO[:n], _AA_HI[:n]
    a, b = xr[lo], xr[hi]
    out = xr.copy()
    out[lo] = a * _AA_CS[:n] - b * _AA_CA[:n]
    out[hi] = b * _AA_CS[:n] + a * _AA_CA[:n]
    return out


def _imdct(xr: np.ndarray, g: dict, overlap: np.ndarray) -> np.ndarray:
    """Hybrid IMDCT, overlap-add and frequency inversion → [32, 18]."""
    X = xr.reshape(32, 18)
    raw = np.zeros((32, 36))
    long_sb = np.ones(32, bool)
    if g["short"]:
        long_sb[2 if g["mixed"] else 0:] = False
    if long_sb.any():
        bt = 0 if g["short"] else g["block_type"]
        raw[long_sb] = X[long_sb] @ T.WIN_IMDCT36[bt].T
    if not long_sb.all():
        Xs = X[~long_sb]
        for w in range(3):
            raw[~long_sb, 6 + 6 * w:18 + 6 * w] += Xs[:, w::3] @ T.WIN_IMDCT12.T
    ts = raw[:, :18] + overlap
    overlap[:] = raw[:, 18:]
    ts[1::2, 1::2] *= -1.0
    return ts


def synthesize(ts: np.ndarray, rounding: Rounding = _exact) -> np.ndarray:
    """Polyphase synthesis of one channel: subband samples [32, T] → PCM [T*32].

    v_t = N @ s_t; out[t, j] = Σ_i D[64i+j] v_{t-2i}[j] + D[64i+32+j] v_{t-2i-1}[32+j].
    """
    n_t = ts.shape[1]
    v = rounding(T.SYNTH_N @ ts)  # [64, T]
    vp = np.concatenate([np.zeros((64, 16)), v], axis=1)  # v_{t-k} = vp[:, 16+t-k]
    out = np.zeros((32, n_t))
    for i in range(8):
        a, b = 16 - 2 * i, 16 - 2 * i - 1
        out += T.SYNTH_D[64 * i:64 * i + 32, None] * vp[:32, a:a + n_t]
        out += T.SYNTH_D[64 * i + 32:64 * i + 64, None] * vp[32:, b:b + n_t]
    return rounding(out.T.reshape(-1))


def decode(blob: bytes, rounding: Rounding = _exact) -> tuple[np.ndarray, int]:
    """Decode an MPEG-1 Layer III stream → (PCM float64 [frames, channels],
    sample rate).  A frame whose bit reservoir reaches before the stream
    decodes to silence; frames of another rate or channel count are skipped."""
    frames = find_frames(blob)
    if not frames:
        raise ValueError("no MPEG-1 Layer III frames")
    sr, ch = frames[0][1]["sr"], frames[0][1]["channels"]
    frames = [(p, h) for p, h in frames if h["sr"] == sr and h["channels"] == ch]
    reservoir = b""
    overlap = [np.zeros((32, 18)) for _ in range(ch)]
    ts = np.zeros((ch, len(frames) * 2, 32, 18))
    for k, (pos, h) in enumerate(frames):
        off = pos + 4 + (2 if h["crc"] else 0)
        side_len = _side_len(ch)
        side = read_side_info(Bits(blob[off:off + side_len]), ch)
        main = blob[off + side_len:pos + h["frame_len"]]
        start = len(reservoir) - side["main_data_begin"]
        if start < 0:
            reservoir = (reservoir + main)[-4096:]
            continue
        bits = Bits(reservoir[start:] + main)
        prev = [None] * ch
        for gr in range(2):
            xrs, sfs = [], []
            for c in range(ch):
                g = side["gr"][gr][c]
                part2_start = bits.pos
                sf = _scalefacs(bits, g, gr, side["scfsi"][c], prev[c])
                prev[c] = sf
                xr = rounding(_requantize(_huffman(bits, g, sr, part2_start), g, sf, sr))
                xrs.append(_reorder(xr, g, sr))
                sfs.append(sf)
            if ch == 2:
                xrs = [rounding(x) for x in _stereo(xrs[0], xrs[1], side["gr"][gr][1],
                                                    sfs[1], h, sr)]
            for c in range(ch):
                g = side["gr"][gr][c]
                xr = rounding(_antialias(xrs[c], g))
                ts[c, 2 * k + gr] = rounding(_imdct(xr, g, overlap[c]))
        reservoir = (reservoir + main)[-4096:]
    # [ch, granule, subband, 18] → per channel [32, granules*18]
    sub = ts.transpose(0, 2, 1, 3).reshape(ch, 32, -1)
    pcm = np.stack([synthesize(sub[c], rounding) for c in range(ch)], axis=1)
    return pcm, sr


def huffman_bits(blob: bytes) -> tuple[int, int]:
    """(granule-channels, bits of part2_3 data they code) of a stream: the
    work of a Layer III entropy decode, from the side info alone."""
    lanes = coded = 0
    for pos, h in find_frames(blob):
        off = pos + 4 + (2 if h["crc"] else 0)
        si = read_side_info(Bits(blob[off:off + _side_len(h["channels"])]),
                            h["channels"])
        for gr in si["gr"]:
            for g in gr:
                lanes += 1
                coded += g["part2_3_length"]
    return lanes, coded

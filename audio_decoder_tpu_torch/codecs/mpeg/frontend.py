# Verbatim copy of audio_decoder_tpu/codecs/mpeg/frontend.py (that package imports jax on import).
"""Host bitstream front-end for MPEG-1 Layer III.

Entropy decoding is bit-serial (frame sync, bit reservoir, Huffman) and
belongs on the host; the dense DSP belongs on the TPU.  This module walks
the bitstream once per file and emits the dense per-granule tensors
consumed by ``dsp.mp3_dsp_tail``:

* ``is_q``  int16  [G, C, 576] — signed quantized spectrum, linbits folded
  in, already in final line order (short-block reorder applied via a
  precomputed permutation);
* ``scale`` f32    [G, C, 576] — per-line requantizer gain ``2^exp``
  folding global_gain, scalefactors, subblock_gain, preflag and
  scalefac_scale (ISO 2.4.3.4.7.1);
* ``st``    f32    [G, 4, 576] — per-line stereo mixing planes
  (aL, bL, aR, bR): identity for LR, the 1/sqrt(2) butterfly for MS, and
  the tan(is_pos*pi/12) ratio pair for intensity bands (ISO 2.4.3.4.9);
* ``win_idx`` int8 [G, C, 32] — IMDCT window per subband (block type, with
  2 = the composite short matrix; mixed blocks use 0 for subbands 0-1);
* ``aa_bound`` int8 [G, C] — number of antialias boundaries (0/1/31).

A pure-Python reference implementation lives here; the production path is
the C++ ``mp3fe`` shared library (same output contract), used when built.

Completes the reference's decode TODO (blast/src/main.rs:44-54; its
mpeg.rs:7-128 stops at frame framing and returns compressed bytes).
Corrects the reference's header-table defects (SURVEY §5 items 1-5):
proper bitrate column select, per-frame padding, 4/6-byte header+CRC skip.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...core import errors as E
from . import huffman_tables as HT
from . import tables as T

# Decode maps: (length, code) -> value, per table.
_DEC_BIG = {
    t: {lc: xy for xy, lc in codes.items()} for t, codes in HT.BIG_TABLES.items()
}
_DEC_C1 = {
    s: {lc: v for v, lc in codes.items()} for s, codes in HT.COUNT1_TABLES.items()
}
_MAXLEN_BIG = {t: max(length for length, _ in m) for t, m in _DEC_BIG.items()}

_ISQRT2 = 1.0 / np.sqrt(2.0)


class _Bits:
    """MSB-first bit reader."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        pos = self.pos
        data = self.data
        for _ in range(n):
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def get1(self) -> int:
        pos = self.pos
        self.pos = pos + 1
        return (self.data[pos >> 3] >> (7 - (pos & 7))) & 1


def parse_header(word: int) -> dict | None:
    """32-bit header word → fields (≙ mpeg.rs:367-496 with the bitrate
    column select corrected — SURVEY §5 defect 1)."""
    if (word >> 21) & 0x7FF != 0x7FF:
        return None
    version = (word >> 19) & 3
    layer = (word >> 17) & 3
    crc = not ((word >> 16) & 1)
    br_idx = (word >> 12) & 0xF
    sr_idx = (word >> 10) & 3
    padding = (word >> 9) & 1
    mode = (word >> 6) & 3
    mode_ext = (word >> 4) & 3
    if version == 1 or layer == 0 or br_idx == 15 or sr_idx == 3:
        return None
    sr = T.SAMPLE_RATES[version][sr_idx]
    if br_idx == 0:
        # free format: constant (nonstandard) bitrate; the frame length is
        # measured from sync spacing by the scanner (frame_len = 0 here)
        bitrate, slots = 0, 0
    else:
        bitrate = (
            int(T.BITRATE_KBPS[br_idx - 1][T.bitrate_column(version, layer)])
            * 1000
        )
        if layer == 1:  # Layer III
            slots = (144 if version == 3 else 72) * bitrate // sr + padding
        elif layer == 2:  # Layer II
            slots = 144 * bitrate // sr + padding
        else:  # Layer I
            slots = (12 * bitrate // sr + padding) * 4
    return dict(
        version=version, layer=layer, crc=crc, bitrate=bitrate, sr=sr,
        padding=padding, mode=mode, mode_ext=mode_ext, frame_len=int(slots),
        channels=1 if mode == 3 else 2,
    )


def skip_id3v2(blob: bytes, i: int = 0) -> int:
    """Return the offset just past an ID3v2 tag at ``i`` (synchsafe size),
    or ``i`` unchanged.  Real-world files lead with these; skipping avoids
    false sync matches inside tag payloads."""
    if blob[i : i + 3] == b"ID3" and len(blob) >= i + 10:
        size = (
            ((blob[i + 6] & 0x7F) << 21)
            | ((blob[i + 7] & 0x7F) << 14)
            | ((blob[i + 8] & 0x7F) << 7)
            | (blob[i + 9] & 0x7F)
        )
        return i + 10 + size
    return i


def scan_end(blob: bytes) -> int:
    """Byte length of ``blob`` with trailing metadata tags stripped:
    ID3v1 ('TAG', 128 B), ID3v1 Enhanced ('TAG+', 227 B before the ID3v1
    tag), APEv2 (32-byte 'APETAGEX' footer carrying the tag size), and
    Lyrics3v2 ('LYRICS200' end marker preceded by a 6-digit size).  Tags
    can stack (APE/Lyrics3 sit before ID3v1), so strip to a fixed point.

    Tag payloads are free-form text/binary that can contain spurious
    valid-looking frame syncs; bounding the frame walk here keeps a
    low-bitrate false sync inside a comment field from appending a
    garbage frame (the reference's statistical scan, mpeg.rs:17-50, scans
    tag bytes too — mpg123/real decoders strip these)."""
    n = len(blob)
    while True:
        if n >= 128 and blob[n - 128 : n - 125] == b"TAG":
            n -= 128
            # the Enhanced tag is a 227-byte extension written directly
            # before its ID3v1 tag; only valid paired with one
            if n >= 227 and blob[n - 227 : n - 223] == b"TAG+":
                n -= 227
            continue
        if n >= 32 and blob[n - 32 : n - 24] == b"APETAGEX":
            size = int.from_bytes(blob[n - 20 : n - 16], "little")
            flags = int.from_bytes(blob[n - 12 : n - 8], "little")
            # size covers footer + items; bit 31 says a 32-byte header
            # precedes them
            total = size + (32 if flags & 0x80000000 else 0)
            if 32 <= total <= n:
                n -= total
                continue
        if n >= 15 and blob[n - 9 : n] == b"LYRICS200":
            six = blob[n - 15 : n - 9]
            if six.isdigit():
                total = int(six) + 15  # size excludes the size+end fields
                if total <= n:
                    n -= total
                    continue
        return n


def probe_layer(blob: bytes) -> int:
    """Layer of the first valid frame: 1 (header code 3), 2, or 3 — or 0
    when no frame is found.  Routes Layer I/II streams to layer12.py."""
    i = skip_id3v2(blob)
    n = scan_end(blob)
    while i + 4 <= n:
        if blob[i] == 0xFF and (blob[i + 1] & 0xE0) == 0xE0:
            h = parse_header(int.from_bytes(blob[i : i + 4], "big"))
            if h is not None and i + h["frame_len"] <= n:
                return {1: 3, 2: 2, 3: 1}[h["layer"]]
        i += 1
    return 0


def _xing_offset(pos: int, h: dict) -> int:
    """Byte offset of a Xing/Info tag inside a Layer III frame at `pos`:
    past the 4-byte header, the optional CRC-16, and the version/channel-
    sized side info (17/32 for MPEG-1 mono/stereo, 9/17 for LSF).  The
    single source of this geometry — shared by the info-frame skip and
    the LAME gapless tag reader so the two can never desynchronize."""
    off = pos + 4 + (2 if h["crc"] else 0)
    if h["version"] == 3:
        side = 17 if h["channels"] == 1 else 32
    else:
        side = 9 if h["channels"] == 1 else 17
    return off + side


def _is_info_frame(blob: bytes, pos: int, h: dict) -> bool:
    """Xing/Info/VBRI metadata frame detection (first frame of VBR/LAME
    files): a decoder must skip it — it carries no audio."""
    if h["layer"] != 1:  # tags live in Layer III streams
        return False
    xo = _xing_offset(pos, h)
    if blob[xo : xo + 4] in (b"Xing", b"Info"):
        return True
    return blob[pos + 36 : pos + 40] == b"VBRI"


def crc16(data: bytes, crc: int = 0xFFFF) -> int:
    """MPEG CRC-16: polynomial 0x8005, MSB-first, init 0xFFFF
    (ISO 11172-3 2.4.3.1)."""
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = (
                ((crc << 1) ^ 0x8005) if crc & 0x8000 else (crc << 1)
            ) & 0xFFFF
    return crc


def crc_check(blob: bytes, pos: int, h: dict) -> bool | None:
    """Verify a protected frame's CRC-16; None when the frame is
    unprotected or not Layer III.

    The checksum covers the last two header bytes plus the side info and
    sits in the two bytes after the header.  Decoders (the reference,
    mpg123's default) skip it; this is the verification they omit —
    surfaced by the inspect CLI and usable by callers that want strict
    ingest."""
    if not h["crc"] or h["layer"] != 1:
        return None
    if h["version"] == 3:
        side = 17 if h["channels"] == 1 else 32
    else:
        side = 9 if h["channels"] == 1 else 17
    end = pos + 6 + side
    if end > len(blob):
        return False
    stored = int.from_bytes(blob[pos + 4 : pos + 6], "big")
    return crc16(blob[pos + 2 : pos + 4] + blob[pos + 6 : end]) == stored


def _free_format_base(blob: bytes, i: int, h: dict) -> int:
    """Measure a free-format stream's base frame size: distance from the
    frame at ``i`` to the next sync with matching header fields, minus
    this frame's padding slot."""
    n = scan_end(blob)
    step = 1 if h["layer"] != 3 else 4  # Layer I slots are 4 bytes
    j = i + 16
    while j + 4 <= n and j - i < 8192:
        if blob[j] == 0xFF and (blob[j + 1] & 0xE0) == 0xE0:
            h2 = parse_header(int.from_bytes(blob[j : j + 4], "big"))
            if (
                h2 is not None
                and h2["bitrate"] == 0
                and h2["version"] == h["version"]
                and h2["layer"] == h["layer"]
                and h2["sr"] == h["sr"]
            ):
                return (j - i) - h["padding"] * step
        j += 1
    return 0


def find_frames(blob: bytes) -> list[tuple[int, dict]]:
    """Sequential sync walk with resync-on-junk (robust form of the
    reference's statistical scan, mpeg.rs:17-121).  A leading Xing/Info/
    VBRI metadata frame is dropped; free-format (bitrate_index 0) frame
    lengths are measured from sync spacing; trailing ID3v1/APE/Lyrics3
    tags are excluded from the scan (``scan_end``)."""
    frames = []
    i = skip_id3v2(blob)
    n = scan_end(blob)
    free_base = 0
    while i + 4 <= n:
        if blob[i] == 0xFF and (blob[i + 1] & 0xE0) == 0xE0:
            h = parse_header(int.from_bytes(blob[i : i + 4], "big"))
            if h is not None and h["bitrate"] == 0:
                if not free_base:
                    free_base = _free_format_base(blob, i, h)
                if free_base:
                    step = 1 if h["layer"] != 3 else 4
                    h["frame_len"] = free_base + h["padding"] * step
            if h is not None and h["frame_len"] > 0 and i + h["frame_len"] <= n:
                if frames or not _is_info_frame(blob, i, h):
                    frames.append((i, h))
                i += h["frame_len"]
                continue
        i += 1
    return frames


def _read_side_info(bits: _Bits, channels: int, version: int = 3) -> dict:
    lsf = version != 3
    si = dict(main_data_begin=bits.get(8 if lsf else 9))
    if lsf:
        bits.get(1 if channels == 1 else 2)  # private bits
        si["scfsi"] = [[0] * 4 for _ in range(channels)]
        ngr = 1
    else:
        bits.get(5 if channels == 1 else 3)  # private bits
        si["scfsi"] = [[bits.get1() for _ in range(4)] for _ in range(channels)]
        ngr = 2
    si["ngr"] = ngr
    si["gr"] = []
    for _gr in range(ngr):
        chs = []
        for _ch in range(channels):
            g = dict(
                version=version,
                part2_3_length=bits.get(12),
                big_values=bits.get(9),
                global_gain=bits.get(8),
                scalefac_compress=bits.get(9 if lsf else 4),
                window_switching=bits.get1(),
            )
            if g["window_switching"]:
                g["block_type"] = bits.get(2)
                g["mixed"] = bits.get1()
                g["table_select"] = [bits.get(5), bits.get(5), 0]
                g["subblock_gain"] = [bits.get(3) for _ in range(3)]
                g["region0_count"] = 7
                g["region1_count"] = 36
            else:
                g["block_type"] = 0
                g["mixed"] = 0
                g["table_select"] = [bits.get(5), bits.get(5), bits.get(5)]
                g["subblock_gain"] = [0, 0, 0]
                g["region0_count"] = bits.get(4)
                g["region1_count"] = bits.get(3)
            # LSF has no preflag bit — it derives from scalefac_compress
            g["preflag"] = 0 if lsf else bits.get1()
            g["scalefac_scale"] = bits.get1()
            g["count1table_select"] = bits.get1()
            chs.append(g)
        si["gr"].append(chs)
    return si


def _read_scalefacs_lsf(bits: _Bits, g: dict, i_stereo: bool = False) -> dict:
    """LSF scalefactors (ISO 13818-3 2.4.3.2): four groups of nr_of_sfb
    values at slen bits each; sets g['preflag'] from the category.

    For the intensity-coded channel (i_stereo) the layout key is
    scalefac_compress >> 1 and the slot counts differ; the values double
    as is_pos AND as normal requant gains below the intensity bound
    (both pinned to mpg123, tests/test_intensity_lsf.py)."""
    short = g["window_switching"] and g["block_type"] == 2
    kind = (2 if g["mixed"] else 1) if short else 0
    if i_stereo:
        slen, nr = T.lsf_scalefac_layout_istereo(g["scalefac_compress"], kind)
        preflag = 0
    else:
        slen, nr, preflag = T.lsf_scalefac_layout(g["scalefac_compress"], kind)
    g["preflag"] = preflag
    sf_l = np.zeros(23, np.int32)
    sf_s = np.zeros((13, 3), np.int32)
    seq = []
    for k in range(4):
        for _ in range(nr[k]):
            seq.append(bits.get(slen[k]) if slen[k] else 0)
    i = 0
    if kind == 0:
        for sfb in range(21):
            sf_l[sfb] = seq[i]
            i += 1
    elif kind == 1:
        for sfb in range(12):
            for w in range(3):
                sf_s[sfb, w] = seq[i]
                i += 1
    else:
        for sfb in range(6):
            sf_l[sfb] = seq[i]
            i += 1
        for sfb in range(3, 12):
            for w in range(3):
                sf_s[sfb, w] = seq[i]
                i += 1
    return dict(l=sf_l, s=sf_s)


def _read_scalefacs(bits: _Bits, g: dict, gr: int, scfsi, prev) -> dict:
    slen1 = int(T.SLEN1[g["scalefac_compress"]])
    slen2 = int(T.SLEN2[g["scalefac_compress"]])
    sf_l = np.zeros(23, np.int32)
    sf_s = np.zeros((13, 3), np.int32)
    short = g["window_switching"] and g["block_type"] == 2
    if short and not g["mixed"]:
        for sfb in range(6):
            for w in range(3):
                sf_s[sfb, w] = bits.get(slen1)
        for sfb in range(6, 12):
            for w in range(3):
                sf_s[sfb, w] = bits.get(slen2)
    elif short and g["mixed"]:
        for sfb in range(8):
            sf_l[sfb] = bits.get(slen1)
        for sfb in range(3, 6):
            for w in range(3):
                sf_s[sfb, w] = bits.get(slen1)
        for sfb in range(6, 12):
            for w in range(3):
                sf_s[sfb, w] = bits.get(slen2)
    else:
        groups = [(0, 6, slen1), (6, 11, slen1), (11, 16, slen2), (16, 21, slen2)]
        for gi, (lo, hi, sl) in enumerate(groups):
            if gr == 1 and scfsi[gi]:
                sf_l[lo:hi] = prev["l"][lo:hi]
            else:
                for sfb in range(lo, hi):
                    sf_l[sfb] = bits.get(sl)
    return dict(l=sf_l, s=sf_s)


def _huffman_spectrum(bits: _Bits, g: dict, sr: int, part2_start: int) -> np.ndarray:
    is_ = np.zeros(576, np.int32)
    if g["window_switching"]:
        region1 = T.ws_region1_lines(g.get("version", 3), g["block_type"], sr)
        region2 = 576
    else:
        bands = T.SFB_LONG[sr]
        region1 = int(bands[g["region0_count"] + 1])
        region2 = int(bands[min(g["region0_count"] + g["region1_count"] + 2, 22)])
    big = 2 * g["big_values"]
    idx = 0
    get1 = bits.get1
    end = part2_start + g["part2_3_length"]
    while idx < big:
        if bits.pos > end:  # ISO: big_values lie inside part2_3_length;
            # crossing it is stream corruption (mpg123's part2 accounting)
            raise E.InvalidDataError("huffman overrun")
        region = 0 if idx < region1 else (1 if idx < region2 else 2)
        tsel = g["table_select"][region]
        tid, linbits = HT.TABLE_INFO[tsel]
        if tid < 0:
            raise E.InvalidDataError("reserved huffman table")
        if tid == 0:
            x = y = 0
        else:
            dec = _DEC_BIG[tid]
            maxlen = _MAXLEN_BIG[tid]
            code, length = 0, 0
            hit = None
            while length <= maxlen:
                code = (code << 1) | get1()
                length += 1
                hit = dec.get((length, code))
                if hit is not None:
                    break
            if hit is None:
                raise E.InvalidDataError("invalid huffman code")
            x, y = hit
            if x == 15 and linbits:
                x += bits.get(linbits)
            if x and get1():
                x = -x
            if y == 15 and linbits:
                y += bits.get(linbits)
            if y and get1():
                y = -y
        if idx < 576:
            is_[idx] = x
        if idx + 1 < 576:
            is_[idx + 1] = y
        idx += 2
    if bits.pos > end:
        raise E.InvalidDataError("huffman overrun")
    dec = _DEC_C1[g["count1table_select"]]
    while bits.pos < end and idx < 576:
        code, length = 0, 0
        v = None
        while length <= 6:
            code = (code << 1) | get1()
            length += 1
            v = dec.get((length, code))
            if v is not None:
                break
        if v is None:
            raise E.InvalidDataError("invalid count1 code")
        for q in ((v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1):
            if idx >= 576:
                break
            if q:
                q = -q if get1() else q
            is_[idx] = q
            idx += 1
    if bits.pos > end:  # quad straddling part2_3 boundary is discarded
        is_[max(idx - 4, 0) : idx] = 0
    bits.pos = end
    return is_


# ---------------------------------------------------------------------------
# Dense-tensor emission
# ---------------------------------------------------------------------------

# Short-block reorder permutations: out = in[perm].  Keyed (sr, mixed).
_REORDER: dict[tuple[int, int], np.ndarray] = {}


def _reorder_perm(sr: int, mixed: int) -> np.ndarray:
    key = (sr, mixed)
    p = _REORDER.get(key)
    if p is None:
        p = np.arange(576, dtype=np.int64)
        bands = T.SFB_SHORT[sr]
        for sfb in range(3 if mixed else 0, 13):
            lo, hi = int(bands[sfb]), int(bands[sfb + 1])
            w_ = hi - lo
            base = lo * 3
            for i in range(w_):
                for w in range(3):
                    p[base + i * 3 + w] = base + w * w_ + i
        _REORDER[key] = p
    return p


def _exp_bands(g: dict, sf: dict) -> np.ndarray:
    """Per-band requantizer exponent ×4, int16 [61].

    Slot layout: 0..21 = long sfb, 22 + sfb*3 + w = short (sfb, window).
    ``4·exp`` is an exact integer (exp = 0.25·(gg − 8·sbg) − sf_mult·sf with
    sf_mult ∈ {0.5, 1}), so the device payload is a tiny int16 vector; the
    jitted tail expands it per line through a static line→band map and
    computes gain = 2^(exp4/4) on device."""
    e = np.zeros(61, np.int16)
    gg = g["global_gain"] - 210
    sf_mult4 = 2 * (1 + g["scalefac_scale"])  # 4 * sf_mult
    short = g["window_switching"] and g["block_type"] == 2
    lsf = g.get("version", 3) != 3
    if not short or g["mixed"]:
        # mixed long region: 8 sfbs (MPEG-1) / 6 sfbs (LSF), both to line 36
        hi_sfb = (6 if lsf else 8) if short else 22
        for sfb in range(hi_sfb):
            e[sfb] = gg - sf_mult4 * (
                int(sf["l"][sfb]) + g["preflag"] * int(T.PRETAB[sfb])
            )
    if short:
        for sfb in range(3 if g["mixed"] else 0, 13):
            for w in range(3):
                e[22 + sfb * 3 + w] = (gg - 8 * g["subblock_gain"][w]) - sf_mult4 * int(
                    sf["s"][sfb, w]
                )
    return e


#: stereo-mode byte values (per spectral line): the device expands these
#: through dsp.ST_LUT into (aL, bL, aR, bR) mixing coefficients.
ST_LR = 0  # identity (independent L/R)
ST_MS = 1  # mid/side butterfly
ST_IS0 = 2  # intensity, is_pos k → mode 2+k (k = 0..15, MPEG-1 tan ratios)
ST_LSF0 = 18  # LSF intensity: mode 18 + intensity_scale*32 + is_pos (0..31)


def _stereo_modes(
    is_l, is_r, g_r, sf_r, header, sr, lsf: bool = False, i_scale: int = 0
) -> np.ndarray:
    """Per-line stereo mode byte, int8 [576].

    Mirrors the oracle's `_stereo` (ISO 2.4.3.4.9): MS over the full
    spectrum (or below the intensity bound), intensity ratio bands above
    the right channel's zero region; inputs are in final line order.

    Intensity semantics are pinned to mpg123 via hand-crafted probe
    streams (tests/mp3_writer.py + tests/test_intensity*.py): bound at
    the band past the right channel's last nonzero line (per window for
    short blocks); is_pos 7 → MS when enabled else untouched (both
    families).  MPEG-1 applies tan(is_pos·π/12) ratio pairs to the left
    spectrum; LSF scales one channel by io^k (io = 2^-(i_scale+1)/4,
    odd is_pos → left, even → right, 0 → plain copy).
    """
    modes = np.zeros(576, np.int8)
    if header["mode"] != 1:
        return modes
    ms = bool(header["mode_ext"] & 2)
    intensity = bool(header["mode_ext"] & 1)

    def set_ms(sl):
        modes[sl] = ST_MS

    def set_is(sl, is_pos):
        if is_pos == 7:
            if ms:
                set_ms(sl)
            return
        if lsf:
            modes[sl] = ST_LSF0 + i_scale * 32 + min(is_pos, 31)
        else:
            modes[sl] = ST_IS0 + min(is_pos, 15)

    if not intensity:
        if ms:
            set_ms(slice(0, 576))
        return modes

    short = g_r["window_switching"] and g_r["block_type"] == 2
    mixed = short and g_r["mixed"]
    long_bands = T.SFB_LONG[sr]
    short_bands = T.SFB_SHORT[sr]
    bound_line = 0
    if not short or mixed:
        # bound from the GLOBAL last nonzero: in mixed blocks any
        # short-region content pushes it past the whole long part
        nz = np.nonzero(is_r)[0]
        rzero = (int(nz[-1]) + 1) if len(nz) else 0
        n_long = ((6 if lsf else 8) if mixed else 22)
        bound_sfb = 21
        while bound_sfb > 0 and int(long_bands[bound_sfb]) >= rzero:
            bound_sfb -= 1
        bound_sfb += 1
        if rzero == 0:  # fully empty right: band 0 included
            bound_sfb = 0
        for sfb in range(min(bound_sfb, n_long), n_long):
            lo, hi = int(long_bands[sfb]), int(long_bands[sfb + 1])
            set_is(slice(lo, hi), int(sf_r["l"][min(sfb, 20)]) if sfb < 21 else 7)
        bound_line = int(long_bands[min(bound_sfb, n_long)])
    if short:
        # short blocks: per-window bound at the band past the window's last
        # nonzero; segments are STRIDED in reordered line space (validated
        # against mpg123 via crafted streams, tests/test_intensity*.py);
        # mixed blocks only have short bands from sfb 3 (lines >= 36)
        first_sfb = 3 if mixed else 0
        for w in range(3):
            bound_w = 0
            for sfb in range(13):
                lo3, hi3 = int(short_bands[sfb]) * 3, int(short_bands[sfb + 1]) * 3
                if np.any(is_r[lo3 + w : hi3 : 3]):
                    bound_w = sfb + 1
            for sfb in range(first_sfb, 13):
                lo3, hi3 = int(short_bands[sfb]) * 3, int(short_bands[sfb + 1]) * 3
                seg = np.arange(lo3 + w, hi3, 3)
                if sfb >= bound_w:
                    set_is(seg, int(sf_r["s"][min(sfb, 11), w]))
                elif ms:
                    set_ms(seg)
        if not mixed:
            return modes
    if ms:
        set_ms(slice(0, bound_line))
    return modes


def _blockcfg(g: dict) -> int:
    """One byte per granule-channel: block_type | mixed<<2 (the device
    expands this into IMDCT window selects and antialias bounds)."""
    return g["block_type"] | (g["mixed"] << 2)


@dataclasses.dataclass
class Mp3Analysis:
    """Dense front-end output for one file (inputs to dsp.mp3_dsp_tail).

    Transfer-compact by design: the jitted tail expands per-band ``exp_b``
    into per-line 2^(e/4) gains, ``st_mode`` into mixing planes, and
    ``blockcfg`` into window selects/antialias bounds — all on device — so
    the host→TPU payload is ~1.5 KB/granule instead of ~11.5 KB."""

    sample_rate: int
    channels: int
    n_granules: int
    joint_stereo: bool
    is_q: np.ndarray  # int16 [G, C, 576]
    exp_b: np.ndarray  # int16 [G, C, 61] — 4× exponent per band slot
    st_mode: np.ndarray | None  # int8 [G, 576] (None if mono / never joint)
    blockcfg: np.ndarray  # int8 [G, C] — block_type | mixed<<2

    @property
    def rate_idx(self) -> int:
        return T.RATE_IDX[self.sample_rate]


@dataclasses.dataclass
class Mp3Lanes:
    """Lane metadata for on-device Huffman decode (huffman_device.py).

    The host parses only fixed-size structures (headers, side info,
    scalefactors); the raw concatenated main_data goes to the device, so
    the host→TPU payload per file is the compressed bitstream itself plus
    ~50 bytes of metadata per granule."""

    sample_rate: int
    channels: int
    n_granules: int
    joint_stereo: bool
    main_data: np.ndarray  # uint8 [M], zero-padded to M % 4 == 0
    start_bit: np.ndarray  # int32 [G, C] Huffman start (abs bit in main_data)
    end_bit: np.ndarray  # int32 [G, C] part2_3 end
    limit_bit: np.ndarray  # int32 [G, C] end of the frame's readable data
    big_values: np.ndarray  # int16 [G, C]
    region1: np.ndarray  # int16 [G, C] region boundary (line index)
    region2: np.ndarray  # int16 [G, C]
    tsel: np.ndarray  # int8 [G, C, 3]
    c1sel: np.ndarray  # int8 [G, C]
    valid: np.ndarray  # int8 [G, C]
    exp_b: np.ndarray  # int16 [G, C, 61]
    blockcfg: np.ndarray  # int8 [G, C]
    st_flags: np.ndarray  # int8 [G]: bit0 joint, bit1 ms, bit2 intensity,
    #                       bit3 LSF intensity_scale
    sfr_bands: np.ndarray  # int8 [G, 61] right-channel scalefactors

    @property
    def rate_idx(self) -> int:
        return T.RATE_IDX[self.sample_rate]


def analyze_lanes(blob: bytes) -> Mp3Lanes:
    """Host half of the on-device-Huffman decode path.

    Walks frames, side info and scalefactors (all fixed-size reads) and
    computes every granule-channel's absolute Huffman bit window into the
    concatenated main_data stream — the bit reservoir (main_data_begin)
    is just a backward offset into that same stream."""
    frames = find_frames(blob)
    frames = [(p, h) for p, h in frames if h["layer"] == 1]
    if not frames:
        raise E.InvalidDataError("no Layer III frames")
    h0 = frames[0][1]
    sr, ch, ver = h0["sr"], h0["channels"], h0["version"]
    lsf = ver != 3
    ngr = 1 if lsf else 2
    frames = [
        (p, h) for p, h in frames
        if h["sr"] == sr and h["channels"] == ch and h["version"] == ver
    ]
    joint = any(h["mode"] == 1 for _, h in frames)

    G = ngr * len(frames)
    start_bit = np.zeros((G, ch), np.int32)
    end_bit = np.zeros((G, ch), np.int32)
    limit_bit = np.zeros((G, ch), np.int32)
    big_values = np.zeros((G, ch), np.int16)
    region1 = np.zeros((G, ch), np.int16)
    region2 = np.zeros((G, ch), np.int16)
    tsel = np.zeros((G, ch, 3), np.int8)
    c1sel = np.zeros((G, ch), np.int8)
    valid = np.zeros((G, ch), np.int8)
    exp_b = np.zeros((G, ch, 61), np.int16)
    blockcfg = np.zeros((G, ch), np.int8)
    st_flags = np.zeros((G,), np.int8)
    sfr_bands = np.zeros((G, 61), np.int8)

    total_main = bytearray()
    fi = 0
    for pos, h in frames:
        gbase = ngr * fi
        fi += 1
        if lsf:
            side_len = 9 if ch == 1 else 17
        else:
            side_len = 17 if ch == 1 else 32
        off = pos + 4 + (2 if h["crc"] else 0)
        main = bytes(blob[off + side_len : pos + h["frame_len"]])
        try:
            side = _read_side_info(_Bits(blob[off : off + side_len]), ch, ver)
        except (IndexError, E.DecodeError):
            total_main += main
            continue
        start_byte_abs = len(total_main) - side["main_data_begin"]
        if start_byte_abs < 0:
            total_main += main
            continue  # silent frame (reservoir underflow)
        data = bytes(total_main[start_byte_abs:]) + main
        limit = (start_byte_abs + len(data)) * 8
        bits = _Bits(data)
        base_bits = start_byte_abs * 8
        prev_sf: list = [None] * ch
        ok = True
        for gr in range(ngr):
            if not ok:
                break
            for c in range(ch):
                g = side["gr"][gr][c]
                part2_rel = bits.pos
                end_rel = part2_rel + g["part2_3_length"]
                if end_rel > len(data) * 8:
                    ok = False
                    break
                i_st = (
                    c == 1 and h["mode"] == 1 and bool(h["mode_ext"] & 1)
                )
                try:
                    if lsf:
                        sf = _read_scalefacs_lsf(bits, g, i_stereo=i_st)
                    else:
                        sf = _read_scalefacs(
                            bits, g, gr, side["scfsi"][c], prev_sf[c]
                        )
                except (IndexError, E.DecodeError):
                    ok = False
                    break
                prev_sf[c] = sf
                gi = gbase + gr
                start_bit[gi, c] = base_bits + bits.pos
                end_bit[gi, c] = base_bits + end_rel
                limit_bit[gi, c] = limit
                big_values[gi, c] = g["big_values"]
                if g["window_switching"]:
                    region1[gi, c] = T.ws_region1_lines(ver, g["block_type"], sr)
                    region2[gi, c] = 576
                else:
                    bands = T.SFB_LONG[sr]
                    region1[gi, c] = int(bands[g["region0_count"] + 1])
                    region2[gi, c] = int(
                        bands[min(g["region0_count"] + g["region1_count"] + 2, 22)]
                    )
                tsel[gi, c] = g["table_select"]
                c1sel[gi, c] = g["count1table_select"]
                exp_b[gi, c] = _exp_bands(g, sf)
                blockcfg[gi, c] = _blockcfg(g)
                valid[gi, c] = 1
                if c == ch - 1:
                    st_flags[gi] = (
                        (1 if h["mode"] == 1 else 0)
                        | ((h["mode_ext"] & 2) >> 1 << 1)
                        | ((h["mode_ext"] & 1) << 2)
                        | (
                            (g["scalefac_compress"] & 1) << 3
                            if (lsf and i_st) else 0
                        )
                    )
                    if ch == 2:
                        sfr_bands[gi, :22] = sf["l"][:22]
                        sfr_bands[gi, 22:] = sf["s"].reshape(-1)
                bits.pos = end_rel  # jump over the Huffman region
        if not ok:
            valid[gbase : gbase + ngr] = 0
        total_main += main

    pad = (-len(total_main)) % 4
    main_np = np.frombuffer(bytes(total_main) + b"\x00" * pad, np.uint8)
    return Mp3Lanes(
        sample_rate=sr, channels=ch, n_granules=G, joint_stereo=joint,
        main_data=main_np, start_bit=start_bit, end_bit=end_bit,
        limit_bit=limit_bit, big_values=big_values, region1=region1,
        region2=region2, tsel=tsel, c1sel=c1sel, valid=valid, exp_b=exp_b,
        blockcfg=blockcfg, st_flags=st_flags, sfr_bands=sfr_bands,
    )


def _huffman_from_lane(
    bits: _Bits, start: int, end: int, big: int, r1: int, r2: int,
    tsel, c1sel: int,
) -> np.ndarray:
    """Host Huffman decode of one lane window (the same contract the
    device decoder runs): bit range [start, end) of the concatenated
    main_data stream → 576 pre-reorder lines."""
    is_ = np.zeros(576, np.int32)
    bits.pos = start
    idx = 0
    get1 = bits.get1
    while idx < 2 * big:
        if bits.pos > end:  # ISO part2_3 bound (≙ device scan's per-pair
            # overrun fail; bounds every lane's reachable bit span)
            raise E.InvalidDataError("huffman overrun")
        region = 0 if idx < r1 else (1 if idx < r2 else 2)
        tid, linbits = HT.TABLE_INFO[int(tsel[region])]
        if tid < 0:
            raise E.InvalidDataError("reserved huffman table")
        if tid == 0:
            x = y = 0
        else:
            dec = _DEC_BIG[tid]
            maxlen = _MAXLEN_BIG[tid]
            code, length, hit = 0, 0, None
            while length <= maxlen:
                code = (code << 1) | get1()
                length += 1
                hit = dec.get((length, code))
                if hit is not None:
                    break
            if hit is None:
                raise E.InvalidDataError("invalid huffman code")
            x, y = hit
            if x == 15 and linbits:
                x += bits.get(linbits)
            if x and get1():
                x = -x
            if y == 15 and linbits:
                y += bits.get(linbits)
            if y and get1():
                y = -y
        if idx < 576:
            is_[idx] = x
        if idx + 1 < 576:
            is_[idx + 1] = y
        idx += 2
    if bits.pos > end:
        raise E.InvalidDataError("huffman overrun")
    dec = _DEC_C1[c1sel]
    while bits.pos < end and idx < 576:
        code, length, v = 0, 0, None
        while length <= 6:
            code = (code << 1) | get1()
            length += 1
            v = dec.get((length, code))
            if v is not None:
                break
        if v is None:
            raise E.InvalidDataError("invalid count1 code")
        for q in ((v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1):
            if idx >= 576:
                break
            if q:
                q = -q if get1() else q
            is_[idx] = q
            idx += 1
    if bits.pos > end:
        is_[max(idx - 4, 0) : idx] = 0
    return is_


def analyze(blob: bytes) -> Mp3Analysis:
    """Walk a Layer III stream → dense per-granule tensors (host-Huffman
    variant of the decode pipeline).

    Built on ``analyze_lanes`` — one shared frame/side-info/scalefactor
    walk — plus host entropy decode of each lane window (the exact
    contract the on-device decoder runs, so the two stay bit-identical).
    Undecodable granules become silence, matching the reference's
    per-file catch-and-skip (main.rs:55-77)."""
    ln = analyze_lanes(blob)
    G, ch = ln.n_granules, ln.channels
    ngr = 1 if ln.rate_idx >= 3 else 2
    sr = ln.sample_rate

    is_q = np.zeros((G, ch, 576), np.int16)
    st_mode = (
        np.zeros((G, 576), np.int8)
        if (ch == 2 and ln.joint_stereo) else None
    )
    data = ln.main_data.tobytes()
    bits = _Bits(data)
    for gbase in range(0, G, ngr):
        try:
            frame_is = np.zeros((ngr, ch, 576), np.int32)
            for gr in range(ngr):
                gi = gbase + gr
                for c in range(ch):
                    if not ln.valid[gi, c]:
                        continue
                    pre = _huffman_from_lane(
                        bits, int(ln.start_bit[gi, c]), int(ln.end_bit[gi, c]),
                        int(ln.big_values[gi, c]), int(ln.region1[gi, c]),
                        int(ln.region2[gi, c]), ln.tsel[gi, c],
                        int(ln.c1sel[gi, c]),
                    )
                    cfgb = int(ln.blockcfg[gi, c])
                    if (cfgb & 3) == 2:  # short: reorder to line order
                        pre = pre[_reorder_perm(sr, (cfgb >> 2) & 1)]
                    frame_is[gr, c] = pre
            for gr in range(ngr):
                gi = gbase + gr
                is_q[gi] = frame_is[gr].astype(np.int16)
                if st_mode is not None and ln.valid[gi].all():
                    flags = int(ln.st_flags[gi])
                    header = dict(
                        mode=1 if flags & 1 else 0,
                        mode_ext=((flags >> 1) & 1) * 2 + ((flags >> 2) & 1),
                    )
                    sf_r = dict(
                        l=ln.sfr_bands[gi, :22].astype(np.int32),
                        s=ln.sfr_bands[gi, 22:].reshape(13, 3).astype(np.int32),
                    )
                    cfgb = int(ln.blockcfg[gi, 1])
                    g_r = dict(
                        window_switching=1 if (cfgb & 3) else 0,
                        block_type=cfgb & 3,
                        mixed=(cfgb >> 2) & 1,
                    )
                    st_mode[gi] = _stereo_modes(
                        frame_is[gr, 0], frame_is[gr, 1], g_r, sf_r, header,
                        sr, lsf=(ngr == 1), i_scale=(flags >> 3) & 1,
                    )
        except (IndexError, E.DecodeError):
            is_q[gbase : gbase + ngr] = 0
            if st_mode is not None:
                st_mode[gbase : gbase + ngr] = 0

    return Mp3Analysis(
        sample_rate=sr, channels=ch, n_granules=G,
        joint_stereo=ln.joint_stereo, is_q=is_q, exp_b=ln.exp_b,
        st_mode=st_mode, blockcfg=ln.blockcfg,
    )


def lame_gapless(blob: bytes) -> dict | None:
    """Encoder delay/padding from a Xing/Info LAME tag (gapless decode).

    LAME-family encoders pad the stream: `delay` junk samples lead the
    audio and `padding` trail it, recorded as two 12-bit fields at byte
    21 of the LAME extension inside the Xing/Info metadata frame.  The
    reference never reads the tag (its mpeg.rs stops at framing and
    `is_info_frame` only *skips* it); decoders that honor it reproduce
    the encoder's input sample-exactly in position and length.

    Returns dict(delay, padding, frames, samples_per_frame) or None when
    the stream has no LAME tag."""
    i = skip_id3v2(blob)
    n = len(blob)
    while i + 4 <= n:
        if blob[i] == 0xFF and (blob[i + 1] & 0xE0) == 0xE0:
            cand = parse_header(int.from_bytes(blob[i : i + 4], "big"))
            if cand is not None and i + cand["frame_len"] <= n:
                got = _parse_lame_tag(blob, i, cand)
                if got is not None:
                    return got
                # No tag at this candidate: either the real (untagged)
                # first frame, or a FALSE sync in leading junk that the
                # decoder's statistical scan would skip right past.  Only
                # trust it if the next frame header confirms it;
                # otherwise keep scanning like the decoder does.
                j = i + cand["frame_len"]
                if j + 4 <= n and parse_header(
                    int.from_bytes(blob[j : j + 4], "big")
                ) is not None:
                    return None  # confirmed audio frame, stream untagged
        i += 1
    return None


def _parse_lame_tag(blob: bytes, pos: int, h: dict) -> dict | None:
    """Parse the Xing/Info + LAME extension of the frame at `pos`, or
    None when the frame carries no gapless tag."""
    if h["layer"] != 1:  # tags live in Layer III streams
        return None
    xo = _xing_offset(pos, h)
    t = blob[xo : xo + 160]
    if len(t) < 8 or t[:4] not in (b"Xing", b"Info"):
        return None
    flags = int.from_bytes(t[4:8], "big")
    p = 8
    frames = None
    if flags & 1:
        frames = int.from_bytes(t[p : p + 4], "big")
        p += 4
    if flags & 2:
        p += 4
    if flags & 4:
        p += 100
    if flags & 8:
        p += 4
    lame = t[p:]
    # the 36-byte LAME extension: 9-byte encoder string, delay/padding
    # packed into bytes 21..23
    if len(lame) < 24 or not lame[:4].isascii() or lame[:4] in (b"\x00" * 4,):
        return None
    delay = (lame[21] << 4) | (lame[22] >> 4)
    padding = ((lame[22] & 0xF) << 8) | lame[23]
    if delay == 0 and padding == 0:
        return None  # tag without gapless info
    return dict(
        delay=delay, padding=padding, frames=frames,
        samples_per_frame=1152 if h["version"] == 3 else 576,
    )

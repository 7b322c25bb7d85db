# Copy of audio_decoder_tpu/codecs/flac/frontend.py (that package imports jax on import); analyze_batch always runs the native walk.
"""FLAC host front-end: metadata + frame/subframe/partition walk.

Clear-room implementation from the public FLAC specification (RFC 9639 /
xiph.org format docs).  The reference project has no FLAC support — this
is a beyond-reference family, designed TPU-first like the MPEG one
(codecs/mpeg/frontend.py + native/mp3fe.cc): the host walks the
*structure* of the bitstream (frame boundaries, subframe types, rice
partition offsets — lengths only, no value decode) and emits flat lane
descriptors; the device then decodes every rice residual, runs the
predictors, stereo decorrelation and PCM assembly in one fused jitted
program (codecs/flac/device.py).

The walk must entropy-skip rice codes to find subframe boundaries (a
FLAC frame's length is not recorded anywhere — it ends where its last
residual ends).  The skip uses positions-of-set-bits + searchsorted, so
each code costs O(log n) in C, not a Python per-bit loop.

Descriptor contract (all numpy, absolute BIT offsets into the file):

* sublanes — one per (frame, channel) subframe: kind/order/shift/
  coeffs[32]/wasted/effective-bps.  FIXED predictors are expressed as
  LPC with the spec's integer coefficients and shift 0; VERBATIM is LPC
  order 0; CONSTANT is flagged (kind=1) and broadcast post-predictor.
* rice lanes — one per rice-coded partition: (sublane, bitpos, count,
  param, dest).  The device scan decodes values lane-parallel.
* fixed-width lanes — warmups, VERBATIM bodies, CONSTANT values and
  escaped (raw) partitions: (sublane, bitpos, count, width, dest);
  width may be 0 (escaped partitions with 5-bit width 0 ⇒ all zeros).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...core import errors as E
from . import native as _native

FIXED_COEFFS = ((), (1,), (2, -1), (3, -3, 1), (4, -6, 4, -1))

# Max unary quotient the device rice scan decodes in-lane.  Codes with
# a larger quotient are rare outliers — the walk, which entropy-skips
# every code anyway, splits the partition there and ships the value
# directly (``dv_*`` lanes), so ANY legal stream decodes exactly.
# The cap sizes the scan's per-step bit window (device.K_MAX): at 15
# the unary fits ONE 32-bit window read (no second-word lookahead) and
# a 6-code step fits 16 fetched words instead of 32 — the scan's cost
# is the per-lane column extraction, proportional to fetched words.
# Outlier rates measured at this cap: 0 on 30 s music, 0 on noise, 53
# on a pathological click train (each outlier costs 12 wire bytes and
# one lane split), vs 0/0/52 at the old cap of 40.
Q_CAP = 15

#: decoder-wide sample-size cap: device predictor arithmetic is exact for
#: samples to 26 bits (i32 + f32 residue reconstruction) and stereo side
#: channels carry one extra bit
MAX_BPS = 25

#: one-shot device bitstream cap: rice-lane bit positions ride int32 on
#: the device (codecs/flac/decoder.py packs rl_bitpos as i32), so one
#: fused program covers files to 2^31 bits (256 MiB); bigger files are
#: ROUTED, not rejected — decode_group rides the frame-chunked path
#: (stream.slice_frames rebases every chunk's positions near zero).
#: The walk itself carries int64 positions and has no size limit.
BIT_CAP = 1 << 31

#: max rice codes per device lane: long partitions are cut at every
#: RICE_SPLIT-th code during the walk (the cursor passes every code
#: anyway, so recording the cut positions is free).  Bounds the device
#: scan to RICE_SPLIT/K_CODES sequential steps and keeps the value
#: scatter dense — unsplit, one whole-frame partition forces every
#: lane's padding to the worst case (measured 2.9 s -> see PERFORMANCE).
RICE_SPLIT = 256

_BLOCKSIZE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608, 8: 256, 9: 512,
              10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768}
_SAMPLE_SIZE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_RATE = {0: 0, 1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
         6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}

_CRC8_TAB = None
_CRC16_TAB = None


def _crc_tables():
    """Byte-wise CRC tables for the frame-header CRC-8 (poly 0x07) and
    whole-frame CRC-16 (poly 0x8005), both init 0 — table-driven so host
    validation is numpy-speed."""
    global _CRC8_TAB, _CRC16_TAB
    if _CRC8_TAB is not None:
        return
    t8 = np.zeros(256, np.uint8)
    t16 = np.zeros(256, np.uint16)
    for b in range(256):
        r = b
        for _ in range(8):
            r = ((r << 1) ^ 0x07) & 0xFF if r & 0x80 else (r << 1) & 0xFF
        t8[b] = r
        r = b << 8
        for _ in range(8):
            r = ((r << 1) ^ 0x8005) & 0xFFFF if r & 0x8000 else (r << 1) & 0xFFFF
        t16[b] = r
    _CRC8_TAB, _CRC16_TAB = t8, t16


def crc8(data) -> int:
    r = _native.crc8(data)
    if r is not None:
        return r
    _crc_tables()
    r = 0
    for b in memoryview(data):
        r = _CRC8_TAB[r ^ b]
    return int(r)


def crc16(data) -> int:
    r = _native.crc16(data)
    if r is not None:
        return r
    _crc_tables()
    r = 0
    for b in memoryview(data):
        r = int(_CRC16_TAB[(r >> 8) ^ b]) ^ ((r << 8) & 0xFFFF)
    return int(r)


class _Bits:
    """MSB-first bit cursor over a byte blob.

    ``u(n)`` assembles straight from the bytes; rice-run skipping rides
    the native flacfe core when the toolchain built it, else the
    vectorized positions-of-set-bits (``ones``) fallback — which is also
    the behavioral contract the native path is tested against.  The
    unpacked-bit and set-bit index arrays are built lazily: the native
    path never touches them."""

    def __init__(self, blob: bytes):
        self.raw = bytes(blob)
        self.buf = np.frombuffer(self.raw, np.uint8)
        self.pos = 0
        self.n = len(self.raw) * 8
        self._bits = None
        self._ones = None

    @property
    def bits(self):
        if self._bits is None:
            self._bits = np.unpackbits(self.buf)
        return self._bits

    @property
    def ones(self):
        if self._ones is None:
            self._ones = np.flatnonzero(self.bits).astype(np.int64)
        return self._ones

    def u(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.n:
            raise E.UnexpectedEofError("bitstream truncated")
        lo = self.pos >> 3
        hi = (self.pos + n + 7) >> 3
        v = int.from_bytes(self.raw[lo:hi], "big") >> ((-(self.pos + n)) & 7)
        self.pos += n
        return v & ((1 << n) - 1)

    def s(self, n: int) -> int:
        v = self.u(n)
        return v - (1 << n) if n and v >= (1 << (n - 1)) else v

    def unary(self) -> int:
        byte = self.pos >> 3
        nb = len(self.raw)
        if byte >= nb:
            raise E.UnexpectedEofError("unary run past end of stream")
        cur = self.raw[byte] & (0xFF >> (self.pos & 7))
        while cur == 0:
            byte += 1
            if byte >= nb:
                raise E.UnexpectedEofError("unary run past end of stream")
            cur = self.raw[byte]
        t = byte * 8 + (8 - cur.bit_length())
        q = t - self.pos
        self.pos = t + 1
        return q

    def skip_rice(self, count: int, param: int,
                  split: int = 0) -> tuple[list, np.ndarray]:
        """Advance past ``count`` rice codes with parameter ``param`` —
        the hot inner loop of the structural walk.

        Returns ``(outliers, splits)``.  Outliers are ``(code_idx,
        end_bitpos, value)`` for every code whose unary quotient exceeds
        ``Q_CAP`` (``value`` is the final unzigzagged residual;
        ``end_bitpos`` the first bit after the code) so the residual
        walk can split the device lane around them.  With ``split`` > 0,
        ``splits[k]`` is the bit cursor before code ``(k+1)*split`` —
        the walk cuts lanes there so no device lane exceeds ``split``
        codes (bounded scan depth, dense scatter)."""
        fast = _native.skip_rice(self.raw, self.n, self.pos, count,
                                 param, Q_CAP, split)
        if fast is not None:
            self.pos = fast[0]
            return fast[1], fast[2]
        # pure-Python fallback (also the native path's tested contract);
        # the native path declines EOF-crossing runs so the error
        # taxonomy below stays authoritative
        scap = (count - 1) // split if split > 0 else 0
        splits = np.empty((scap,), np.int64)
        ones, pos = self.ones, self.pos
        i = int(np.searchsorted(ones, pos))
        n1 = ones.shape[0]
        out: list = []
        if param == 0:
            # cursors are exactly successive set bits
            if i + count > n1:
                raise E.UnexpectedEofError("rice run past end of stream")
            seg = ones[i : i + count]
            starts = np.empty(count, np.int64)
            if count:
                starts[0] = pos
                starts[1:] = seg[:-1] + 1
            q = seg - starts
            for j in np.flatnonzero(q > Q_CAP):
                v = int(q[j])
                out.append((int(j), int(seg[j]) + 1, (v >> 1) ^ -(v & 1)))
            if scap:
                splits[:] = starts[split::split][:scap]
            self.pos = int(seg[-1]) + 1 if count else pos
            return out, splits
        for j in range(count):
            if split > 0 and j > 0 and j % split == 0:
                splits[j // split - 1] = pos
            if i >= n1:
                raise E.UnexpectedEofError("rice run past end of stream")
            t = int(ones[i])
            q = t - pos
            pos = t + 1 + param
            if q > Q_CAP:
                if pos > self.n:
                    raise E.UnexpectedEofError("rice code past end of stream")
                rem = 0
                for b in self.bits[t + 1 : pos]:
                    rem = (rem << 1) | int(b)
                v = (q << param) | rem
                out.append((j, pos, (v >> 1) ^ -(v & 1)))
            i = int(np.searchsorted(ones, pos))
        self.pos = pos
        if pos > self.n:
            raise E.UnexpectedEofError("rice run past end of stream")
        return out, splits

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _read_utf8(bits: _Bits) -> int:
    """UTF-8-style variable-length frame/sample number."""
    b0 = bits.u(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    if n == 0:
        raise E.InvalidDataError("bad UTF-8 coded number")
    val = b0 & (mask - 1)
    for _ in range(n):
        c = bits.u(8)
        if (c & 0xC0) != 0x80:
            raise E.InvalidDataError("bad UTF-8 continuation")
        val = (val << 6) | (c & 0x3F)
    return val


@dataclasses.dataclass
class FlacAnalysis:
    """Everything the device program needs, flat."""

    sample_rate: int
    channels: int
    bits: int
    total: int  # total samples per channel (0 = unknown)
    md5: bytes
    data: bytes  # raw file bytes (device decodes residuals from these)
    # frames [F]
    blocksizes: np.ndarray
    starts: np.ndarray  # first sample index of each frame
    ch_mode: np.ndarray  # 0..7 independent, 8 L/S, 9 R/S, 10 M/S
    byte_offs: np.ndarray  # [F+1] frame byte offsets (last = stream end)
    # sublanes [S] — one per (frame, channel)
    sub_frame: np.ndarray
    sub_ch: np.ndarray
    sub_kind: np.ndarray  # 0 = predictor path, 1 = CONSTANT
    sub_order: np.ndarray
    sub_shift: np.ndarray
    sub_wasted: np.ndarray
    sub_coeffs: np.ndarray  # [S, 32] int32, zero-padded
    # rice lanes [R]
    rl_sub: np.ndarray
    rl_bitpos: np.ndarray
    rl_count: np.ndarray
    rl_param: np.ndarray
    rl_dest: np.ndarray
    # fixed-width lanes [W]
    fw_sub: np.ndarray
    fw_bitpos: np.ndarray
    fw_count: np.ndarray
    fw_width: np.ndarray
    fw_dest: np.ndarray
    # direct values [D] — host-decoded rice-quotient outliers (q > Q_CAP)
    dv_sub: np.ndarray
    dv_dest: np.ndarray
    dv_val: np.ndarray

    @property
    def n_frames(self) -> int:
        return int(self.blocksizes.shape[0])


def pcm_md5(ints: np.ndarray, bps: int) -> bytes:
    """STREAMINFO MD5 of decoded samples: the spec hashes the unencoded
    audio interleaved, little-endian, ceil(bps/8) bytes per sample
    (little-endian i64 truncation = two's complement in that width)."""
    import hashlib

    nb = (bps + 7) // 8
    raw = np.ascontiguousarray(ints.astype("<i8")).view(np.uint8)
    return hashlib.md5(raw.reshape(-1, 8)[:, :nb].tobytes()).digest()


def verify_md5(an: "FlacAnalysis", ints: np.ndarray) -> bool | None:
    """Check decoded integer samples ``[S, C]`` against the stream's
    STREAMINFO MD5.  Returns None when the encoder left it unset."""
    if an.md5 == b"\x00" * 16:
        return None
    return pcm_md5(ints[: an.total], an.bits) == an.md5


def parse_streaminfo(blob: bytes) -> dict:
    """fLaC marker + metadata block walk → STREAMINFO dict (with
    ``frames_start`` byte offset).  Skips every other metadata block
    type (padding, seektable, vorbis comment, cuesheet, picture,
    application) as the spec directs for decoders."""
    off = 0
    if blob[:3] == b"ID3":  # non-standard but common leading ID3v2 tag
        if len(blob) < 10:
            raise E.InvalidDataError("truncated ID3 header")
        sz = ((blob[6] & 0x7F) << 21) | ((blob[7] & 0x7F) << 14) | (
            (blob[8] & 0x7F) << 7) | (blob[9] & 0x7F)
        off = 10 + sz + (10 if blob[5] & 0x10 else 0)
    if blob[off : off + 4] != b"fLaC":
        raise E.InvalidDataError("missing fLaC stream marker")
    pos = off + 4
    info = None
    last = False
    while not last:
        if pos + 4 > len(blob):
            raise E.UnexpectedEofError("truncated metadata block header")
        last = bool(blob[pos] >> 7)
        btype = blob[pos] & 0x7F
        size = int.from_bytes(blob[pos + 1 : pos + 4], "big")
        if pos + 4 + size > len(blob):
            raise E.UnexpectedEofError("truncated metadata block")
        if btype == 0:
            if size < 34:
                raise E.InvalidDataError("short STREAMINFO")
            b = blob[pos + 4 : pos + 4 + 34]
            v = int.from_bytes(b, "big")  # 272 bits
            info = dict(
                min_block=(v >> 256) & 0xFFFF,
                max_block=(v >> 240) & 0xFFFF,
                min_frame=(v >> 216) & 0xFFFFFF,
                max_frame=(v >> 192) & 0xFFFFFF,
                rate=(v >> 172) & 0xFFFFF,
                channels=((v >> 169) & 0x7) + 1,
                bits=((v >> 164) & 0x1F) + 1,
                total=(v >> 128) & 0xFFFFFFFFF,
                md5=b[18:34],
            )
        elif btype == 127:
            raise E.InvalidDataError("invalid metadata block type 127")
        pos += 4 + size
    if info is None:
        raise E.InvalidDataError("no STREAMINFO block")
    if info["rate"] == 0:
        raise E.InvalidDataError("STREAMINFO sample rate 0")
    info["frames_start"] = pos
    return info


def _walk_residual(bits: _Bits, sub_idx: int, n: int, order: int,
                   rl: list, fw: list, dv: list) -> None:
    """Walk one residual section, appending partition lanes.

    Partitions whose rice codes include quotient outliers (q > Q_CAP,
    beyond the device's in-lane clz window) are split around them: the
    outlier value ships host-decoded (``dv``), the runs between become
    ordinary rice lanes with adjusted (bitpos, count, dest)."""
    method = bits.u(2)
    if method > 1:
        raise E.InvalidDataError("reserved residual coding method")
    pbits, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    po = bits.u(4)
    npart = 1 << po
    psize = n >> po
    # the first partition holds psize - order samples: the blocksize
    # must divide evenly and that count must not go negative
    if n % npart or psize < order:
        raise E.InvalidDataError("invalid partition order")
    for p in range(npart):
        cnt = psize - (order if p == 0 else 0)
        dest = order if p == 0 else p * psize
        param = bits.u(pbits)
        if param == escape:
            width = bits.u(5)
            fw.append((sub_idx, bits.pos, cnt, width, dest))
            bits.pos += cnt * width
            if bits.pos > bits.n:
                raise E.UnexpectedEofError("escaped partition past end")
        else:
            start = bits.pos
            outs, splits = bits.skip_rice(cnt, param, split=RICE_SPLIT)
            # merged emission: outlier cuts (code shipped host-decoded)
            # and RICE_SPLIT-boundary cuts (lane-depth bound) — every
            # emitted lane has count <= RICE_SPLIT, so the device scan
            # depth and the per-lane value padding stay bounded
            oi, no = 0, len(outs)
            prev_j, prev_pos = 0, start
            for k in range(splits.shape[0]):
                sj = (k + 1) * RICE_SPLIT
                while oi < no and outs[oi][0] < sj:
                    j, end_pos, val = outs[oi]
                    oi += 1
                    if j > prev_j:
                        rl.append((sub_idx, prev_pos, j - prev_j, param,
                                   dest + prev_j))
                    dv.append((sub_idx, dest + j, val))
                    prev_j, prev_pos = j + 1, end_pos
                if sj > prev_j:
                    rl.append((sub_idx, prev_pos, sj - prev_j, param,
                               dest + prev_j))
                    prev_j, prev_pos = sj, int(splits[k])
            while oi < no:
                j, end_pos, val = outs[oi]
                oi += 1
                if j > prev_j:
                    rl.append((sub_idx, prev_pos, j - prev_j, param,
                               dest + prev_j))
                dv.append((sub_idx, dest + j, val))
                prev_j, prev_pos = j + 1, end_pos
            if cnt > prev_j:
                rl.append((sub_idx, prev_pos, cnt - prev_j, param,
                           dest + prev_j))


def _walk_subframe(bits: _Bits, sub_idx: int, n: int, bps: int,
                   subs: list, rl: list, fw: list, dv: list) -> None:
    """Walk one subframe header + body, appending its descriptors."""
    if bits.u(1) != 0:
        raise E.InvalidDataError("subframe padding bit set")
    ftype = bits.u(6)
    wasted = 0
    if bits.u(1):
        wasted = bits.unary() + 1
        bps -= wasted
        if bps <= 0:
            raise E.InvalidDataError("wasted bits exceed sample size")
    coeffs = np.zeros(32, np.int32)
    if ftype == 0:  # CONSTANT
        fw.append((sub_idx, bits.pos, 1, bps, 0))
        bits.pos += bps
        subs.append((1, 0, 0, wasted, bps, coeffs))
    elif ftype == 1:  # VERBATIM — LPC order 0 (identity predictor)
        fw.append((sub_idx, bits.pos, n, bps, 0))
        bits.pos += n * bps
        if bits.pos > bits.n:
            raise E.UnexpectedEofError("verbatim body past end")
        subs.append((0, 0, 0, wasted, bps, coeffs))
    elif 8 <= ftype <= 12:  # FIXED — LPC with spec coefficients, shift 0
        order = ftype & 7
        if order > n:
            raise E.InvalidDataError("predictor order exceeds blocksize")
        fw.append((sub_idx, bits.pos, order, bps, 0))
        bits.pos += order * bps
        coeffs[: order] = FIXED_COEFFS[order]
        _walk_residual(bits, sub_idx, n, order, rl, fw, dv)
        subs.append((0, order, 0, wasted, bps, coeffs))
    elif ftype >= 32:  # LPC
        order = (ftype & 31) + 1
        if order > n:
            raise E.InvalidDataError("predictor order exceeds blocksize")
        fw.append((sub_idx, bits.pos, order, bps, 0))
        bits.pos += order * bps
        if bits.pos > bits.n:
            raise E.UnexpectedEofError("LPC warmup past end")
        prec = bits.u(4) + 1
        if prec == 16:
            raise E.InvalidDataError("invalid LPC precision escape")
        shift = bits.s(5)
        if shift < 0:
            raise E.InvalidDataError("negative LPC shift")
        for j in range(order):
            coeffs[j] = bits.s(prec)
        _walk_residual(bits, sub_idx, n, order, rl, fw, dv)
        subs.append((0, order, shift, wasted, bps, coeffs))
    else:
        raise E.InvalidDataError(f"reserved subframe type {ftype}")


def _dv_i32(vals: np.ndarray) -> np.ndarray:
    """Host-decoded outlier residuals ride an int32 device scatter; a
    pathological-but-syntactically-valid stream can rice-code values
    past that — refuse instead of silently wrapping (no real encoder
    emits them: residuals of legal ≤26-bit audio fit i32 easily)."""
    if vals.size and (vals.max() > 2**31 - 1 or vals.min() < -(2**31)):
        raise E.UnsupportedFormatError("rice residual exceeds 32-bit range")
    return vals.astype(np.int32)


def analyze(blob: bytes) -> FlacAnalysis:
    """Full structural walk of one FLAC stream → flat lane descriptors.

    Rides the native whole-file walker (native/flacfe.cc session API)
    when built; the Python walk below is the behavioral contract, the
    fallback, and — for any file the walker rejects — the authority on
    which DecodeError to raise (per-file catch-and-skip happens in the
    group decoder, like every family)."""
    res = _native.walk_batch([blob], Q_CAP, RICE_SPLIT, MAX_BPS, 1 << 62)
    if res is not None and isinstance(res[0], dict):
        return _from_walk(blob, res[0])
    return _analyze_py(blob)


def analyze_batch(blobs: list[bytes]) -> list["FlacAnalysis | E.DecodeError"]:
    """Walk a batch of streams — one FlacAnalysis or caught DecodeError
    per input.  Clean files ride ONE threaded native session (each blob
    walked exactly once, in C); rejected files re-walk in Python for the
    authoritative exception.  The native library is always built (a
    build failure raises ``BuildError``)."""
    res = _native.walk_batch(blobs, Q_CAP, RICE_SPLIT, MAX_BPS, 1 << 62)

    def _py(blob) -> "FlacAnalysis | E.DecodeError":
        try:
            return _analyze_py(blob)
        except E.DecodeError as e:
            return e

    return [_from_walk(b, r) if isinstance(r, dict) else _py(b)
            for b, r in zip(blobs, res)]


def _from_walk(blob: bytes, d: dict) -> FlacAnalysis:
    """Native walk result dict → FlacAnalysis (field names match)."""
    return FlacAnalysis(data=blob, **d)


def _analyze_py(blob: bytes) -> FlacAnalysis:
    """The pure walk (native rice-skip/CRC fast paths still apply when
    built; tests monkeypatch those away to pin the full-Python tier)."""
    info = parse_streaminfo(blob)
    if info["bits"] > MAX_BPS:
        # the analysis's value lanes are i32-exact only; 26-32-bit
        # streams decode via host.decode_ints (decode_group routes them)
        raise E.UnsupportedFormatError("sample size > 25 bits")
    bits = _Bits(blob)
    bits.pos = info["frames_start"] * 8
    total = info["total"]

    blocksizes, starts, ch_modes = [], [], []
    byte_offs: list = []
    subs: list = []  # (kind, order, shift, wasted, bps_eff, coeffs)
    sub_frame: list = []
    sub_ch: list = []
    rl: list = []
    fw: list = []
    dv: list = []  # host-decoded outlier values (sub, dest, value)
    got = 0
    end_bits = len(blob) * 8

    while bits.pos + 16 <= end_bits and (total == 0 or got < total):
        frame_off = bits.pos >> 3
        if bits.u(14) != 0x3FFE:
            raise E.InvalidDataError(f"lost frame sync at byte {frame_off}")
        if bits.u(1) != 0:
            raise E.InvalidDataError("reserved frame header bit")
        variable = bits.u(1)
        bs_code = bits.u(4)
        rate_code = bits.u(4)
        ch_code = bits.u(4)
        ss_code = bits.u(3)
        if bits.u(1) != 0:
            raise E.InvalidDataError("reserved frame header bit 2")
        number = _read_utf8(bits)
        if bs_code == 0:
            raise E.InvalidDataError("reserved blocksize code")
        elif bs_code == 6:
            n = bits.u(8) + 1
        elif bs_code == 7:
            n = bits.u(16) + 1
        else:
            n = _BLOCKSIZE[bs_code]
        if rate_code == 12:
            bits.u(8)
        elif rate_code in (13, 14):
            bits.u(16)
        elif rate_code == 15:
            raise E.InvalidDataError("invalid sample rate code")
        if ss_code == 0b011:
            raise E.InvalidDataError("reserved sample size code")
        bps = info["bits"] if ss_code == 0 else _SAMPLE_SIZE[ss_code]
        if bps > MAX_BPS:
            raise E.UnsupportedFormatError("frame sample size > 25 bits")
        hdr_end = bits.pos >> 3
        if crc8(blob[frame_off:hdr_end]) != bits.u(8):
            raise E.InvalidDataError("frame header CRC-8 mismatch")

        if ch_code <= 7:
            nch = ch_code + 1
            sides = [0] * nch
        elif ch_code <= 10:
            nch = 2
            # the side channel carries one extra bit
            sides = [0, 1] if ch_code in (8, 10) else [1, 0]
        else:
            raise E.InvalidDataError(f"reserved channel assignment {ch_code}")
        if nch != info["channels"]:
            raise E.InvalidDataError("frame channel count != STREAMINFO")

        # frames are walked strictly in stream order, so the cumulative
        # count IS the start sample; the coded frame/sample number only
        # matters for seeking (number validated implicitly by CRC-8)
        del number, variable
        blocksizes.append(n)
        byte_offs.append(frame_off)
        starts.append(got)
        ch_modes.append(ch_code if ch_code >= 8 else 0)
        fidx = len(blocksizes) - 1

        for c in range(nch):
            sub_idx = len(subs)
            sub_frame.append(fidx)
            sub_ch.append(c)
            _walk_subframe(bits, sub_idx, n, bps + sides[c], subs, rl,
                           fw, dv)
        bits.align()
        body_end = bits.pos >> 3
        if body_end + 2 > len(blob):
            raise E.UnexpectedEofError("truncated frame CRC-16")
        if crc16(blob[frame_off:body_end]) != int.from_bytes(
            blob[body_end : body_end + 2], "big"
        ):
            raise E.InvalidDataError("frame CRC-16 mismatch")
        bits.pos += 16
        got += n
    byte_offs.append(bits.pos >> 3)

    if total and got < total:
        raise E.UnexpectedEofError("stream ends before STREAMINFO total")

    S = len(subs)
    coeffs = np.stack([s[5] for s in subs], axis=0) if S else (
        np.zeros((0, 32), np.int32))
    return FlacAnalysis(
        sample_rate=info["rate"],
        channels=info["channels"],
        bits=info["bits"],
        total=total or got,
        md5=info["md5"],
        data=blob,
        blocksizes=np.asarray(blocksizes, np.int32),
        starts=np.asarray(starts, np.int64),
        ch_mode=np.asarray(ch_modes, np.int32),
        byte_offs=np.asarray(byte_offs, np.int64),
        sub_frame=np.asarray(sub_frame, np.int32),
        sub_ch=np.asarray(sub_ch, np.int32),
        sub_kind=np.asarray([s[0] for s in subs], np.int32),
        sub_order=np.asarray([s[1] for s in subs], np.int32),
        sub_shift=np.asarray([s[2] for s in subs], np.int32),
        sub_wasted=np.asarray([s[3] for s in subs], np.int32),
        sub_coeffs=coeffs,
        rl_sub=np.asarray([r[0] for r in rl], np.int32),
        rl_bitpos=np.asarray([r[1] for r in rl], np.int64),
        rl_count=np.asarray([r[2] for r in rl], np.int32),
        rl_param=np.asarray([r[3] for r in rl], np.int32),
        rl_dest=np.asarray([r[4] for r in rl], np.int32),
        fw_sub=np.asarray([w[0] for w in fw], np.int32),
        fw_bitpos=np.asarray([w[1] for w in fw], np.int64),
        fw_count=np.asarray([w[2] for w in fw], np.int32),
        fw_width=np.asarray([w[3] for w in fw], np.int32),
        fw_dest=np.asarray([w[4] for w in fw], np.int32),
        dv_sub=np.asarray([d[0] for d in dv], np.int32),
        dv_dest=np.asarray([d[1] for d in dv], np.int32),
        dv_val=_dv_i32(np.asarray([d[2] for d in dv], np.int64)),
    )

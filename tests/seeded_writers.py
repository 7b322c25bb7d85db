"""Seeded writers of test inputs (numpy only): random spec-valid MPEG
audio Layer I and Layer II frames, and WAV containers for IMA and MS
ADPCM data.

No Layer I encoder exists on the test machines and no Layer II encoder on
the GPU machine, so both layers' inputs are random frames drawn from a
seed: random bit allocations within each subband's allocation table,
random scfsi and scalefactors, and random sample codes (grouped triplets
of 3/5/9-step classes, plain codes elsewhere).  Every decoder must agree
on the same bytes.

``layer1_frames`` draws from the generator in the same order as
``tests/test_layer12.py::_l1_frames`` and gives the same bytes (a test
holds the two equal); it packs bits faster, for 10 s files.
"""

from __future__ import annotations

import struct

import numpy as np

from audio_decoder_tpu_torch.codecs.mpeg import layer12_tables as LT
from audio_decoder_tpu_torch.codecs.mpeg import tables as T

from . import ms_ref as MR
from .synth import make_wav


def ima_spb(block_align: int, ch: int) -> int:
    """Frames per WAV IMA ADPCM block."""
    return 1 + 8 * ((block_align - 4 * ch) // (4 * ch))


def ms_spb(block_align: int, ch: int) -> int:
    """Frames per WAV MS ADPCM block."""
    return 2 + (block_align - 7 * ch) * 2 // ch


def ima_wav(data: bytes, ch: int, block_align: int, rate: int = 44100,
            fact: int | None = None, extensible: bool = False) -> bytes:
    """A WAV (format 0x11) holding IMA ADPCM blocks ``data``."""
    spb = ima_spb(block_align, ch)
    extra = [(b"fact", struct.pack("<I", fact))] if fact is not None else None
    if extensible:
        return make_wav(np.zeros((0, ch), np.int16), rate, 4, extensible=True,
                        fmt_code_override=0x11, data_override=data,
                        block_align_override=block_align,
                        valid_bits_override=spb, extra_chunks=extra)
    return make_wav(np.zeros((0, ch), np.int16), rate, 4,
                    fmt_code_override=0x11, data_override=data,
                    block_align_override=block_align,
                    fmt_tail=struct.pack("<HH", 2, spb), extra_chunks=extra)


def ms_wav(data: bytes, ch: int, block_align: int, rate: int = 44100,
           fact: int | None = None) -> bytes:
    """A WAV (format 0x02) holding MS ADPCM blocks ``data``, with the
    seven standard coefficient pairs in its fmt chunk."""
    extra = [(b"fact", struct.pack("<I", fact))] if fact is not None else None
    tail = struct.pack("<HHH", 32, ms_spb(block_align, ch), 7)
    for c1, c2 in zip(MR.COEF1, MR.COEF2):
        tail += struct.pack("<hh", c1, c2)
    return make_wav(np.zeros((0, ch), np.int16), rate, 4,
                    fmt_code_override=0x02, data_override=data,
                    block_align_override=block_align, fmt_tail=tail,
                    extra_chunks=extra)


class _Bits:
    """MSB-first bit packer."""

    def __init__(self):
        self.acc = 0
        self.n = 0

    def put(self, v: int, n: int) -> None:
        self.acc = (self.acc << n) | v
        self.n += n

    def frame(self, frame_len: int) -> bytes:
        """The bits so far, zero-padded to ``frame_len`` bytes."""
        if self.n > 8 * frame_len:
            raise ValueError(f"{self.n} bits do not fit {frame_len} bytes")
        return (self.acc << (8 * frame_len - self.n)).to_bytes(frame_len, "big")


def _header(version: int, layer_code: int, br_idx: int, sr_idx: int,
            mode: int, mode_ext: int) -> int:
    """A 32-bit frame header without CRC, every other flag bit zero
    (layer_code: 3 Layer I, 2 Layer II)."""
    return ((0x7FF << 21) | (version << 19) | (layer_code << 17) | (1 << 16)
            | (br_idx << 12) | (sr_idx << 10) | (mode << 6) | (mode_ext << 4))


def layer1_frames(rng, n_frames: int, ch: int, max_alloc: int = 3,
                  joint_ext: int | None = None) -> bytes:
    """Random spec-valid MPEG-1 Layer I frames, 448 kbps, 44.1 kHz.

    joint_ext: intensity-stereo mode_ext; subbands >= bound =
    4*(mode_ext+1) carry one shared allocation and sample set but
    per-channel scalefactors."""
    out = bytearray()
    bound = 32 if joint_ext is None else (joint_ext + 1) * 4
    mode = 1 if joint_ext is not None else (0 if ch == 2 else 3)
    hdr = _header(3, 3, 14, 0, mode, joint_ext or 0)
    frame_len = (12 * 448000 // 44100) * 4
    for _ in range(n_frames):
        bits = _Bits()
        bits.put(hdr, 32)
        alloc = rng.integers(0, max_alloc + 1, size=(ch, 32))
        alloc[1:, bound:] = alloc[:1, bound:]  # shared above the bound
        for sb in range(32):
            for c in range(ch if sb < bound else 1):
                bits.put(int(alloc[c, sb]), 4)
        for sb in range(32):
            for c in range(ch):
                if alloc[c, sb]:
                    bits.put(int(rng.integers(0, 63)), 6)
        for _t in range(12):
            for sb in range(32):
                for c in range(ch if sb < bound else 1):
                    a = int(alloc[c, sb])
                    if a:
                        nb = a + 1
                        bits.put(int(rng.integers(0, (1 << nb) - 1)), nb)
        out += bits.frame(frame_len)
    return bytes(out)


#: (version, sample rate) → sampling-frequency index of the header
_SR_IDX = {(3, 44100): 0, (3, 48000): 1, (3, 32000): 2,
           (2, 22050): 0, (2, 24000): 1, (2, 16000): 2}


def layer2_table(version: int, sr: int, kbps: int, ch: int):
    """(bitrate index, allocation table, sblimit) of a Layer II stream,
    chosen as ISO 11172-3 Annex B's table select (and table 4 for the
    MPEG-2 low sampling frequencies)."""
    col = T.bitrate_column(version, 2)
    br_idx = next(i + 1 for i in range(14)
                  if int(T.BITRATE_KBPS[i][col]) == kbps)
    if version != 3:
        return br_idx, LT.ALLOC_TABLES[4], LT.SBLIMIT[4]
    t = LT.TRANSLATE[_SR_IDX[(3, sr)]][2 - ch][br_idx]
    return br_idx, LT.ALLOC_TABLES[t], LT.SBLIMIT[t]


def _l2_alloc_bits(table, alloc, sblimit: int, bound: int, ch: int) -> int:
    """Bits one frame's side info and samples take for ``alloc``."""
    n = 32
    for sb in range(sblimit):
        n += table[sb][0] * (ch if sb < bound else 1)
    for sb in range(sblimit):
        for c in range(ch):
            a = int(alloc[c, sb])
            if not a:
                continue
            n += 2 + 6 * 3  # scfsi + at most three scalefactors
            if c == 0 or sb < bound:
                sample_bits, d = table[sb][1][a - 1]
                n += 12 * (sample_bits if d > 0 else 3 * sample_bits)
    return n


def layer2_frames(rng, n_frames: int, ch: int, *, sr: int = 44100,
                  kbps: int = 192, version: int = 3, max_alloc: int = 4,
                  joint_ext: int | None = None) -> bytes:
    """Random spec-valid Layer II frames (MPEG-1, or MPEG-2 low sampling
    frequencies with ``version=2``).

    Each frame draws its allocation per (channel, subband) below
    ``max_alloc`` and the subband's option count, then drops the top
    allocated subbands until the frame fits its bitrate."""
    br_idx, table, sblimit = layer2_table(version, sr, kbps, ch)
    bound = (sblimit if joint_ext is None
             else min((joint_ext + 1) * 4, sblimit))
    mode = 1 if joint_ext is not None else (0 if ch == 2 else 3)
    hdr = _header(version, 2, br_idx, _SR_IDX[(version, sr)], mode,
                  joint_ext or 0)
    frame_len = 144 * kbps * 1000 // sr
    out = bytearray()
    for _ in range(n_frames):
        alloc = np.zeros((ch, 32), np.int64)
        for sb in range(sblimit):
            top = min(max_alloc, len(table[sb][1]))
            alloc[:, sb] = rng.integers(0, top + 1, size=ch)
        alloc[1:, bound:] = alloc[:1, bound:]  # shared above the bound
        sb = sblimit - 1
        while _l2_alloc_bits(table, alloc, sblimit, bound, ch) > 8 * frame_len:
            alloc[:, sb] = 0
            sb -= 1

        bits = _Bits()
        bits.put(hdr, 32)
        for sb in range(sblimit):
            for c in range(ch if sb < bound else 1):
                bits.put(int(alloc[c, sb]), table[sb][0])
        scfsi = np.zeros((ch, 32), np.int64)
        for sb in range(sblimit):
            for c in range(ch):
                if alloc[c, sb]:
                    scfsi[c, sb] = rng.integers(0, 4)
                    bits.put(int(scfsi[c, sb]), 2)
        for sb in range(sblimit):
            for c in range(ch):
                if alloc[c, sb]:
                    for _k in range((3, 2, 1, 2)[scfsi[c, sb]]):
                        bits.put(int(rng.integers(0, 63)), 6)
        for _gr in range(12):
            for sb in range(sblimit):
                for c in range(ch if sb < bound else 1):
                    a = int(alloc[c, sb])
                    if not a:
                        continue
                    sample_bits, d = table[sb][1][a - 1]
                    if d > 0:  # grouped triplet of base-d values
                        v = rng.integers(0, d, size=3)
                        bits.put(int(v[0] + v[1] * d + v[2] * d * d),
                                 sample_bits)
                    else:
                        for v in rng.integers(0, (1 << sample_bits) - 1,
                                              size=3):
                            bits.put(int(v), sample_bits)
        out += bits.frame(frame_len)
    return bytes(out)

"""MPEG Layer I / Layer II decode: host bitstream parse + device DSP.

Layers I and II are subband coders: fixed-width sample codes (widths set
by the per-subband bit allocation) feed the same polyphase synthesis
filterbank as Layer III, with no entropy coding, reservoir or IMDCT.
The host walks allocation, scfsi, scalefactors and codes (fixed-size
reads only; ``analyze_l1``/``analyze_l2``, the JAX package's numpy code
as is) and emits dense arrays; ``l12_synthesize`` requantizes them with
torch on the batch's device and runs ``dsp.polyphase_synthesis``, the
synthesis kernel (K2) on a CUDA device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core import errors as E
from ...utils.trace import span, to_device
from . import layer12_tables as LT
from .dsp import polyphase_synthesis
from .frontend import _Bits, find_frames

#: quantization classes: steps → (class id, nb); class 0 = silent
_STEPS_LIST = (0, 3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
               8191, 16383, 32767, 65535)
_CLASS_BY_STEPS = {s: i for i, s in enumerate(_STEPS_LIST)}
_NB_BY_CLASS = np.array(
    [1] + [int(s).bit_length() for s in _STEPS_LIST[1:]], np.int32
)
_C_BY_CLASS = np.array(
    [0.0] + [LT.CD[s][0] for s in _STEPS_LIST[1:]], np.float64
)
_D_BY_CLASS = np.array(
    [0.0] + [LT.CD[s][1] for s in _STEPS_LIST[1:]], np.float64
)
_SF = LT.scalefactors()  # [63]


def _select_table(version: int, sr: int, bitrate: int, channels: int):
    if version != 3:
        return LT.ALLOC_TABLES[4], LT.SBLIMIT[4]
    from . import tables as T

    sfreq = {44100: 0, 48000: 1, 32000: 2}[sr]
    col = T.bitrate_column(version, 2)
    br_idx = 0
    for i in range(14):
        if int(T.BITRATE_KBPS[i][col]) * 1000 == bitrate:
            br_idx = i + 1
            break
    t = LT.TRANSLATE[sfreq][2 - channels][br_idx]
    return LT.ALLOC_TABLES[t], LT.SBLIMIT[t]


@dataclasses.dataclass
class L12Analysis:
    """Dense host output for one Layer I/II file."""

    sample_rate: int
    channels: int
    layer: int  # 1 or 2
    n_frames: int
    steps_per_frame: int  # 12 (Layer I) or 36 (Layer II)
    codes: np.ndarray  # int32 [F, C, 32, steps]
    cls: np.ndarray  # int8  [F, C, 32] quantization class (0 silent)
    sf_idx: np.ndarray  # int8 [F, C, 32, 3] scalefactor index (63 silent)


def analyze_l2(blob: bytes, frames=None) -> L12Analysis:
    """`frames` (optional): precomputed ``[(pos, header), ...]`` into
    `blob` — lets a streaming caller re-analyze a byte slice with exact
    framing instead of re-running the sync walk on the slice."""
    if frames is None:
        frames = [(p, h) for p, h in find_frames(blob) if h["layer"] == 2]
    if not frames:
        raise E.InvalidDataError("no Layer II frames")
    h0 = frames[0][1]
    sr, ch, ver = h0["sr"], h0["channels"], h0["version"]
    frames = [
        (p, h) for p, h in frames
        if h["sr"] == sr and h["channels"] == ch and h["version"] == ver
    ]
    F = len(frames)
    codes = np.zeros((F, ch, 32, 36), np.int32)
    cls = np.zeros((F, ch, 32), np.int8)
    sf_idx = np.full((F, ch, 32, 3), 63, np.int8)

    for fi, (pos, h) in enumerate(frames):
        try:
            table, sblimit = _select_table(ver, sr, h["bitrate"], ch)
            bound = (
                min((h["mode_ext"] + 1) * 4, sblimit)
                if h["mode"] == 1 else sblimit
            )
            bits = _Bits(
                blob[pos + 4 + (2 if h["crc"] else 0) : pos + h["frame_len"]]
            )
            alloc = np.zeros((ch, 32), np.int32)
            for sb in range(sblimit):
                width = table[sb][0]
                if sb < bound:
                    for c in range(ch):
                        alloc[c, sb] = bits.get(width)
                else:
                    a = bits.get(width)
                    alloc[:, sb] = a
            scfsi = np.zeros((ch, 32), np.int32)
            for sb in range(sblimit):
                for c in range(ch):
                    if alloc[c, sb]:
                        scfsi[c, sb] = bits.get(2)
            for sb in range(sblimit):
                for c in range(ch):
                    if not alloc[c, sb]:
                        continue
                    m = scfsi[c, sb]
                    if m == 0:
                        idx = [bits.get(6) for _ in range(3)]
                    elif m == 1:
                        a, b = bits.get(6), bits.get(6)
                        idx = [a, a, b]
                    elif m == 2:
                        a = bits.get(6)
                        idx = [a, a, a]
                    else:
                        a, b = bits.get(6), bits.get(6)
                        idx = [a, b, b]
                    sf_idx[fi, c, sb] = [min(i, 62) for i in idx]
            for gr in range(12):
                for sb in range(sblimit):
                    shared = sb >= bound
                    for c in range(1 if shared else ch):
                        a = alloc[c, sb]
                        if not a:
                            continue
                        sample_bits, d = table[sb][1][a - 1]
                        if d > 0:  # grouped triplet
                            g = bits.get(sample_bits)
                            vals = (g % d, (g // d) % d, (g // d**2) % d)
                            steps = d
                        else:
                            steps = (1 << sample_bits) - 1
                            vals = tuple(
                                bits.get(sample_bits) for _ in range(3)
                            )
                        klass = _CLASS_BY_STEPS[steps]
                        targets = range(ch) if shared else (c,)
                        for cc in targets:
                            if shared and not alloc[cc, sb]:
                                continue
                            cls[fi, cc, sb] = klass
                            for k in range(3):
                                codes[fi, cc, sb, gr * 3 + k] = vals[k]
        except (IndexError, E.DecodeError):
            cls[fi] = 0  # silent frame
            codes[fi] = 0
    return L12Analysis(
        sample_rate=sr, channels=ch, layer=2, n_frames=F,
        steps_per_frame=36, codes=codes, cls=cls, sf_idx=sf_idx,
    )


def analyze_l1(blob: bytes, frames=None) -> L12Analysis:
    """`frames`: see analyze_l2 — precomputed framing for slice re-analysis."""
    if frames is None:
        frames = [(p, h) for p, h in find_frames(blob) if h["layer"] == 3]
    if not frames:
        raise E.InvalidDataError("no Layer I frames")
    h0 = frames[0][1]
    sr, ch, ver = h0["sr"], h0["channels"], h0["version"]
    frames = [
        (p, h) for p, h in frames
        if h["sr"] == sr and h["channels"] == ch and h["version"] == ver
    ]
    F = len(frames)
    codes = np.zeros((F, ch, 32, 12), np.int32)
    cls = np.zeros((F, ch, 32), np.int8)
    sf_idx = np.full((F, ch, 32, 3), 63, np.int8)
    for fi, (pos, h) in enumerate(frames):
        try:
            bound = min((h["mode_ext"] + 1) * 4, 32) if h["mode"] == 1 else 32
            bits = _Bits(
                blob[pos + 4 + (2 if h["crc"] else 0) : pos + h["frame_len"]]
            )
            alloc = np.zeros((ch, 32), np.int32)
            for sb in range(32):
                if sb < bound:
                    for c in range(ch):
                        alloc[c, sb] = bits.get(4)
                else:
                    alloc[:, sb] = bits.get(4)
            for sb in range(32):
                for c in range(ch):
                    if alloc[c, sb]:
                        sf_idx[fi, c, sb] = min(bits.get(6), 62)
            for t in range(12):
                for sb in range(32):
                    shared = sb >= bound
                    for c in range(1 if shared else ch):
                        a = alloc[c, sb]
                        if not a:
                            continue
                        nb = a + 1
                        v = bits.get(nb)
                        steps = (1 << nb) - 1
                        klass = _CLASS_BY_STEPS[steps]
                        for cc in range(ch) if shared else (c,):
                            if shared and not alloc[cc, sb]:
                                continue
                            cls[fi, cc, sb] = klass
                            codes[fi, cc, sb, t] = v
        except (IndexError, E.DecodeError):
            cls[fi] = 0
            codes[fi] = 0
    return L12Analysis(
        sample_rate=sr, channels=ch, layer=1, n_frames=F,
        steps_per_frame=12, codes=codes, cls=cls, sf_idx=sf_idx,
    )


#: per class: 2^(nb-1), the code scale (exact powers of two)
_HALF_RANGE = np.exp2(_NB_BY_CLASS - 1).astype(np.float32)


def l12_subband_samples(codes: torch.Tensor, cls: torch.Tensor,
                        sf_idx: torch.Tensor) -> torch.Tensor:
    """Requantize a Layer I/II batch on the tensors' device → time-major
    subband samples f32 ``[B, C, F*steps, 32]``, the synthesis input.

    codes: int32 ``[B, F, C, 32, steps]``; cls int8 ``[B, F, C, 32]``;
    sf_idx int8 ``[B, F, C, 32, 3]`` (3 scalefactor parts; Layer I uses
    part 0).  The f32 constants are the JAX package's float64 tables cast
    to f32."""
    B, F, C, _, S = codes.shape
    dev = codes.device
    f = torch.float32
    k = cls.to(torch.int64)
    half = to_device(_HALF_RANGE, dev)[k]           # [B,F,C,32]
    cc = to_device(_C_BY_CLASS.astype(np.float32), dev)[k]
    dd = to_device(_D_BY_CLASS.astype(np.float32), dev)[k]
    # s'' = C * (code / 2^(nb-1) - 1 + D)   (ISO 2.4.3.2 / 2.4.3.3)
    frac = codes.to(f) / half[..., None] - 1.0
    s2 = cc[..., None] * (frac + dd[..., None])
    # scalefactor per time step: Layer II parts of 12 samples, Layer I
    # part 0
    sf_tab = to_device(
        np.concatenate([_SF.astype(np.float32), np.zeros(1, np.float32)]), dev)
    sf = sf_tab[sf_idx.to(torch.int64)]                           # [B,F,C,32,3]
    part = (torch.arange(S, device=dev) // 12 if S == 36
            else torch.zeros(S, dtype=torch.int64, device=dev))
    sf_t = sf[..., part % 3]                                      # [B,F,C,32,S]
    silent = (cls == 0)[..., None]
    sub = torch.where(silent, torch.zeros((), dtype=f, device=dev), s2 * sf_t)
    return sub.permute(0, 2, 1, 4, 3).reshape(B, C, F * S, 32)


def l12_synthesize(
    codes: torch.Tensor,
    cls: torch.Tensor,
    sf_idx: torch.Tensor,
    *,
    channels: int,
    steps: int,
) -> torch.Tensor:
    """Requantize + polyphase synthesis for a Layer I/II batch on the
    tensors' device (``l12_subband_samples``, then
    ``dsp.polyphase_synthesis``: the K2 kernel on a CUDA device).
    Returns flat interleaved f32 PCM ``[B, F*steps*32*C]``."""
    if codes.shape[2] != channels or codes.shape[4] != steps:
        raise ValueError(f"codes {tuple(codes.shape)} do not match channels "
                         f"{channels}, steps {steps}")
    with span("l12.requantize"):
        TS = l12_subband_samples(codes, cls, sf_idx)
    with span("l12.synthesis"):
        return polyphase_synthesis(TS)

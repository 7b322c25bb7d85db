# Verbatim copy of audio_decoder_tpu/codecs/mpeg/tables.py (that package imports jax on import).
"""MPEG-1 Layer III decode tables and derived constants.

Everything here is standardized public data from ISO/IEC 11172-3 (Annex B)
or derived from spec formulas.  The reference's mpeg.rs carries only the
header bitrate table (mpeg.rs:255-271, with a column-select bug this module
fixes — SURVEY §5 defect 1) and sample-rate multipliers (mpeg.rs:286-303);
all decode-side tables below are new (the reference's decode is a TODO,
main.rs:44-54).

The 512-tap synthesis-window coefficients are the ISO Table 3-B.3 values
(integer multiples of 1/65536), recovered from the system MPEG library's
tables and validated end-to-end against the reference decoder in tests.
"""

from __future__ import annotations

import numpy as np

from .synth_window import INTWIN  # 257 ints: ISO 3-B.3 window * 65536

# ---------------------------------------------------------------------------
# Header tables (≙ mpeg.rs:255-303, corrected)
# ---------------------------------------------------------------------------

#: bitrate_index (1..14) × column → kbit/s.  Columns: V1L1, V1L2, V1L3,
#: V2L1, V2L2&L3 (the reference's 15×5 table transposed per ISO).
BITRATE_KBPS = np.array(
    [
        [32, 32, 32, 32, 8],
        [64, 48, 40, 48, 16],
        [96, 56, 48, 56, 24],
        [128, 64, 56, 64, 32],
        [160, 80, 64, 80, 40],
        [192, 96, 80, 96, 48],
        [224, 112, 96, 112, 56],
        [256, 128, 112, 128, 64],
        [288, 160, 128, 144, 80],
        [320, 192, 160, 160, 96],
        [352, 224, 192, 176, 112],
        [384, 256, 224, 192, 128],
        [416, 320, 256, 224, 144],
        [448, 384, 320, 256, 160],
    ],
    dtype=np.int32,
)


def bitrate_column(version_id: int, layer: int) -> int:
    """Correct version/layer → column select (the reference combined the
    fields with ``&`` instead of a proper match, mpeg.rs:273-284)."""
    if version_id == 3:  # MPEG-1
        return {3: 0, 2: 1, 1: 2}[layer]  # layer code: 3=L1, 2=L2, 1=L3
    # MPEG-2 / 2.5
    return 3 if layer == 3 else 4


#: sample-rate table: [version_id][sr_index] in Hz (version_id 0=2.5, 2=2, 3=1)
SAMPLE_RATES = {
    3: (44100, 48000, 32000),
    2: (22050, 24000, 16000),
    0: (11025, 12000, 8000),
}

# ---------------------------------------------------------------------------
# Scalefactor bands (ISO Table B.8), MPEG-1 rates.
# Boundaries are line indices of band starts; long has 23 entries (22 bands),
# short has 14 (13 bands).
# ---------------------------------------------------------------------------

SFB_LONG = {
    # MPEG-1
    44100: np.array(
        [0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134, 162,
         196, 238, 288, 342, 418, 576], np.int32),
    48000: np.array(
        [0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128, 156,
         190, 230, 276, 330, 384, 576], np.int32),
    32000: np.array(
        [0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126, 156, 194,
         240, 296, 364, 448, 550, 576], np.int32),
    # MPEG-2 (ISO 13818-3 Table B.2)
    22050: np.array(
        [0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200,
         238, 284, 336, 396, 464, 522, 576], np.int32),
    24000: np.array(
        [0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136, 162, 194,
         232, 278, 332, 394, 464, 540, 576], np.int32),
    16000: np.array(
        [0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200,
         238, 284, 336, 396, 464, 522, 576], np.int32),
    # MPEG-2.5
    11025: np.array(
        [0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200,
         238, 284, 336, 396, 464, 522, 576], np.int32),
    12000: np.array(
        [0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200,
         238, 284, 336, 396, 464, 522, 576], np.int32),
    8000: np.array(
        [0, 12, 24, 36, 48, 60, 72, 88, 108, 132, 160, 192, 232, 280, 336,
         400, 476, 566, 568, 570, 572, 574, 576], np.int32),
}

SFB_SHORT = {
    44100: np.array(
        [0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192], np.int32),
    48000: np.array(
        [0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192], np.int32),
    32000: np.array(
        [0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192], np.int32),
    22050: np.array(
        [0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192], np.int32),
    24000: np.array(
        [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192], np.int32),
    16000: np.array(
        [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192], np.int32),
    11025: np.array(
        [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192], np.int32),
    12000: np.array(
        [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192], np.int32),
    8000: np.array(
        [0, 8, 16, 24, 36, 52, 72, 96, 124, 160, 162, 164, 166, 192],
        np.int32),
}

#: canonical rate → rate-index order used by the device tables
RATE_ORDER = (44100, 48000, 32000, 22050, 24000, 16000, 11025, 12000, 8000)
RATE_IDX = {r: i for i, r in enumerate(RATE_ORDER)}

#: preemphasis table, long scalefactor bands 0..20 (+0 for the stub band)
PRETAB = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0],
    np.int32,
)

#: scalefac_compress → (slen1, slen2), MPEG-1 (ISO 2.4.2.7)
SLEN1 = np.array([0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4], np.int32)
SLEN2 = np.array([0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3], np.int32)


def lsf_scalefac_layout(scalefac_compress: int, block_kind: int):
    """LSF (MPEG-2/2.5) scalefactor layout (ISO 13818-3 2.4.3.2).

    scalefac_compress is 9 bits; returns (slen[4], nr_of_sfb[4], preflag)
    for the non-intensity channel.  block_kind: 0 long, 1 short, 2 mixed.
    """
    sc = scalefac_compress
    if sc < 400:
        slen = ((sc >> 4) // 5, (sc >> 4) % 5, (sc % 16) >> 2, sc % 4)
        cat, preflag = 0, 0
    elif sc < 500:
        s = sc - 400
        slen = ((s >> 2) // 5, (s >> 2) % 5, s % 4, 0)
        cat, preflag = 1, 0
    else:
        s = sc - 500
        slen = (s // 3, s % 3, 0, 0)
        cat, preflag = 2, 1
    nr = LSF_NR_SFB[cat][block_kind]
    return slen, nr, preflag


#: nr_of_sfb per slen group: [category][block_kind long/short/mixed]
LSF_NR_SFB = (
    ((6, 5, 5, 5), (9, 9, 9, 9), (6, 9, 9, 9)),
    ((6, 5, 7, 3), (9, 9, 12, 6), (6, 9, 12, 6)),
    ((11, 10, 0, 0), (18, 18, 0, 0), (15, 18, 0, 0)),
)


def lsf_scalefac_layout_istereo(scalefac_compress: int, block_kind: int):
    """LSF scalefactor layout for the INTENSITY-coded channel (ISO
    13818-3 2.4.3.2, the is_pos coding): the layout key is
    scalefac_compress >> 1 (bit 0 is intensity_scale) and the slot counts
    differ from the normal layout.  Returns (slen[4], nr_of_sfb[4]);
    preflag is always 0 for the intensity channel.

    Layout extracted empirically from mpg123 bit-position probes
    (tests/test_intensity_lsf.py): the long rows (7,7,7) / (6,6,6,+3
    zero-width) match single-bit → band maps at sc' 43/86/129 and 201.
    """
    sc = scalefac_compress >> 1
    if sc < 180:
        slen = (sc // 36, (sc % 36) // 6, sc % 6, 0)
        cat = 0
    elif sc < 244:
        s = sc - 180
        slen = ((s >> 4) & 3, (s >> 2) & 3, s & 3, 0)
        cat = 1
    else:
        s = sc - 244
        slen = (s // 3, s % 3, 0, 0)
        cat = 2
    return slen, LSF_I_NR_SFB[cat][block_kind]


#: nr_of_sfb per slen group, intensity layout: [category][long/short/mixed]
LSF_I_NR_SFB = (
    ((7, 7, 7, 0), (12, 12, 12, 0), (6, 15, 12, 0)),
    ((6, 6, 6, 3), (12, 9, 9, 6), (6, 12, 9, 6)),
    ((8, 8, 5, 0), (15, 12, 9, 0), (6, 18, 9, 0)),
)


def ws_region1_lines(version: int, block_type: int, sr: int) -> int:
    """Implicit region1 boundary (in spectral lines) for window-switching
    granules (ISO: region0_count = 7 long / 8 short, in scalefactor-band
    units where a short sfb counts three times):

      short blocks: 3 * short_bands[3]  (36 everywhere except 72 @ 8 kHz)
      long  blocks: long_bands[8]       (36 MPEG-1; 54 LSF; 108 @ 8 kHz)
    """
    if block_type == 2:
        return int(SFB_SHORT[sr][3]) * 3
    return int(SFB_LONG[sr][8])

# ---------------------------------------------------------------------------
# Antialias butterflies (ISO 2.4.3.4.10.1)
# ---------------------------------------------------------------------------

_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
AA_CS = (1.0 / np.sqrt(1.0 + _CI * _CI)).astype(np.float64)
AA_CA = (_CI / np.sqrt(1.0 + _CI * _CI)).astype(np.float64)

# ---------------------------------------------------------------------------
# IMDCT windows + basis matrices (ISO 2.4.3.4.10.3)
# ---------------------------------------------------------------------------


def _imdct_matrix(n: int) -> np.ndarray:
    """IMDCT basis: out[i] = Σ_k X[k] cos(π/(2n)(2i+1+n/2)(2k+1)); [n, n/2]."""
    i = np.arange(n)[:, None]
    k = np.arange(n // 2)[None, :]
    return np.cos(np.pi / (2 * n) * (2 * i + 1 + n // 2) * (2 * k + 1))


def _windows() -> dict[int, np.ndarray]:
    n = 36
    i = np.arange(n)
    w = {}
    w[0] = np.sin(np.pi / n * (i + 0.5))  # normal
    start = np.sin(np.pi / n * (i + 0.5)).copy()  # start (long→short)
    start[18:24] = 1.0
    start[24:30] = np.sin(np.pi / 12 * (np.arange(24, 30) - 18 + 0.5))
    start[30:] = 0.0
    w[1] = start
    stop = np.sin(np.pi / n * (i + 0.5)).copy()  # stop (short→long)
    stop[:6] = 0.0
    stop[6:12] = np.sin(np.pi / 12 * (np.arange(6, 12) - 6 + 0.5))
    stop[12:18] = 1.0
    w[3] = stop
    w[2] = np.sin(np.pi / 12 * (np.arange(12) + 0.5))  # one short window
    return w


IMDCT36 = _imdct_matrix(36)  # [36, 18]
IMDCT12 = _imdct_matrix(12)  # [12, 6]
WINDOWS = _windows()

#: Windowed IMDCT matrices per block type: [36, 18] (long types) so the
#: whole hybrid stage is a single matmul per block type.
WIN_IMDCT36 = {bt: WINDOWS[bt][:, None] * IMDCT36 for bt in (0, 1, 3)}
WIN_IMDCT12 = WINDOWS[2][:, None] * IMDCT12  # [12, 6]

# ---------------------------------------------------------------------------
# Polyphase synthesis filterbank (ISO 2.4.3.4.10.4 / Annex 3-B.3)
# ---------------------------------------------------------------------------

#: matrixing: V[i] = Σ_k N[i,k] S[k], N[i,k] = cos((16+i)(2k+1)π/64); [64, 32]
SYNTH_N = np.cos(
    (16 + np.arange(64))[:, None] * (2 * np.arange(32)[None, :] + 1) * np.pi / 64
)

#: ISO Table 3-B.3 synthesis window D[512]: magnitudes are INTWIN/65536
#: mirrored around the center (|D[512-i]| = |D[i]|), with the table's sign
#: alternation every 64 taps (σ = +,−,+,… per 64-block) — the folded form
#: the ISO U/W/S windowing formulas expect.  Validated to ~5e-8 RMS against
#: the system mpg123 decoder (tests/test_mp3.py).
_half = np.asarray(INTWIN, np.float64) / 65536.0
SYNTH_D = np.concatenate([_half, _half[1:256][::-1]])
_sign = np.where((np.arange(512) // 64) % 2 == 0, 1.0, -1.0)
SYNTH_D = SYNTH_D * _sign
assert SYNTH_D.shape == (512,)

#: intensity-stereo ratios: is_pos → tan(is_pos * π/12) (ISO 2.4.3.4.9.3).
#: The spec defines 0..6 (7 = illegal); mpg123 fills its table through 15
#: with the same formula and real 4-bit scalefactor fields can reach that,
#: so we match (verified by probe: is_pos 8/10/12/15 → the continued tan
#: pairs; is_pos 9 → tan(3π/4) = −1 → NaN, faithfully ill-defined).
IS_RATIO = np.tan(np.arange(16) * np.pi / 12.0)


def lsf_is_factors(intensity_scale: int, max_pos: int = 32) -> np.ndarray:
    """LSF intensity channel factors (ISO 13818-3 2.4.3.4): rows is_pos →
    (left factor, right factor) with io = 2^(-(intensity_scale+1)/4);
    is_pos 0 copies, odd is_pos scales LEFT by io^((is_pos+1)/2), even
    scales RIGHT by io^(is_pos/2).  Pinned to mpg123 via crafted streams
    (tests/test_intensity_lsf.py); is_pos 7 (illegal) is handled by the
    caller (band left untouched / MS)."""
    io = 2.0 ** (-(intensity_scale + 1) / 4.0)
    out = np.ones((max_pos, 2))
    for k in range(1, max_pos):
        if k & 1:
            out[k, 0] = io ** ((k + 1) // 2)
        else:
            out[k, 1] = io ** (k // 2)
    return out

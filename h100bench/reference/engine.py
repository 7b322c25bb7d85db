"""Plain render of the live loop: BLAST's voices stepped one frame at a time.

The benchmark's witness for the engine.  Written from the engine's
semantics as the reference program states them (``engine.rs:50-79``: each
frame, every voice's sequencer is tested, then each voice reads its track
and is mixed; ``processes.rs:52-99``: a sequencer fires on a tempo step
that is in its step list and passes its chance roll), with the port's
documented extensions (per-step jitter, tremolo and envelope gains,
paused groups, signed velocity, mono fan-out):

* the chance roll of a block is Threefry-2x32 (Salmon et al., SC 2011)
  under the state's key folded with the block's clock, counter
  ``lane * frames + frame``, written here in NumPy uint32 arithmetic from
  the definition; the jitter delay is the documented integer hash of (tempo
  lane, step number) under the key's derived seed, also in uint32;
* each voice keeps the frame of its last trigger in the block.  Each
  frame's position is computed from that frame, or from the block's start
  where none fired yet, as ``velocity * frames + start`` rounded once to
  float32 (the renderer's stated contract, ``render._fma``);
* taps, gains and the voice sum are float64; the block is clamped to
  [-1, 1] and the state advances as the renderer's contract states.

Departures, each on purpose:

* Commands are host bookkeeping: the live program applies a call's
  commands with the port's own parser and ``commands.apply`` on CPU copies
  of the state the call found and of its registry (tier-1 tests hold them
  to the JAX package), then hands the state here
  (``programs/engine_loop.reference_call``).  This module imports nothing
  of the port.
* Tracks are read from the store the port decoded (``tracks``, the
  ``[T, S * C]`` float32 array): decoding is held to its own references.
* A tap past the end of a track's row reads 0 (the port's flat store reads
  the next row there, only ever at a fraction of 0).

The track store itself is held to the asset folder's own samples
(``source_pcm``, read from the WAV and AIFF chunks here): a file at the
consensus rate must hold its integers over ``2**(bits - 1)``, and a file at
another rate those samples through ``resample``, the Kaiser-windowed sinc
interpolator the port documents (``dsp/resample.py``), computed here
output by output in float64.  MP3 files are lossy and are held to their
own references in the decode cells, so the store check passes them by.

``mix_dtype=torch.bfloat16`` stores each frame's voice sum in bfloat16:
the control, the reference at the precision below, which must read not
correct.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = U32(0x1BD11BDA)

#: the renderer's process kinds and capacities (engine/state.py)
PROC_SEQ, PROC_TREM, PROC_ENV = 1, 2, 3
MAX_STEPS = 64


# ---- Threefry-2x32 and the draws built on it, in NumPy uint32 ----------------

def threefry2x32(key, x0, x1):
    """The 20-round Threefry-2x32 hash of counters ``(x0, x1)`` under
    ``key = (k0, k1)``: uint32 arrays in, a pair of uint32 arrays out."""
    k0, k1 = U32(key[0]), U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, U32) + ks[0]
        x1 = np.asarray(x1, U32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << U32(r)) | (x1 >> U32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def fold_in(key, data: int):
    """The key folded with a 32-bit datum: the hash of the counter (0, data)."""
    y0, y1 = threefry2x32(key, U32(0), U32(int(data) & 0xFFFFFFFF))
    return (U32(y0), U32(y1))


def bits(key, n: int) -> np.ndarray:
    """32 random bits for each of n counters (0, i): the two words xored."""
    b0, b1 = threefry2x32(key, np.zeros(n, U32), np.arange(n, dtype=U32))
    return b0 ^ b1


def split2(key):
    """Two keys: the hashes of the counters (0, 0) and (0, 1)."""
    b0, b1 = threefry2x32(key, np.zeros(2, U32), np.arange(2, dtype=U32))
    return (b0[0], b1[0]), (b0[1], b1[1])


def randint_scalar(key, lo: int, hi: int) -> int:
    """One integer in [lo, hi) from two 32-bit draws of the key's split,
    combined modulo the span in uint32 arithmetic."""
    span = (hi - lo) & 0xFFFFFFFF
    ka, kb = split2(key)
    higher, lower = int(bits(ka, 1)[0]), int(bits(kb, 1)[0])
    mult = (1 << 16) % span
    mult = ((mult * mult) & 0xFFFFFFFF) % span
    off = (((higher % span) * mult) & 0xFFFFFFFF) + lower % span
    off = (off & 0xFFFFFFFF) % span
    val = (lo + off) & 0xFFFFFFFF
    return val - (1 << 32) if val >= 1 << 31 else val


def unit_floats(b: np.ndarray) -> np.ndarray:
    """Uniform float32 in [0, 1) from 32 bits: 23 mantissa bits under the
    exponent of 1.0, less 1."""
    return ((b >> U32(9)) | U32(0x3F800000)).view(np.float32) - np.float32(1.0)


def jitter_hash(step: np.ndarray, lane: np.ndarray, seed: int) -> np.ndarray:
    """The stable per-(tempo lane, step) hash of the jitter delay, uint32."""
    with np.errstate(over="ignore"):
        h = (step.astype(U32) * U32(0x9E3779B9)) ^ (lane.astype(U32) * U32(0x85EBCA6B)) \
            ^ U32(seed)
        h = h ^ (h >> U32(16))
        h = h * U32(0x7FEB352D)
        h = h ^ (h >> U32(15))
        h = h * U32(0x846CA68B)
        return h ^ (h >> U32(16))


def _wrap32(x):
    return ((np.asarray(x, np.int64) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float64).astype(np.float32)


# ---- the render --------------------------------------------------------------

def render(state: dict, tracks: np.ndarray, n_blocks: int, frames: int, out_channels: int,
           mix_dtype=torch.float64) -> tuple[np.ndarray, dict]:
    """``n_blocks`` blocks of ``frames`` from ``state`` (the checkpoint
    layout: one NumPy array per field, ``rng_key`` as uint32 ``[2]``):
    (audio float64 ``[n_blocks * frames, out_channels]``, the state after)."""
    st = {k: np.array(v) for k, v in state.items()}
    key = (U32(st["rng_key"][0]), U32(st["rng_key"][1]))
    seed = randint_scalar(fold_in(key, 7), 0, (1 << 31) - 1)
    out = [_block(st, tracks, key, seed, frames, out_channels, mix_dtype)
           for _ in range(n_blocks)]
    audio = np.concatenate(out) if out else np.zeros((0, out_channels))
    return audio, st


def _block(st, tracks, key, seed, F, C_out, mix_dtype) -> np.ndarray:
    V, P = st["p_kind"].shape
    C = int(st["track_c"])
    S = tracks.shape[1] // C
    clock = int(st["clock"])
    n_lanes = st["t_interval"].shape[0]

    # what a block holds fixed: voices, lanes, processes, the block's rolls
    vt = st["v_tempo"].astype(np.int64)
    lane = np.maximum(vt, 0)
    interval = np.maximum(st["t_interval"][lane].astype(np.int64), 1)
    t_on = st["t_active"][lane] & (vt >= 0)
    t_start = st["t_start"][lane].astype(np.int64)
    grp = st["v_group"].astype(np.int64)
    g_ok = np.where(grp >= 0, st["g_active"][np.maximum(grp, 0)], True)
    sounding = st["v_used"] & st["v_active"] & g_ok
    kind = st["p_kind"]
    is_seq = kind == PROC_SEQ
    has_seq = is_seq.any(axis=1)
    period = np.maximum(st["p_period"].astype(np.int64), 1)
    is_trem = (kind == PROC_TREM) & t_on[:, None]
    is_env = (kind == PROC_ENV) & t_on[:, None]
    depth = st["p_depth"].astype(np.float64)
    cycle = _f32(_wrap32(interval[:, None] * period)).astype(np.float64)
    track = st["v_track"].astype(np.int64)
    end = _f32(st["track_len"][track].astype(np.int64) - 1)
    vel = st["v_vel"].astype(np.float32)
    pos0 = st["v_pos"].astype(np.float32)
    reset = np.where(vel < 0, end, np.float32(0.0)).astype(np.float32)
    gain = st["v_gain"].astype(np.float64)
    roll = unit_floats(bits(fold_in(key, clock), n_lanes * F)).reshape(n_lanes, F)
    src = np.minimum(np.arange(C_out), C - 1)           # output c reads channel min(c, C-1)
    mono = st["track_ch"][track] == 1                   # mono tracks fan out
    iv32 = interval.astype(np.float32)

    voices = np.zeros((F, V, C_out))                   # each voice's weighted sample
    last = np.full(V, -1, np.int64)                     # each voice's last trigger frame
    pos = pos0
    slot = (np.arange(V)[:, None] * P + np.arange(P)[None, :]) * MAX_STEPS
    stepmask, chances, jitters = (st[n].reshape(-1) for n in ("p_stepmask", "p_chance",
                                                              "p_jitter"))
    live = sounding[:, None] & is_seq & t_on[:, None]
    ch = np.where(mono[:, None], 0, src[None, :])       # [V, C_out] track channel read
    for f in range(F):
        rel = _wrap32(_wrap32(clock + f) - t_start)     # frames since the lane started
        step = np.maximum(rel, 0) // interval
        k = slot + np.minimum(step[:, None] % period, MAX_STEPS - 1)
        in_step, chance, jit = stepmask[k], chances[k], jitters[k]
        u_j = _f32(jitter_hash(step, lane, seed)) * np.float32(2.0 ** -32)
        delay = np.floor((u_j[:, None] * jit) * iv32[:, None]).astype(np.int64)
        delay = np.minimum(delay, interval[:, None] - 1)
        on_step = (rel[:, None] >= 0) & ((np.maximum(rel, 0) % interval)[:, None] == delay)
        fire = (live & on_step & in_step & (roll[lane, f][:, None] < chance)).any(axis=1)
        last = np.where(fire, f, last)
        # one rounding to float32 from the last trigger, else the block's start
        since = np.where(last >= 0, f - last, f).astype(np.float64)
        start = np.where(last >= 0, reset, pos0).astype(np.float64)
        pos = _f32(vel.astype(np.float64) * since + start)

        started = rel[:, None] >= 0
        rel_f = _f32(rel).astype(np.float64)[:, None]
        lfo = 1.0 - depth * (0.5 - 0.5 * np.cos(2.0 * math.pi * rel_f / cycle))
        env = (1.0 - depth) + depth * np.exp(-6.9077554 * np.mod(rel_f, cycle) / cycle)
        g = np.where(is_trem & started, lfo, 1.0) * np.where(is_env & started, env, 1.0)
        w = np.where(sounding & (pos >= 0) & (pos <= end), gain * g.prod(axis=1), 0.0)

        base = np.clip(np.floor(pos).astype(np.int64), 0, S - 1)   # pos is finite
        frac = (pos - base.astype(np.float32)).astype(np.float64)
        s0 = tracks[track[:, None], base[:, None] * C + ch].astype(np.float64)
        nxt = base + 1
        s1 = np.where((nxt < S)[:, None],
                      tracks[track[:, None], np.minimum(nxt, S - 1)[:, None] * C + ch], 0.0)
        smp = s0 + (s1.astype(np.float64) - s0) * frac[:, None]
        voices[f] = w[:, None] * smp

    # the state advances: sounding voices move on from the last frame
    pos_next = np.where(sounding, (pos + vel).astype(np.float32), pos0)
    ran_off = (pos_next < 0) | (pos_next > end)
    st["v_active"] = st["v_active"] & (~sounding | has_seq | ~ran_off)
    st["v_pos"] = pos_next.astype(np.float32)
    st["clock"] = np.asarray(_wrap32(clock + F), np.int32)
    # the voice sum in float64, stored as mix_dtype, clamped
    mix = torch.from_numpy(voices).sum(dim=1).to(mix_dtype).to(torch.float64)
    return mix.clamp(-1.0, 1.0).numpy()


# ---- the track store's sources -----------------------------------------------

def _chunks(blob: bytes, start: int, order: str) -> dict[bytes, bytes]:
    """The chunks of a RIFF (``<``) or IFF (``>``) body from ``start``."""
    out, i = {}, start
    while i + 8 <= len(blob):
        cid, n = blob[i:i + 4], struct.unpack(order + "I", blob[i + 4:i + 8])[0]
        out.setdefault(cid, blob[i + 8:i + 8 + n])
        i += 8 + n + (n & 1)
    return out


def _ints(data: bytes, width: int, order: str) -> np.ndarray:
    """Signed integers of ``width`` bytes from a byte string."""
    b = np.frombuffer(data, np.uint8)[:len(data) // width * width].reshape(-1, width)
    b = b.astype(np.int64)
    if order == "<":
        b = b[:, ::-1]
    v = np.zeros(len(b), np.int64)
    for j in range(width):
        v = (v << 8) | b[:, j]
    top = 1 << (8 * width - 1)
    return np.where(v >= top, v - 2 * top, v)


def source_pcm(blob: bytes) -> tuple[np.ndarray, int]:
    """A PCM WAVE or AIFF file's samples as float64 ``[frames, channels]``,
    each integer over ``2**(bits - 1)``, and its rate."""
    if blob[:4] == b"RIFF" and blob[8:12] == b"WAVE":
        ch = _chunks(blob, 12, "<")
        tag, channels, rate, _, _, bits = struct.unpack("<HHIIHH", ch[b"fmt "][:16])
        if tag != 1:
            raise ValueError(f"WAVE format tag {tag} is not PCM")
        v = _ints(ch[b"data"], bits // 8, "<")
    elif blob[:4] == b"FORM" and blob[8:12] == b"AIFF":
        ch = _chunks(blob, 12, ">")
        channels, frames, bits = struct.unpack(">hIh", ch[b"COMM"][:8])
        exp, mant = struct.unpack(">HQ", ch[b"COMM"][8:18])
        rate = int(round(mant * 2.0 ** ((exp & 0x7FFF) - 16383 - 63)))
        offset = struct.unpack(">I", ch[b"SSND"][:4])[0]
        v = _ints(ch[b"SSND"][8 + offset:], bits // 8, ">")[:frames * channels]
    else:
        raise ValueError("neither a RIFF WAVE nor an AIFF file")
    return v.reshape(-1, channels) / float(1 << (bits - 1)), int(rate)


def resample(x: np.ndarray, src: int, dst: int, taps: int = 32, beta: float = 8.6,
             block: int = 1 << 15) -> np.ndarray:
    """``x [frames, channels]`` from ``src`` to ``dst`` Hz, float64.  With
    ``dst/src = L/M`` in lowest terms, output ``n`` sits at input time
    ``t = n M / L``; it sums the ``taps`` inputs ``floor(t) + k - taps/2 + 1``
    (zero outside the file), each weighted by ``c sinc(c d)`` times a Kaiser
    window of ``beta`` over ``d / (taps/2)``, where ``d`` is the input's
    distance from ``t`` and ``c = min(1, L/M)``.  Whole frames of ``M``
    inputs only: ``floor(frames / M) * L`` outputs."""
    g = math.gcd(src, dst)
    L, M = dst // g, src // g
    half, cut = taps // 2, min(1.0, L / M)
    n_out = (x.shape[0] // M) * L
    out = np.zeros((n_out, x.shape[1]))
    k = np.arange(taps)
    for a in range(0, n_out, block):
        n = np.arange(a, min(n_out, a + block), dtype=np.int64)
        base = (n // L) * M + (n % L) * M // L           # floor(n M / L), exactly
        frac = (n % L) * M / L - (n % L) * M // L
        d = k[None, :] - half + 1 - frac[:, None]
        w = cut * np.sinc(cut * d) * np.i0(beta * np.sqrt(np.maximum(
            0.0, 1 - (d / half) ** 2))) / np.i0(beta)
        idx = base[:, None] + k[None, :] - half + 1
        ok = (idx >= 0) & (idx < x.shape[0])
        taps_x = np.where(ok[:, :, None], x[np.clip(idx, 0, x.shape[0] - 1)], 0.0)
        out[n] = np.einsum("nk,nkc->nc", w, taps_x)
    return out

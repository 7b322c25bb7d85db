"""Block renderer — the engine's hot loop, on the state's device.

The reference renders one sample at a time, per channel, per voice,
straight into the ALSA buffer (Conductor::coordinate, engine.rs:46-81).
Here, as in the JAX package, a whole block renders as one vectorised
pass of plain torch ops:

* sequencer triggers are computed, not stepped: a tempo boundary lands on
  frame f iff ``(clock + f - start) % interval == delay``, an elementwise
  test over the [V, P, F] grid, with counter-based threefry uniforms for
  the per-step chance roll (utils/threefry.py, bit for bit JAX's draws);
  the int32 clock arithmetic wraps as two's complement, as in JAX;
* the step tables are read with one gather each at the step index (the
  JAX package's one-hot product reads the same values);
* positions are piecewise linear between triggers: the last trigger frame
  comes from a running maximum (``torch.cummax``), so every frame's
  fractional cursor is closed-form;
* samples are gathered from the flat track store (both taps of the
  linear interpolation) and mixed as a masked sum over voices in f32,
  clamped to [-1, 1].

Rendering advances only ``v_active``, ``v_pos`` and ``clock``; every other
tensor of the state passes through as the same object.  ``render_chain``
and the playback loop's speculation depend on that.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils import threefry
from .state import MAX_STEPS, PROC_ENV, PROC_SEQ, PROC_TREM, EngineArrays


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement (JAX's int32 add)."""
    return (((x + (1 << 31)) & threefry.M32) - (1 << 31)).to(torch.int32)


#: id(key tensor) → (key, seed): the jitter seed depends only on
#: ``rng_key``, which no command and no render changes (the tensor passes
#: through every state unchanged), so each key tensor's seed is derived
#: once instead of with four threefry hashes a block
_SEEDS: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def _jitter_seed(key: torch.Tensor) -> torch.Tensor:
    """The jitter hash's seed: ``randint(fold_in(key, 7), (), 0, 2**31 - 1)``."""
    hit = _SEEDS.get(id(key))
    if hit is not None and hit[0] is key:
        return hit[1]
    seed = threefry.randint(threefry.fold_in(key, 7), (), 0, (1 << 31) - 1).long()
    if len(_SEEDS) >= 16:
        _SEEDS.clear()
    _SEEDS[id(key)] = (key, seed)  # the key is held, so its id stays unique
    return seed


def render_block(st: EngineArrays, *, frames: int, out_channels: int
                 ) -> tuple[torch.Tensor, EngineArrays]:
    """Render ``frames`` samples → (block [frames, out_channels] f32, state')."""
    mix, st2 = render_mix(st, frames=frames, out_channels=out_channels)
    return mix.clamp(-1.0, 1.0), st2


def render_mix(st: EngineArrays, *, frames: int, out_channels: int
               ) -> tuple[torch.Tensor, EngineArrays]:
    """``render_block`` before the clamp: (the voices' summed mix
    [frames, out_channels] f32, state').  The voice-sharded render
    (parallel/render.py) adds the shards' mixes, then clamps once.  The
    per-voice fields may hold any subset of the voices: tempo lanes,
    groups and tracks are indexed through the voices' own fields."""
    F = frames
    f32, i64 = torch.float32, torch.int64
    dev = st.device
    fidx = torch.arange(F, dtype=i64, device=dev)  # [F]

    # ---- process chains on the [V, P, F] grid ----
    lane = st.v_tempo.clamp(min=0).long()
    interval = st.t_interval[lane].clamp(min=1)  # i32 [V]
    t_on = st.t_active[lane] & (st.v_tempo >= 0)
    clock_f = _wrap_i32(st.clock.long() + fidx)  # [F]
    rel = _wrap_i32(clock_f[None, :].long() - st.t_start[lane].long()[:, None])
    step_num = rel.clamp(min=0) // interval[:, None]  # i32 [V, F]
    is_seq = st.p_kind == PROC_SEQ  # [V, P]
    k = step_num[:, None, :] % st.p_period.clamp(min=1)[:, :, None]
    k = k.clamp(max=MAX_STEPS - 1).long()  # [V, P, F]
    in_step = torch.gather(st.p_stepmask, 2, k)
    chance = torch.gather(st.p_chance, 2, k)
    jit_k = torch.gather(st.p_jitter, 2, k)
    # per-step trigger jitter: the boundary is delayed by
    # floor(u * jitter * interval) frames, u a stable hash of (tempo lane,
    # absolute step number), in uint32 arithmetic carried in int64
    seed = _jitter_seed(st.rng_key)
    h = (threefry.mul32(step_num.long(), 0x9E3779B9)
         ^ threefry.mul32(lane[:, None], 0x85EBCA6B) ^ seed)
    h = h ^ (h >> 16)
    h = threefry.mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = threefry.mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    # uint32 → f32 rounds to nearest (the f64 step is exact)
    u_j = h.to(torch.float64).to(f32) * (1.0 / 4294967296.0)  # [V, F]
    delay = torch.floor(
        u_j[:, None, :] * jit_k * interval[:, None, None].to(f32)).to(torch.int32)
    # a hash rounded up to 1.0 gives delay == interval: clamp so a full-
    # jitter step still fires on its last frame
    delay = torch.minimum(delay, interval[:, None, None] - 1)
    boundary = (rel[:, None, :] >= 0) & (
        rel[:, None, :] % interval[:, None, None] == delay)  # [V, P, F]
    # chance rolls are keyed by tempo lane: the voices of one group
    # sequencer share a roll, independent voices draw their own
    n_lanes = st.t_interval.shape[0]
    u_lane = threefry.uniform(threefry.fold_in(st.rng_key, st.clock), (n_lanes, F))
    u = u_lane[lane]  # [V, F]
    grp = st.v_group
    g_ok = torch.where(grp >= 0, st.g_active[grp.clamp(min=0).long()], True)
    sounding = st.v_used & st.v_active & g_ok
    has_seq = is_seq.any(dim=1)  # [V]
    trig = (
        sounding[:, None, None]
        & is_seq[:, :, None]
        & t_on[:, None, None]
        & boundary
        & in_step
        & (u[:, None, :] < chance)
    ).any(dim=1)  # [V, F]

    # gain processes, tempo-synced, unity at phase 0:
    #   TREM — raised-cosine LFO over p_period steps;
    #   ENV  — per-cycle exponential decay to (1 - depth) + ~0.001·depth
    cycle = _wrap_i32(interval[:, None, None].long()
                      * st.p_period.clamp(min=1)[:, :, None].long()).to(f32)
    rel_f = rel[:, None, :].to(f32)
    depth = st.p_depth[:, :, None]
    is_trem = (st.p_kind == PROC_TREM) & t_on[:, None]  # [V, P]
    ph = rel_f / cycle
    lfo = 1.0 - depth * (0.5 - 0.5 * torch.cos((2.0 * math.pi) * ph))
    is_env = (st.p_kind == PROC_ENV) & t_on[:, None]
    ph_cyc = _py_mod(rel_f, cycle) / cycle  # [0, 1)
    env = (1.0 - depth) + depth * torch.exp(-6.9077554 * ph_cyc)
    started = rel[:, None, :] >= 0
    slot_mult = torch.where(is_trem[:, :, None] & started, lfo, 1.0)
    slot_mult = slot_mult * torch.where(is_env[:, :, None] & started, env, 1.0)
    gain_mult = slot_mult.prod(dim=1)  # [V, F]

    # ---- closed-form positions between triggers ----
    end = (st.track_len[st.v_track.long()] - 1).to(f32)  # [V]
    reset = torch.where(st.v_vel < 0, end, 0.0)  # [V]
    last_trig = torch.cummax(
        torch.where(trig, fidx[None, :], -1), dim=1).values  # [V, F]
    fidx_f = fidx.to(f32)
    free_pos = _fma(st.v_vel[:, None], fidx_f[None, :], st.v_pos[:, None])
    trig_pos = _fma(st.v_vel[:, None], (fidx[None, :] - last_trig).to(f32),
                    reset[:, None])
    pos = torch.where(last_trig >= 0, trig_pos, free_pos)  # [V, F]

    # ---- audibility + sample fetch (two taps, linear interpolation) ----
    in_range = (pos >= 0.0) & (pos <= end[:, None])
    audible = sounding[:, None] & in_range  # [V, F]

    C_t = st.track_c
    S = st.tracks.shape[1] // C_t
    # f32 → int as XLA converts (NaN → 0, saturating), then clipped
    fl = torch.nan_to_num(torch.floor(pos), nan=0.0).clamp(-2.0**31, 2.0**31)
    base = fl.long().clamp(0, S - 1)
    frac = pos - base.to(f32)
    # both taps for every channel from the flat store; a tap past the
    # store's end reads 0 (it only ever meets frac == 0 or silence)
    flat = st.tracks.reshape(-1)
    ch = torch.arange(C_t, device=dev)
    i0 = ((st.v_track.long()[:, None] * S + base) * C_t)[..., None] + ch  # [V, F, C]
    i1 = i0 + C_t
    s0 = flat[i0]
    s1 = torch.where(i1 < flat.numel(), flat[i1.clamp(max=flat.numel() - 1)], 0.0)
    smp = s0 + (s1 - s0) * frac[..., None]  # [V, F, C]

    # channel routing: output channel c reads track channel min(c, C-1);
    # 1-channel tracks fan out to every output (engine.rs:419-427)
    smp = smp[:, :, torch.arange(out_channels, device=dev).clamp(max=C_t - 1)]
    mono = (st.track_ch[st.v_track.long()] == 1)[:, None, None]
    smp = torch.where(mono, smp[:, :, :1], smp)

    w = torch.where(audible, st.v_gain[:, None] * gain_mult, 0.0)  # [V, F]
    mix = (w[..., None] * smp).sum(dim=0)  # [F, out], clamped by the caller

    # ---- advance state (paused/stopped voices hold position) ----
    pos_next = torch.where(sounding, pos[:, F - 1] + st.v_vel, st.v_pos)
    # without a sequencer the voice parks when it runs off the track
    ran_off = (pos_next < 0.0) | (pos_next > end)
    active_next = st.v_active & (~sounding | has_seq | ~ran_off)
    return mix, dataclasses.replace(
        st, v_active=active_next, v_pos=pos_next,
        clock=_wrap_i32(st.clock.long() + F))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as XLA's fused multiply-add
    computes it (the f64 product of two f32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _py_mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Floored float modulo computed as JAX's ``jnp.mod``: ``fmod`` (exact),
    then the divisor added where the signs differ."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def render_chain(st: EngineArrays, *, frames: int, out_channels: int,
                 depth: int) -> tuple[torch.Tensor, ...]:
    """``depth`` consecutive blocks, left on the device for one fetch.

    A loop of ``render_block`` (each block's ops at the same shapes as a
    single call, so the blocks are bit for bit those of ``depth`` calls).
    Returns ``(blocks [D, frames, out_channels], v_active [D, V],
    v_pos [D, V], clock [D])``: the only state the renderer advances, so
    block i's full post-state is ``dataclasses.replace(st, v_active=..[i],
    v_pos=..[i], clock=..[i])`` with every other tensor shared."""
    blocks, acts, poss, clocks = [], [], [], []
    for _ in range(depth):
        blk, st = render_block(st, frames=frames, out_channels=out_channels)
        blocks.append(blk)
        acts.append(st.v_active)
        poss.append(st.v_pos)
        clocks.append(st.clock)
    return (torch.stack(blocks), torch.stack(acts), torch.stack(poss),
            torch.stack(clocks))


def render_seconds(st: EngineArrays, seconds: float, rate: int,
                   out_channels: int, block: int = 128):
    """Render a stretch of audio block by block (test/offline sink):
    (numpy f32 [frames, out_channels], state')."""
    n_blocks = int(seconds * rate) // block
    out = []
    for _ in range(n_blocks):
        blk, st = render_block(st, frames=block, out_channels=out_channels)
        out.append(blk)
    if not out:
        return np.zeros((0, out_channels), np.float32), st
    return torch.cat(out).cpu().numpy(), st

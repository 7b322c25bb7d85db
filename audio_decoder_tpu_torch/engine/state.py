"""Engine state: voices, groups, tempo and sequencers as device tensors.

The reference's render graph is heap objects with RefCells (a
`Conductor` owning `Voice`/`Group`, each cloning its track samples,
engine.rs:27-33, 279-449; shared `Rc<RefCell<TempoState>>` clocks,
blast_time.rs:57-64; per-voice `Seq` sequencers, processes.rs:52-99).
Here, as in the JAX package, the engine is a fixed-capacity
structure of arrays: a frozen dataclass of tensors on one device that
flows through the block renderer, with commands applied between blocks
as clone-on-write updates (engine/commands.py).

Capacity is static (MAX_VOICES / MAX_STEPS); inactive slots are masked.
Tracks live in one flat interleaved tensor ``[T, S*C]`` so a voice's
sample reads are gathers, and voices that play one track share it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import threefry

MAX_VOICES = 64
MAX_GROUPS = 16
MAX_CONTEXTS = 16
MAX_STEPS = 64  # sequencer period capacity (steps per period)
MAX_PROCS = 4  # process-chain slots per voice (≙ Vec<Process>)

#: process kinds (≙ the processes! enum dispatch, processes.rs:12-50;
#: Seq ≙ processes.rs:52-99; tremolo and the decay envelope are further
#: kinds on the same axis)
PROC_NONE = 0
PROC_SEQ = 1
PROC_TREM = 2
PROC_ENV = 3

#: tempo owner kinds (≙ TempoMode, blast_time.rs:66-74)
TEMPO_VOICE = 0
TEMPO_GROUP = 1
TEMPO_CONTEXT = 2

#: the seed of every fresh state's key (the JAX package's PRNGKey seed)
RNG_SEED = 0xB1A57


@dataclasses.dataclass(frozen=True)
class EngineArrays:
    """Device-resident engine state: every tensor on one device.

    No function of the port writes into these tensors: commands replace
    the ones they change with updated copies, and speculated render
    states share every other tensor with the committed state."""

    tracks: torch.Tensor  # f32 [T, S*C] padded decoded PCM, flat interleaved
    track_len: torch.Tensor  # i32 [T]
    track_ch: torch.Tensor  # i32 [T]

    # voices (SoA over MAX_VOICES; ≙ VoiceState engine.rs:279-286)
    v_used: torch.Tensor  # bool [V] slot allocated
    v_active: torch.Tensor  # bool [V] currently sounding
    v_track: torch.Tensor  # i32 [V]
    v_pos: torch.Tensor  # f32 [V] fractional sample cursor
    v_vel: torch.Tensor  # f32 [V] signed playback velocity
    v_gain: torch.Tensor  # f32 [V]
    v_group: torch.Tensor  # i32 [V] owning group or -1

    # tempo lanes, one per voice/group/context owner (≙ TempoState)
    t_interval: torch.Tensor  # i32 [V + G + X] interval in samples
    t_start: torch.Tensor  # i32 [V + G + X] clock at (re)start
    t_active: torch.Tensor  # bool [V + G + X]
    v_tempo: torch.Tensor  # i32 [V] tempo lane per voice (-1 none, -2 group TBD)
    g_tempo: torch.Tensor  # i32 [G] tempo lane per group (-1 = none)

    # process chains: MAX_PROCS enum-dispatched slots per voice
    p_kind: torch.Tensor  # i32 [V, P] PROC_NONE/SEQ/TREM/ENV
    p_period: torch.Tensor  # i32 [V, P] steps per cycle
    p_stepmask: torch.Tensor  # bool [V, P, MAX_STEPS] seq trigger steps
    p_chance: torch.Tensor  # f32 [V, P, MAX_STEPS] seq per-step probability
    p_jitter: torch.Tensor  # f32 [V, P, MAX_STEPS] seq trigger delay (fraction
    #                         of the tempo interval)
    p_depth: torch.Tensor  # f32 [V, P] trem/env modulation depth in [0, 1]

    # groups
    g_used: torch.Tensor  # bool [G]
    g_active: torch.Tensor  # bool [G]

    # global sample clock (≙ blast_time.rs:24-36), i32 0-d, wraps as int32
    clock: torch.Tensor
    #: raw threefry key data, uint32 values in i64 [2] (utils/threefry.py)
    rng_key: torch.Tensor

    # static storage channel count C of the track interleaving
    track_c: int = 1

    @property
    def device(self) -> torch.device:
        return self.tracks.device


#: every tensor field with its dtype (JAX's, but int64 for the key data)
FIELD_DTYPES = {
    "tracks": torch.float32, "track_len": torch.int32, "track_ch": torch.int32,
    "v_used": torch.bool, "v_active": torch.bool, "v_track": torch.int32,
    "v_pos": torch.float32, "v_vel": torch.float32, "v_gain": torch.float32,
    "v_group": torch.int32, "t_interval": torch.int32, "t_start": torch.int32,
    "t_active": torch.bool, "v_tempo": torch.int32, "g_tempo": torch.int32,
    "p_kind": torch.int32, "p_period": torch.int32, "p_stepmask": torch.bool,
    "p_chance": torch.float32, "p_jitter": torch.float32,
    "p_depth": torch.float32, "g_used": torch.bool, "g_active": torch.bool,
    "clock": torch.int32, "rng_key": torch.int64,
}


def empty_state(
    tracks, track_len, track_ch, out_channels: int,
    *, channels: int | None = None, device="cuda",
) -> EngineArrays:
    """Build a fresh engine state on ``device``.

    ``tracks`` is planar ``[T, S, C]`` (flattened here) or already flat
    ``[T, S*C]`` with ``channels`` giving C."""
    from ..codecs.registry import resolve_device

    dev = resolve_device(device)
    V, G, X = MAX_VOICES, MAX_GROUPS, MAX_CONTEXTS
    lanes = V + G + X
    tracks = torch.as_tensor(tracks, dtype=torch.float32, device=dev)
    if tracks.ndim == 3:
        T, _S, C = tracks.shape
        tracks = tracks.reshape(T, -1)
    else:
        if channels is None:
            raise ValueError("flat tracks need an explicit channels=")
        C = int(channels)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return EngineArrays(
        track_c=C,
        tracks=tracks,
        track_len=torch.as_tensor(track_len, dtype=torch.int32, device=dev),
        track_ch=torch.as_tensor(track_ch, dtype=torch.int32, device=dev),
        v_used=full((V,), False, torch.bool),
        v_active=full((V,), False, torch.bool),
        v_track=full((V,), 0, torch.int32),
        v_pos=full((V,), 0.0, torch.float32),
        v_vel=full((V,), 1.0, torch.float32),
        v_gain=full((V,), 1.0, torch.float32),
        v_group=full((V,), -1, torch.int32),
        t_interval=full((lanes,), 1, torch.int32),
        t_start=full((lanes,), 0, torch.int32),
        t_active=full((lanes,), False, torch.bool),
        v_tempo=full((V,), -1, torch.int32),
        g_tempo=full((G,), -1, torch.int32),
        p_kind=full((V, MAX_PROCS), PROC_NONE, torch.int32),
        p_period=full((V, MAX_PROCS), 1, torch.int32),
        p_stepmask=full((V, MAX_PROCS, MAX_STEPS), False, torch.bool),
        p_chance=full((V, MAX_PROCS, MAX_STEPS), 0.0, torch.float32),
        p_jitter=full((V, MAX_PROCS, MAX_STEPS), 0.0, torch.float32),
        p_depth=full((V, MAX_PROCS), 0.0, torch.float32),
        g_used=full((G,), False, torch.bool),
        g_active=full((G,), False, torch.bool),
        clock=full((), 0, torch.int32),
        rng_key=threefry.prng_key(RNG_SEED, device=dev),
    )


def from_numpy(arrays: dict, device="cuda") -> EngineArrays:
    """A state from numpy arrays in the checkpoint layout (one entry per
    field; ``track_c`` a scalar; ``rng_key`` raw uint32 key data ``[2]``).
    This is also how a JAX package state crosses into the port."""
    from ..codecs.registry import resolve_device

    dev = resolve_device(device)
    kw = {"track_c": int(arrays["track_c"])}
    for name, dtype in FIELD_DTYPES.items():
        a = np.asarray(arrays[name])
        if name == "rng_key":
            a = a.astype(np.uint32).astype(np.int64)
        kw[name] = torch.tensor(a, device=dev).to(dtype)
    return EngineArrays(**kw)


def to_numpy(st: EngineArrays) -> dict:
    """The state as numpy arrays in the checkpoint layout (inverse of
    ``from_numpy``): JAX's dtypes, ``rng_key`` as uint32."""
    out = {}
    for name in FIELD_DTYPES:
        a = getattr(st, name).cpu().numpy()
        out[name] = a.astype(np.uint32) if name == "rng_key" else a
    out["track_c"] = np.asarray(st.track_c)
    return out


def tracks_from_batch(batch, consensus_channels: int):
    """AudioBatch → (flat tracks [T, S*C], lens, chs) tensors on the batch's
    device, C = consensus_channels.  A batch already interleaved at the
    consensus width passes through without a copy."""
    if batch.channels == consensus_channels:
        return batch.data, batch.valid_frames, batch.num_channels
    pcm = batch.pcm
    if pcm.shape[2] < consensus_channels:
        pcm = torch.nn.functional.pad(
            pcm, (0, consensus_channels - pcm.shape[2]))
    pcm = pcm[:, :, :consensus_channels]
    return (pcm.reshape(pcm.shape[0], -1), batch.valid_frames,
            batch.num_channels)


class HostRegistry:
    """Host-side name → slot mirror (≙ EngineState, commands.rs:287-310).

    All naming, lookup and validation happens here so the renderer only
    ever sees integer slots — the same split the reference enforces
    between its REPL thread and audio thread."""

    def __init__(self, track_names: list[str]):
        self.tracks = {n: i for i, n in enumerate(track_names)}
        self.voices: dict[str, int] = {}
        self.groups: dict[str, int] = {}
        self.contexts: dict[str, int] = {}
        self.group_members: dict[str, list[str]] = {}
        self._free_v = list(range(MAX_VOICES))
        self._free_g = list(range(MAX_GROUPS))
        self._free_x = list(range(MAX_CONTEXTS))

    def alloc_voice(self, name: str) -> int:
        if name in self.voices:
            raise KeyError(f"voice exists: {name}")
        if not self._free_v:
            raise RuntimeError("voice capacity exhausted")
        slot = self._free_v.pop(0)
        self.voices[name] = slot
        return slot

    def free_voice(self, name: str) -> int:
        slot = self.voices.pop(name)
        self._free_v.append(slot)
        return slot

    def alloc_group(self, name: str) -> int:
        if name in self.groups:
            raise KeyError(f"group exists: {name}")
        if not self._free_g:
            raise RuntimeError("group capacity exhausted")
        slot = self._free_g.pop(0)
        self.groups[name] = slot
        self.group_members[name] = []
        return slot

    def alloc_context(self, name: str) -> int:
        if name in self.contexts:
            raise KeyError(f"tempo context exists: {name}")
        if not self._free_x:
            raise RuntimeError("context capacity exhausted")
        slot = self._free_x.pop(0)
        self.contexts[name] = slot
        return slot

    # tempo lane index layout: [voices | groups | contexts]
    @staticmethod
    def voice_lane(v: int) -> int:
        return v

    @staticmethod
    def group_lane(g: int) -> int:
        return MAX_VOICES + g

    @staticmethod
    def context_lane(x: int) -> int:
        return MAX_VOICES + MAX_GROUPS + x

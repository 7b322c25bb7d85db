"""Engine state checkpoint / resume.

The reference has no persistence at all — voices/groups/tempo are rebuilt
per run and only in-session REPL history survives (SURVEY §5).  Because
this engine's whole state is a dataclass of tensors plus a name registry,
a checkpoint is just an npz + a JSON sidecar, in the JAX package's layout
(version 3; ``rng_key`` as raw uint32 key data), so a checkpoint written
by either package loads in the other; a session can stop and resume
mid-performance with sample-exact continuity (the global clock, voice
cursors, tempo phases and RNG key all round-trip).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .state import (
    MAX_PROCS, MAX_STEPS, PROC_SEQ, EngineArrays, HostRegistry, from_numpy,
    to_numpy,
)

_VERSION = 3


def _migrate_1_to_2(z: dict) -> dict:
    """v1 → v2: the single per-voice sequencer arrays (s_*) became
    MAX_PROCS-slot process chains (p_*); a v1 sequencer moves into
    slot 0 with kind PROC_SEQ."""
    out = dict(z)
    s_on = np.asarray(out.pop("s_on"))
    period = np.asarray(out.pop("s_period"))
    mask = np.asarray(out.pop("s_stepmask"))
    chance = np.asarray(out.pop("s_chance"))
    jit = np.asarray(out.pop("s_jitter"))
    V, S = mask.shape
    p_kind = np.zeros((V, MAX_PROCS), np.int32)
    p_kind[:, 0] = np.where(s_on, PROC_SEQ, 0)
    p_period = np.ones((V, MAX_PROCS), np.int32)
    p_period[:, 0] = period
    p_stepmask = np.zeros((V, MAX_PROCS, S), bool)
    p_stepmask[:, 0] = mask
    p_chance = np.zeros((V, MAX_PROCS, S), np.float32)
    p_chance[:, 0] = chance
    p_jitter = np.zeros((V, MAX_PROCS, S), np.float32)
    p_jitter[:, 0] = jit
    out.update(
        p_kind=p_kind, p_period=p_period, p_stepmask=p_stepmask,
        p_chance=p_chance, p_jitter=p_jitter,
        p_depth=np.zeros((V, MAX_PROCS), np.float32),
    )
    return out


def _migrate_2_to_3(z: dict) -> dict:
    """v2 → v3: the track store went flat interleaved — ``tracks``
    [T, S, C] became [T, S*C] plus the static channel count ``track_c``
    (the engine's AudioBatch-style layout change; state.py docstring).
    Flattening a C-order array is byte-identical, so the migration is a
    reshape plus recording C."""
    out = dict(z)
    t = np.asarray(out["tracks"])
    if t.ndim == 3:
        T, _S, C = t.shape
        out["tracks"] = t.reshape(T, -1)
        out["track_c"] = np.asarray(C, np.int32)
    elif "track_c" not in out:  # already flat but width unrecorded
        raise ValueError("v2 checkpoint with flat tracks lacks track_c")
    # the JAX package's derived row store; the port keeps none
    out.pop("track_rows", None)
    return out


#: version k → migration producing a version-(k+1) array dict
_MIGRATIONS = {1: _migrate_1_to_2, 2: _migrate_2_to_3}

#: general forward-compat rule: a field absent from a version-k
#: checkpoint gets its documented default before that version migrates
#: forward (replaces the old one-off s_jitter special case — any field
#: added mid-version registers its default here)
_FIELD_DEFAULTS: dict = {
    1: {
        # added after v1 shipped: no jitter
        "s_jitter": lambda z: np.zeros_like(np.asarray(z["s_chance"],
                                                       np.float32)),
    },
    # every process-chain field defaults to "empty chain" so a stripped
    # v2/v3 npz still loads
    2: {
        "p_kind": lambda z: np.zeros(
            (np.asarray(z["v_used"]).shape[0], MAX_PROCS), np.int32),
        "p_period": lambda z: np.ones(
            (np.asarray(z["v_used"]).shape[0], MAX_PROCS), np.int32),
        "p_stepmask": lambda z: np.zeros(
            (np.asarray(z["v_used"]).shape[0], MAX_PROCS, MAX_STEPS), bool),
        "p_chance": lambda z: np.zeros(
            (np.asarray(z["v_used"]).shape[0], MAX_PROCS, MAX_STEPS), np.float32),
        "p_jitter": lambda z: np.zeros(
            (np.asarray(z["v_used"]).shape[0], MAX_PROCS, MAX_STEPS), np.float32),
        "p_depth": lambda z: np.zeros(
            (np.asarray(z["v_used"]).shape[0], MAX_PROCS), np.float32),
    },
}

_FIELD_DEFAULTS[3] = dict(_FIELD_DEFAULTS[2])


def _apply_defaults(z: dict, version: int) -> dict:
    for name, make in _FIELD_DEFAULTS.get(version, {}).items():
        if name not in z:
            z[name] = make(z)
    return z


def save_state(path: str, st: EngineArrays, reg: HostRegistry) -> None:
    """Write `path`.npz (arrays) and `path`.json (registry)."""
    arrays = to_numpy(st)
    np.savez_compressed(path + ".npz", **arrays)
    meta = dict(
        version=_VERSION,
        tracks=reg.tracks,
        voices=reg.voices,
        groups=reg.groups,
        contexts=reg.contexts,
        group_members=reg.group_members,
        free_v=reg._free_v,
        free_g=reg._free_g,
        free_x=reg._free_x,
    )
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_state(path: str, *, device="cuda") -> tuple[EngineArrays, HostRegistry]:
    """Restore a (state, registry) pair saved by save_state (of either
    package), with the state's tensors on ``device``."""
    if not (os.path.exists(path + ".npz") and os.path.exists(path + ".json")):
        raise FileNotFoundError(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    version = meta.get("version")
    if not isinstance(version, int) or version < 1 or version > _VERSION:
        raise ValueError(f"unsupported checkpoint version {version!r}")
    npz = np.load(path + ".npz")
    z = {name: npz[name] for name in npz.files}
    # walk the migration chain: per version, fill documented defaults for
    # fields added mid-version, then migrate the dict one version forward
    while version < _VERSION:
        z = _apply_defaults(z, version)
        z = _MIGRATIONS[version](z)
        version += 1
    z = _apply_defaults(z, _VERSION)
    for f_ in dataclasses.fields(EngineArrays):
        if f_.name not in z:
            raise ValueError(f"checkpoint missing field {f_.name}")
    st = from_numpy(z, device)
    reg = HostRegistry(list(meta["tracks"]))
    reg.tracks = {k: int(v) for k, v in meta["tracks"].items()}
    reg.voices = {k: int(v) for k, v in meta["voices"].items()}
    reg.groups = {k: int(v) for k, v in meta["groups"].items()}
    reg.contexts = {k: int(v) for k, v in meta["contexts"].items()}
    reg.group_members = {k: list(v) for k, v in meta["group_members"].items()}
    reg._free_v = list(meta["free_v"])
    reg._free_g = list(meta["free_g"])
    reg._free_x = list(meta["free_x"])
    return st, reg

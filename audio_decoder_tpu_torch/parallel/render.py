"""Voice-sharded (model-parallel) engine rendering.

It is the port of the JAX package's ``parallel/render.py``.  The voice
axis of the engine state splits over the mesh's ``model`` axis: model
shard j holds voices [j*V/m, (j+1)*V/m) on the device at (data 0, model
j), with every other field (tracks, tempo lanes, groups, clock, key)
replicated there.  Each shard renders its voices' unclamped mix
(``engine.render.render_mix``); one ``psum`` over the shards adds the
mixes, and the block is clamped once, as GSPMD's psum-then-clamp does (a
shard that clamped its own mix would give another block whenever the
mixes' sum exceeds 1).  The random draws are not per voice: every shard
draws the chance uniforms over all tempo lanes and hashes the jitter by
tempo lane, then reads its voices' rows, so the draws equal the single-
device render's.  The block differs from it only by the order of the sum
over voices (within 2e-6); positions, active flags and the clock are
equal.
"""

from __future__ import annotations

import dataclasses

import torch

from ..engine.render import render_mix
from ..engine.state import EngineArrays
from . import mesh as M

#: EngineArrays fields whose leading axis is the voice axis
_VOICE_FIELDS = (
    "v_used", "v_active", "v_track", "v_pos", "v_vel", "v_gain", "v_group",
    "v_tempo", "p_kind", "p_period", "p_stepmask", "p_chance", "p_jitter",
    "p_depth",
)


def state_shardings(mesh: M.Mesh, st: EngineArrays) -> dict:
    """{tensor field: the mesh axis it splits over}: ``"model"`` for the
    per-voice fields, None (replicated) for the rest."""
    return {f.name: ("model" if f.name in _VOICE_FIELDS else None)
            for f in dataclasses.fields(st) if torch.is_tensor(getattr(st, f.name))}


@dataclasses.dataclass(frozen=True)
class ShardedEngine:
    """An engine state placed on a mesh: ``parts[j]`` is model shard j's
    ``EngineArrays`` (its voices, and the replicated fields) on its
    device."""

    parts: tuple

    def gather(self, device=None) -> EngineArrays:
        """The whole state on ``device`` (default: shard 0's): voices
        concatenated in shard order, the rest from shard 0."""
        dev = self.parts[0].device if device is None else torch.device(device)
        st = self.parts[0]
        return dataclasses.replace(st, **{
            k: (torch.cat([getattr(p, k).to(dev) for p in self.parts])
                if k in _VOICE_FIELDS else getattr(st, k).to(dev))
            for k in state_shardings(None, st)})


def shard_engine_state(st: EngineArrays, mesh: M.Mesh) -> ShardedEngine:
    """Place an engine state on the mesh per ``state_shardings``: raises
    unless the ``model`` size divides the voices."""
    spec = state_shardings(mesh, st)
    cut = {k: M.shard(getattr(st, k), mesh, "model")
           for k, axis in spec.items() if axis == "model"}
    return ShardedEngine(tuple(
        dataclasses.replace(st, **{k: s.shards[j] for k, s in cut.items()},
                            **{k: getattr(st, k).to(d)
                               for k, axis in spec.items() if axis is None})
        for j, d in enumerate(mesh.axis_devices("model"))))


def sharded_render_fn(mesh: M.Mesh, *, frames: int, out_channels: int):
    """Bind the block render to a mesh: ``step(sharded_state)`` →
    (block ``Replicated`` on every mesh device, sharded_state')."""

    def step(sst: ShardedEngine):
        outs = [render_mix(p, frames=frames, out_channels=out_channels)
                for p in sst.parts]
        block = M.psum([mix for mix, _ in outs], mesh)
        return (block.map(lambda b: b.clamp(-1.0, 1.0)),
                ShardedEngine(tuple(p for _, p in outs)))

    return step

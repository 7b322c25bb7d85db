"""Device mesh, shards and the collectives of the sharded paths.

It is the port of the JAX package's ``parallel/mesh.py``.  JAX runs a
``('data', 'model')`` mesh as one SPMD program; here one process drives
every shard in turn, as a single controller, and a shard's tensors live
on its device:

* ``data`` splits the file (or lane) batch: a data-sharded step runs each
  data shard once, on the device at (data i, model 0);
* ``model`` splits the engine's voices (``parallel/render.py``).

A mesh device may repeat (``make_mesh(8, 2, devices=["cuda:0"] * 8)``):
the shards are then logical and share the card, as XLA's virtual host
devices share the CPU.  A sharded result is a ``Sharded`` (one tensor per
shard of an axis, on that shard's device), a replicated one a
``Replicated`` (an equal copy per mesh device; devices that repeat hold
one copy).

``psum`` sums the shards' partials: first the partials that share a
device, there, in shard order (so repeated runs are bit-identical), then
across distinct cards with NCCL (``torch.cuda.comm.reduce_add``, then
``broadcast``: an all-reduce in one process).  ``collectives`` counts
both kinds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.cuda.comm  # noqa: F401  (not loaded by ``import torch``)
import torch.cuda.nccl  # noqa: F401

AXES = ("data", "model")

#: times each collective ran in this process: every ``psum``; the psums
#: whose cross-card step ran NCCL; every ``all_gather``
collectives = {"psum": 0, "psum_nccl": 0, "all_gather": 0}


def _norm(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of torch devices."""

    grid: tuple  # [data][model] torch.device

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "model": len(self.grid[0])}

    @property
    def axis_names(self) -> tuple:
        return AXES

    @property
    def devices(self) -> list[torch.device]:
        """Every mesh device, data-major (a device may repeat)."""
        return [d for row in self.grid for d in row]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The device of each shard of ``axis``: (data i, model 0) for
        ``data``, (data 0, model j) for ``model``."""
        if axis == "data":
            return [row[0] for row in self.grid]
        if axis == "model":
            return list(self.grid[0])
        raise ValueError(f"mesh axis must be one of {AXES}, got {axis!r}")


def make_mesh(n_devices: int | None = None, model_parallel: int = 1, *,
              devices: Sequence | None = None) -> Mesh:
    """A ``('data', 'model')`` mesh over the first ``n_devices`` visible
    CUDA devices (all of them by default), or over the first ``n_devices``
    of ``devices``, an explicit list that may repeat a device (logical
    shards on one card, or on the CPU).  Raises when ``n_devices`` exceeds
    the devices there are or is not divisible by ``model_parallel``."""
    if devices is None:
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        pool = [_norm(d) for d in devices]
    n = len(pool) if n_devices is None else n_devices
    if n > len(pool):
        where = "listed" if devices is not None else "visible CUDA devices"
        raise ValueError(f"requested {n} devices, have {len(pool)} ({where})")
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model={model_parallel}")
    pool = pool[:n]
    if len({d.type for d in pool}) != 1:
        raise ValueError(f"mesh devices must be of one type, got {pool}")
    m = model_parallel
    return Mesh(tuple(tuple(pool[i * m:(i + 1) * m]) for i in range(n // m)))


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A tensor cut along dim 0 over one mesh axis: ``shards[i]`` is shard
    i's rows, on that shard's device."""

    shards: tuple

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: shard 0's)."""
        dev = self.shards[0].device if device is None else torch.device(device)
        return torch.cat([s.to(dev) for s in self.shards])


@dataclasses.dataclass(frozen=True)
class Replicated:
    """An equal copy on every device of ``devices`` (mesh order);
    ``copies[k]`` lies on ``devices[k]``, and a device that repeats holds
    one copy."""

    devices: tuple
    copies: tuple

    def on(self, device) -> torch.Tensor:
        """The copy on ``device``."""
        return self.copies[self.devices.index(_norm(device))]

    @property
    def value(self) -> torch.Tensor:
        return self.copies[0]

    def map(self, fn) -> "Replicated":
        """``fn`` applied once per distinct device's copy."""
        done: dict = {}
        for d, c in zip(self.devices, self.copies):
            if d not in done:
                done[d] = fn(c)
        return Replicated(self.devices, tuple(done[d] for d in self.devices))


def _from_distinct(devices: Sequence[torch.device], per_device: dict) -> Replicated:
    devices = tuple(devices)
    return Replicated(devices, tuple(per_device[d] for d in devices))


def replicate(x, mesh: Mesh, to: Sequence | None = None) -> Replicated:
    """``x`` (a tensor, an array or a ``Replicated``) copied to every device
    of ``to`` (default: every mesh device)."""
    if isinstance(x, Replicated):
        return x
    t = torch.as_tensor(x)
    to = mesh.devices if to is None else [_norm(d) for d in to]
    return _from_distinct(to, {d: t.to(d) for d in dict.fromkeys(to)})


def shard(x, mesh: Mesh, axis: str = "data") -> Sharded:
    """``x`` (a tensor, an array or a ``Sharded``) cut into equal row blocks
    over ``axis``, block i on shard i's device.  Raises unless the axis
    size divides the rows, as JAX's ``jit`` refuses such a sharding."""
    devs = mesh.axis_devices(axis)
    if isinstance(x, Sharded):
        if len(x.shards) != len(devs) or any(
                s.device != d for s, d in zip(x.shards, devs)):
            raise ValueError(f"a Sharded of {len(x.shards)} shards does not "
                             f"lie on the mesh's {axis!r} axis")
        return x
    t = torch.as_tensor(x)
    n, k = t.shape[0], len(devs)
    if n % k:
        raise ValueError(f"a leading axis of {n} does not divide into "
                         f"{k} {axis!r} shards")
    c = n // k
    return Sharded(tuple(t[i * c:(i + 1) * c].contiguous().to(d)
                         for i, d in enumerate(devs)))


def all_gather(x: Sharded, mesh: Mesh, to: Sequence | None = None) -> Replicated:
    """Every shard's rows, concatenated in shard order, on every device of
    ``to`` (default: every mesh device; device-to-device copies)."""
    collectives["all_gather"] += 1
    to = mesh.devices if to is None else [_norm(d) for d in to]
    return _from_distinct(to, {d: x.gather(d) for d in dict.fromkeys(to)})


def psum(partials: Sequence[torch.Tensor], mesh: Mesh,
         to: Sequence | None = None) -> Replicated:
    """The sum of equal-shape ``partials`` (one per shard, each on its
    shard's device) on every device of ``to`` (default: every mesh
    device).

    Partials that share a device are added there in the order given; the
    per-device sums of distinct CUDA devices are then reduced with NCCL and
    the total broadcast to the distinct devices of ``to`` (one process,
    several cards).  Nothing falls back: without NCCL for the sums it
    raises."""
    collectives["psum"] += 1
    local: dict = {}
    for p in partials:
        acc = local.get(p.device)
        local[p.device] = p if acc is None else acc + p
    sums = [s.contiguous() for s in local.values()]
    total = sums[0]
    if len(sums) > 1:
        if not torch.cuda.nccl.is_available(sums):
            raise RuntimeError(f"psum: NCCL cannot reduce tensors on {list(local)}")
        total = torch.cuda.comm.reduce_add(sums, destination=total.device.index)
        collectives["psum_nccl"] += 1
    to = mesh.devices if to is None else [_norm(d) for d in to]
    targets = list(dict.fromkeys(to))
    if targets == [total.device]:
        return _from_distinct(to, {total.device: total})
    copies = torch.cuda.comm.broadcast(total, [d.index for d in targets])
    return _from_distinct(to, {c.device: c for c in copies})

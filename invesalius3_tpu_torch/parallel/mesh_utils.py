"""Shard meshes and placements (port of invesalius3_tpu/parallel/mesh_utils.py).

The JAX package runs a sharded op as one SPMD program over a
``jax.sharding.Mesh``.  The port runs one Python program over a list of
shards instead: a ``ShardMesh`` names the devices, a ``Placement`` says
how an array is laid over them (split along its first axis over one mesh
axis, or one copy per device), and a ``Sharded`` holds the pieces, shard
s on ``mesh.devices[s]``.  On the card a mesh takes ``cuda:0`` ...
``cuda:k-1`` and cycles through them when asked for more shards than
cards, so one card runs N shards through the same code; on the CPU
(``device="cpu"``) it holds N ``cpu`` entries.

A mesh from ``distributed.global_mesh()`` spans the processes of a
``torch.distributed`` group: it also names each shard's rank, each
process holds only its own shards (the others' entries of
``Sharded.shards`` are None) and what crosses between processes goes
through ``collectives``.

    mesh = make_mesh(8)                      # 8 shards over the cards
    vol = shard_volume(ct, mesh)             # Z slabs, Z padded to 8k
    whole = vol.gather()                     # back on shard 0's device
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def local_devices(device=DEFAULT_DEVICE) -> List[torch.device]:
    """The devices one process can place shards on: every card for
    "cuda", the one card named by "cuda:k", or the CPU for "cpu"."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is not None:
            return [dev]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return [dev]


class ShardMesh:
    """An array of devices with named axes (the counterpart of a
    ``jax.sharding.Mesh``).  Two meshes are equal only if they are the same
    object, as two placements on them are.

    ``ranks`` (same shape) names the process that holds each entry and
    ``rank`` is this process; ``group`` is the ``torch.distributed`` group
    over those processes (None in one process) and ``host_group`` a gloo
    group over the same processes for host scalars and arrays (the group
    itself when it is gloo)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...],
                 ranks: Optional[np.ndarray] = None, rank: int = 0,
                 group=None, host_group=None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = (np.zeros(devices.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(devices.shape))
        self.rank = int(rank)
        if group is not None and (np.diff(self.ranks.ravel()) < 0).any():
            raise ValueError("a mesh across processes lists its entries host-major "
                             f"(ranks {self.ranks.ravel().tolist()})")
        self.group = group
        self.host_group = host_group if host_group is not None else group
        self.pinned: dict = {}  # host staging buffers, reused across calls

    @property
    def multiprocess(self) -> bool:
        return self.group is not None

    @property
    def shape(self) -> dict:
        """{axis name: size}."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, the other axes at index 0."""
        a = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(a.reshape(a.shape[0], -1)[:, 0])

    def axis_ranks(self, axis: str) -> List[int]:
        """The ranks holding the entries along ``axis``, the other axes at
        index 0."""
        a = np.moveaxis(self.ranks, self.axis_names.index(axis), 0)
        return [int(r) for r in a.reshape(a.shape[0], -1)[:, 0]]

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices.ravel()]
        if not self.multiprocess:
            return f"ShardMesh({self.shape}, {devs})"
        where = [f"{d}@rank{r}" for d, r in zip(devs, self.ranks.ravel())]
        return f"ShardMesh({self.shape}, {where}, rank {self.rank})"


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("z",),
              shape: Optional[Sequence[int]] = None,
              device=DEFAULT_DEVICE) -> ShardMesh:
    """A mesh of ``n_devices`` shards (default: one per local device) on
    ``device``'s kind, the card unless the caller passes "cpu".  More
    shards than cards cycle through the cards."""
    devs = local_devices(device)
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be at least 1, got {n}")
    devices = [devs[i % len(devs)] for i in range(n)]
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (n,)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return ShardMesh(arr.reshape(tuple(shape)), axis_names)


@dataclasses.dataclass
class Sharded:
    """An array in pieces: ``shards[s]`` lies on the placement's s-th
    device and starts at ``starts[s]`` along the first axis (every start
    is 0 for a replicated array).  A shard that another process holds is
    None; ``extent`` is then the whole first axis (None: the shards'
    sum)."""

    shards: List[Optional[torch.Tensor]]
    starts: List[int]
    sharding: "Placement"
    extent: Optional[int] = None

    @property
    def local(self) -> List[int]:
        """The indices of the shards this process holds."""
        return [s for s, a in enumerate(self.shards) if a is not None]

    @property
    def shape(self) -> Tuple[int, ...]:
        first = self.shards[self.local[0]]
        if not self.sharding.spec:
            return tuple(first.shape)
        z = (self.extent if self.extent is not None
             else sum(int(s.shape[0]) for s in self.shards))
        return (z,) + tuple(first.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[self.local[0]].dtype

    def lengths(self) -> List[int]:
        """Every shard's length along the split axis, held or not."""
        ends = list(self.starts[1:]) + [self.shape[0]]
        return [e - a for a, e in zip(self.starts, ends)]

    def like(self, shards: List[Optional[torch.Tensor]]) -> "Sharded":
        """New pieces laid as these."""
        return Sharded(list(shards), list(self.starts), self.sharding, self.extent)

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (the first held shard's by
        default).  Across processes every process gets it, through an
        all-gather over the group (JAX's ``process_allgather``)."""
        first = self.shards[self.local[0]]
        device = first.device if device is None else torch.device(device)
        if not self.sharding.spec:
            return first.to(device)
        mesh = self.sharding.mesh
        if not mesh.multiprocess:
            return torch.cat([s.to(device) for s in self.shards])
        from invesalius3_tpu_torch.parallel import collectives

        mine = torch.cat([self.shards[s] for s in self.local])
        return torch.cat([b.to(device) for b in collectives.allgather_rows(mesh, mine)])

    def map(self, fn) -> "Sharded":
        """``fn`` applied shard by shard (an elementwise op needs no halo)."""
        return self.like([None if s is None else fn(s) for s in self.shards])


@dataclasses.dataclass(frozen=True)
class Placement:
    """How an array lies on a mesh (the counterpart of a ``NamedSharding``):
    ``spec`` () is one copy per device; (axis, None, ...) splits the first
    array axis evenly over the mesh axis ``axis``."""

    mesh: ShardMesh
    spec: Tuple[Optional[str], ...]

    @property
    def devices(self) -> List[torch.device]:
        if not self.spec:
            return list(self.mesh.devices.ravel())
        return self.mesh.axis_devices(self.spec[0])

    @property
    def ranks(self) -> List[int]:
        """The rank holding each of ``devices``."""
        if not self.spec:
            return [int(r) for r in self.mesh.ranks.ravel()]
        return self.mesh.axis_ranks(self.spec[0])

    def put(self, x) -> Sharded:
        """Copy ``x`` (a host array or a tensor) onto the placement's
        devices, each process only the shards it holds; a split needs the
        first axis to divide evenly."""
        if self.spec and (self.spec[0] is None
                          or any(a is not None for a in self.spec[1:])):
            raise ValueError(f"only the first axis can be split, got {self.spec}")
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(x)))
        devs, me = self.devices, self.mesh.rank
        held = [r == me for r in self.ranks]
        if not self.spec:
            return Sharded([t.to(d, copy=True) if h else None for d, h in zip(devs, held)],
                           [0] * len(devs), self)
        n, z = len(devs), int(t.shape[0])
        if z % n:
            raise ValueError(f"axis of {z} does not split evenly over {n} shards "
                             "(shard_volume pads it)")
        k = z // n
        return Sharded([t.narrow(0, i * k, k).to(d, copy=True) if h else None
                        for i, (d, h) in enumerate(zip(devs, held))],
                       [i * k for i in range(n)], self, z)


def z_sharding(mesh: ShardMesh) -> Placement:
    """Split a (Z, Y, X) volume along Z over the mesh's "z" axis."""
    return Placement(mesh, ("z", None, None))


def replicated(mesh: ShardMesh) -> Placement:
    return Placement(mesh, ())


def shard_volume(volume, mesh: ShardMesh) -> Sharded:
    """Place a volume Z-sharded on the mesh, padding Z with zeros to a
    multiple of the mesh's "z" size (callers track the original extent)."""
    n = mesh.shape["z"]
    t = volume if isinstance(volume, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(volume)))
    z = int(t.shape[0])
    if z % n:
        pad = torch.zeros((n - z % n,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        t = torch.cat([t, pad])
    return z_sharding(mesh).put(t)

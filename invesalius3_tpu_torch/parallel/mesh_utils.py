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
    object, as two placements on them are."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

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

    def __repr__(self) -> str:
        return f"ShardMesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


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
    is 0 for a replicated array)."""

    shards: List[torch.Tensor]
    starts: List[int]
    sharding: "Placement"

    @property
    def shape(self) -> Tuple[int, ...]:
        first = self.shards[0]
        if not self.sharding.spec:
            return tuple(first.shape)
        return (sum(int(s.shape[0]) for s in self.shards),) + tuple(first.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (shard 0's by default)."""
        device = self.shards[0].device if device is None else torch.device(device)
        if not self.sharding.spec:
            return self.shards[0].to(device)
        return torch.cat([s.to(device) for s in self.shards])

    def map(self, fn) -> "Sharded":
        """``fn`` applied shard by shard (an elementwise op needs no halo)."""
        return Sharded([fn(s) for s in self.shards], list(self.starts), self.sharding)


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

    def put(self, x) -> Sharded:
        """Copy ``x`` (a host array or a tensor) onto the placement's
        devices; a split needs the first axis to divide evenly."""
        if self.spec and (self.spec[0] is None
                          or any(a is not None for a in self.spec[1:])):
            raise ValueError(f"only the first axis can be split, got {self.spec}")
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(x)))
        devs = self.devices
        if not self.spec:
            return Sharded([t.to(d, copy=True) for d in devs], [0] * len(devs), self)
        n, z = len(devs), int(t.shape[0])
        if z % n:
            raise ValueError(f"axis of {z} does not split evenly over {n} shards "
                             "(shard_volume pads it)")
        k = z // n
        return Sharded([t.narrow(0, i * k, k).to(d, copy=True) for i, d in enumerate(devs)],
                       [i * k for i in range(n)], self)


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

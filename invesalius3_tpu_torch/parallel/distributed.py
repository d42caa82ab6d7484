"""Process-group bootstrap and global meshes (port of
invesalius3_tpu/parallel/distributed.py).

Where the JAX module joins a ``jax.distributed`` cluster, this joins a
``torch.distributed`` process group, from torch's launcher variables
(``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun``
sets them) or from explicit arguments.  Single-process (the CLI's case)
every function behaves as the JAX module's: ``initialize()`` returns
False, ``process_info()`` is (0, 1) and ``global_mesh`` covers the local
devices.

    from invesalius3_tpu_torch.parallel import distributed
    distributed.initialize()                  # env-driven; False alone
    mesh = distributed.global_mesh(("z",))    # every process's card
    mesh = distributed.global_mesh(shape=(8,))  # 8 shards over the ranks

In a group of R processes each one places its shards on its own card,
``cuda:{LOCAL_RANK % device_count}`` (or the CPU when the caller passes
``device="cpu"``), and ``global_mesh`` lists every process's devices
host-major as the JAX function does: with S shards, shard s lives on rank
s // (S / R).  Every rank then calls the same sharded op or
``pipeline.run(..., shards=mesh)`` with the same host arrays, as every JAX
process does; what crosses between ranks goes through ``collectives``.

    torchrun --nproc-per-node 4 script.py     # script: initialize(device="cpu"), ...
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.parallel import collectives
from invesalius3_tpu_torch.parallel.mesh_utils import ShardMesh, local_devices

TIMEOUT_S = 300.0  # a collective that waits longer ends its process
_HOST_GROUP = {}  # the gloo group beside an NCCL one, made once


def is_multiprocess_env() -> bool:
    """True when the environment names a multi-process group."""
    if os.environ.get("WORLD_SIZE", ""):
        try:
            return int(os.environ["WORLD_SIZE"]) > 1
        except ValueError:
            return False
    return bool(os.environ.get("MASTER_ADDR"))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=DEFAULT_DEVICE, backend: Optional[str] = None,
               timeout: float = TIMEOUT_S) -> bool:
    """Join the process group (idempotent).  ``coordinator_address`` is
    "host:port".  On the card each rank takes ``cuda:{LOCAL_RANK %
    device_count}``.  ``backend`` None is NCCL on the card when the host's
    ranks (``LOCAL_WORLD_SIZE``) have a card each, gloo when they share
    one (NCCL refuses two ranks on one card) and gloo on the CPU.  A
    collective that waits ``timeout`` seconds raises, so a rank that dies
    ends the others.  Returns True if a multi-process group is joined,
    False when running single-process."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if not (coordinator_address or (num_processes or 0) > 1):
        return False  # single-process
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process group needs the coordinator address, "
                         "the number of processes and this process's id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local_rank % n_cards)
        if backend is None:
            per_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
            backend = "nccl" if per_host <= n_cards else "gloo"
    backend = backend or "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL carries card tensors: pass a CUDA device")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=float(timeout)))
    return True


def process_info() -> Tuple[int, int]:
    """(process id, number of processes) of the current group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _host_group():
    """A gloo group over every rank for host scalars and arrays: the
    world group when it is gloo, else one made once (every rank calls
    this in the same order, as ``global_mesh`` does)."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if "g" not in _HOST_GROUP:
        _HOST_GROUP["g"] = dist.new_group(backend="gloo")
    return _HOST_GROUP["g"]


def global_mesh(axis_names: Tuple[str, ...] = ("z",),
                shape: Optional[Sequence[int]] = None,
                device=DEFAULT_DEVICE) -> ShardMesh:
    """Mesh over every process's devices, host-major so the trailing axis
    stays within a host (the JAX function's rule for the axis sizes).
    Single-process that is every local device; in a group of R processes
    each process brings its own device (its card, or the CPU) and a
    ``shape`` of S entries (S a multiple of R) puts S / R shards on each,
    shard s on rank s // (S / R).  Every rank calls it (it is a
    collective)."""
    rank, n_proc = process_info()
    if n_proc == 1:
        devices = local_devices(device)
    else:
        dev = resolve_device(device)
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if dev.type == "cuda" else torch.device("cpu")]
    n = len(devices) * n_proc
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            per_host = max(1, n // n_proc)
            shape = (n // per_host,) + (1,) * (len(axis_names) - 2) + (per_host,)
    size = int(np.prod(shape))
    if size % n_proc:
        raise ValueError(f"a mesh of {size} entries does not split over {n_proc} processes")
    per_rank = size // n_proc
    mine = [devices[i % len(devices)] for i in range(per_rank)]
    arr = np.empty(size, dtype=object)
    ranks = np.repeat(np.arange(n_proc), per_rank)
    if n_proc == 1:
        arr[:] = mine
        return ShardMesh(arr.reshape(tuple(shape)), axis_names)
    host = _host_group()
    if dist.get_backend() == "nccl":  # all ranks join the communicator at once
        dist.barrier(device_ids=[torch.cuda.current_device()])
    probe = ShardMesh(np.array([None] * n_proc, dtype=object), ("p",),
                      ranks=np.arange(n_proc), rank=rank,
                      group=dist.group.WORLD, host_group=host)
    idx = np.asarray([-1 if d.type == "cpu" else d.index for d in mine], np.int64)
    every = collectives.allgather_host(probe, idx)
    for r, ids in enumerate(every):
        arr[r * per_rank:(r + 1) * per_rank] = [
            torch.device("cpu") if i < 0 else torch.device("cuda", int(i)) for i in ids]
    return ShardMesh(arr.reshape(tuple(shape)), axis_names, ranks=ranks, rank=rank,
                     group=dist.group.WORLD, host_group=host)


def local_data_slice(global_batch: int) -> slice:
    """The [start, stop) rows of a batch split over the processes that
    this process feeds."""
    pid, n = process_info()
    if global_batch % n:
        raise ValueError(f"global_batch {global_batch} must divide evenly "
                         f"over {n} processes (rows would be dropped)")
    per = global_batch // n
    return slice(pid * per, (pid + 1) * per)

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
    mesh = distributed.global_mesh(("z",))    # every local card

The sharded ops run one program over a shard list in one process.  A
shard list whose neighbours live in other processes (halo copies by
``torch.distributed`` send and receive) is not built yet, so
``global_mesh`` raises in a multi-process run rather than return the local
devices as if they were all of them (ROADMAP, Queue 1).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.parallel.mesh_utils import ShardMesh, local_devices


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
               device=DEFAULT_DEVICE) -> bool:
    """Join the process group (idempotent): NCCL on the card, gloo when
    the caller passes ``device="cpu"``.  ``coordinator_address`` is
    "host:port".  Returns True if a multi-process group is joined, False
    when running single-process."""
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
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    return True


def process_info() -> Tuple[int, int]:
    """(process id, number of processes) of the current group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(axis_names: Tuple[str, ...] = ("z",),
                shape: Optional[Sequence[int]] = None,
                device=DEFAULT_DEVICE) -> ShardMesh:
    """Mesh over every process's devices, host-major so the trailing axis
    stays within a host.  Single-process that is every local device."""
    _, n_proc = process_info()
    if n_proc > 1:
        raise NotImplementedError(
            "a shard list across processes (halo copies over torch.distributed "
            "send/recv) is not built: ROADMAP Queue 1, item 1")
    devices = local_devices(device)
    n = len(devices)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            per_host = max(1, n // n_proc)
            shape = (n // per_host,) + (1,) * (len(axis_names) - 2) + (per_host,)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return ShardMesh(arr.reshape(tuple(shape)), axis_names)


def local_data_slice(global_batch: int) -> slice:
    """The [start, stop) rows of a batch split over the processes that
    this process feeds."""
    pid, n = process_info()
    if global_batch % n:
        raise ValueError(f"global_batch {global_batch} must divide evenly "
                         f"over {n} processes (rows would be dropped)")
    per = global_batch // n
    return slice(pid * per, (pid + 1) * per)

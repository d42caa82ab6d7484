"""What crosses between the processes of a shard list (the port's
counterpart of the ``lax`` collectives the JAX sharded ops call:
``ppermute``, ``psum``, ``pmin`` and ``all_gather``).

A ``ShardMesh`` from ``distributed.global_mesh()`` names each shard's
rank.  Every process calls the functions below in the same order with its
own shards; in one process they reduce to the local copies and host
lists the shard list always used.

- ``exchange_planes``: each shard's boundary planes to its neighbours'
  ghost planes (Jacobi order: every plane is read from the state before
  the call).  A neighbour in this process gets a ``copy_``; one in another
  process a message;
- ``post``: point-to-point messages, every send and receive of a call
  posted together through ``batch_isend_irecv`` so that no pair of ranks
  waits on the other;
- ``any_flag``, ``reduce_host``, ``allgather_host``: OR, MIN, MAX and SUM
  of host scalars and arrays and the all-gather of small host arrays,
  over the mesh's gloo ``host_group``;
- ``allgather_rows``: tensors of any length along the first axis from
  every process, to every process;
- ``all_reduce``: a tensor summed over a process group (the batch norms'
  statistics and the gradients of a data-parallel training step).

A tensor on the card goes over NCCL when the group is NCCL.  NCCL refuses
two ranks of one communicator on one card, so ranks that share a card
form a gloo group; gloo sends host tensors only, so card tensors are
staged through pinned host buffers, the planes' kept on the mesh and
reused from round to round.  The choice follows the group's backend
(``staged``).

Messages are tagged (kind, source shard, destination shard); both sides
post a pair's messages in tag order, which is also the order NCCL
matches them in.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# message kinds (the first factor of a tag)
PLANE, SLAB, COUNT, IDS, RANGE, HALF, RING, PART = range(8)

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def tag(mesh, kind: int, src: int, dst: int) -> int:
    """The tag of a message of ``kind`` from shard ``src`` to shard ``dst``."""
    n = mesh.size
    return (kind * n + src) * n + dst


def backend(mesh) -> str:
    """"local" in one process, else the group's backend."""
    return dist.get_backend(mesh.group) if mesh.multiprocess else "local"


def staged(mesh, device: torch.device) -> bool:
    """True when a tensor on ``device`` crosses through host buffers: a
    card tensor in a gloo group."""
    return backend(mesh) == "gloo" and torch.device(device).type == "cuda"


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's memory as flat uint8 (gloo carries no int16
    and no bool)."""
    return t.reshape(-1).view(torch.uint8)


def _group_of(mesh, t: torch.Tensor):
    """NCCL carries card tensors; host tensors ride the gloo host group."""
    if t.device.type == "cuda" and not staged(mesh, t.device):
        return mesh.group
    return mesh.host_group


def _host_buffer(mesh, key, like: torch.Tensor, reuse: bool) -> torch.Tensor:
    if not reuse:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    k = key + (tuple(like.shape), like.dtype)
    buf = mesh.pinned.get(k)
    if buf is None:
        buf = mesh.pinned[k] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return buf


def post(mesh, sends: Sequence[Tuple[int, int, torch.Tensor]],
         recvs: Sequence[Tuple[int, int, torch.Tensor]], reuse: bool = False) -> int:
    """Send each ``(rank, tag, tensor)`` of ``sends`` and receive each
    ``(rank, tag, out)`` of ``recvs`` (``out`` contiguous, of the sent
    shape and dtype), all posted together; returns once every message has
    arrived and been written.  ``reuse`` keeps the host staging buffers
    for the next call with the same tags and shapes.  Returns the bytes
    received."""
    # an empty message is skipped on both sides (both know its shape)
    sends = [(r, t, x.contiguous()) for r, t, x in sends if x.numel()]
    recvs = [(r, t, x) for r, t, x in recvs if x.numel()]
    if not sends and not recvs:
        return 0
    wire_in = list(recvs)
    landing = []
    dev = next((x.device for _, _, x in list(sends) + list(recvs)
                if x.device.type == "cuda"), None)
    if dev is not None and staged(mesh, dev):
        staged_sends = []
        for r, t, x in sends:
            if x.device.type == "cuda":
                h = _host_buffer(mesh, ("send", r, t), x, reuse)
                h.copy_(x, non_blocking=True)
                x = h
            staged_sends.append((r, t, x))
        sends = staged_sends
        staged_recvs = []
        for r, t, out in recvs:
            if out.device.type == "cuda":
                h = _host_buffer(mesh, ("recv", r, t), out, reuse)
                landing.append((out, h))
                out = h
            staged_recvs.append((r, t, out))
        wire_in = staged_recvs
        # the copies above, and the last call's copies out of reused
        # buffers, are done before gloo touches the host memory
        torch.cuda.synchronize(dev)
    ops = sorted([(r, t, 0, x) for r, t, x in sends] + [(r, t, 1, x) for r, t, x in wire_in],
                 key=lambda o: (o[0], o[1], o[2]))
    by_group = {}
    for r, t, is_recv, x in ops:
        g = _group_of(mesh, x)
        by_group.setdefault(id(g), (g, []))[1].append(
            dist.P2POp(dist.irecv if is_recv else dist.isend, _bytes(x), r, group=g, tag=t))
    works = [w for _, p2p in by_group.values() for w in dist.batch_isend_irecv(p2p)]
    for w in works:  # every group's messages posted before any wait
        w.wait()
    for out, h in landing:
        out.copy_(h, non_blocking=True)
    return sum(x.numel() * x.element_size() for _, _, x in recvs)


def exchange_planes(mesh, ranks: List[int], lo: List[Optional[torch.Tensor]],
                    hi: List[Optional[torch.Tensor]], recv_lo: List[Optional[torch.Tensor]],
                    recv_hi: List[Optional[torch.Tensor]], edge_fill) -> Tuple[int, int]:
    """Jacobi-order plane exchange along a shard list whose shard s lives
    on ``ranks[s]``: for every held shard s, ``recv_lo[s]`` gets shard
    s - 1's ``hi`` plane and ``recv_hi[s]`` shard s + 1's ``lo`` plane
    (``edge_fill`` at the ends of the list).  Entries of shards held
    elsewhere are None.  Returns (bytes written into held shards' planes
    from neighbours, the share of those that crossed between processes)."""
    S = len(lo)
    me = mesh.rank
    sends, recvs = [], []
    halo = 0
    for s in range(S):
        if ranks[s] != me:
            continue
        for dst, nb, plane_out, plane_in in ((recv_lo[s], s - 1, hi, lo[s]),
                                             (recv_hi[s], s + 1, lo, hi[s])):
            if not 0 <= nb < S:
                dst.fill_(edge_fill)
                continue
            halo += dst.numel() * dst.element_size()
            if ranks[nb] == me:
                dst.copy_(plane_out[nb], non_blocking=True)
            else:
                sends.append((ranks[nb], tag(mesh, PLANE, s, nb), plane_in))
                recvs.append((ranks[nb], tag(mesh, PLANE, nb, s), dst))
    return halo, post(mesh, sends, recvs, reuse=True)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed elementwise over the processes of ``group``, as a new
    tensor on ``t``'s device.  A card tensor in a gloo group crosses
    through a pinned host buffer."""
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
    else:
        out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out.to(t.device)


def reduce_host(mesh, values, op: str) -> np.ndarray:
    """Elementwise ``op`` ("sum", "min" or "max") of a host array over the
    processes; the array itself in one process."""
    a = np.asarray(values)
    if not mesh.multiprocess:
        return a.copy()
    t = torch.from_numpy(np.ascontiguousarray(a, np.float64 if a.dtype.kind == "f"
                                              else np.int64))
    dist.all_reduce(t, op=_OPS[op], group=mesh.host_group)
    return t.numpy().astype(a.dtype)


def any_flag(mesh, flags: Iterable[torch.Tensor]) -> bool:
    """OR of the held shards' 0-d device flags, read to the host once, then
    over the processes: every rank reads the same answer."""
    flags = list(flags)
    mine = bool(torch.stack([f.to(flags[0].device) for f in flags]).any()) if flags else False
    return bool(reduce_host(mesh, np.int64(mine), "max"))


def allgather_host(mesh, rows) -> List[np.ndarray]:
    """Every process's host array (any length along the first axis, the
    same trailing shape and dtype), in rank order."""
    a = np.ascontiguousarray(rows)
    if not mesh.multiprocess:
        return [a]
    return [b.numpy() for b in allgather_rows(mesh, torch.from_numpy(a))]


def allgather_rows(mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's tensor (any length along the first axis, the same
    trailing shape and dtype), in rank order, on ``t``'s device."""
    g = _group_of(mesh, t)
    n = dist.get_world_size(mesh.group)
    lengths = torch.tensor([int(t.shape[0])], dtype=torch.int64)
    all_len = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(all_len, lengths, group=mesh.host_group)
    sizes = [int(x) for x in all_len]
    src = (t.cpu() if staged(mesh, t.device) else t).contiguous()
    src = src.reshape(src.shape[0], -1).view(torch.uint8)  # rows of bytes
    pad = max(sizes)
    if pad > src.shape[0]:
        src = torch.cat([src, src.new_zeros((pad - src.shape[0], src.shape[1]))])
    bufs = [src.new_empty(src.shape) for _ in range(n)]
    dist.all_gather(bufs, src, group=g)
    return [b[:k].view(t.dtype).reshape((k,) + tuple(t.shape[1:])).to(t.device)
            for b, k in zip(bufs, sizes)]

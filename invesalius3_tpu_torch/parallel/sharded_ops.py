"""Z-sharded volume operations over a shard list (port of
invesalius3_tpu/parallel/sharded_ops.py).

The JAX package runs each op as one ``shard_map`` program: halos move by
``ppermute``, flags and counts by ``psum`` and ``all_gather``.  Here one
Python program walks a list of Z-slabs, shard s on ``mesh.devices[s]``;
on a mesh from ``distributed.global_mesh()`` every process walks the
shards it holds and what crosses between processes goes through
``collectives`` (the same data the JAX program moves):

- a halo is one boundary plane copied between neighbouring shards
  (``copy_`` in one process, a message between two); the volume's ends get
  the fill each call site names;
- halos move in Jacobi order: every shard's ghost planes for a round are
  written from the state after the previous round before any shard runs
  its round, so the rounds, and the labels on tie lines, are the SPMD
  program's;
- a global "changed" flag is an OR over the shards' device flags, read
  once a check and reduced over the processes, so every process runs the
  same rounds; per-shard counts come to every host as one list.

Elementwise ops need no halo; neighbourhood ops (dilation, the floodfill
fixpoint, the watershed's relaxation rounds, marching-cell detection,
the smoothing's chamfer) exchange one plane each way.  The watershed runs
the CUDA sweep kernel (``ops.kernels.watershed_sweep``) on each shard's
ghost-padded slab.  Torch shards may differ in length, so the surface
extraction takes exactly sized slabs: no static buckets, no overflow
retry, and (as everywhere in the port) no padding orphan vertex.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.ops import kernels
from invesalius3_tpu_torch.ops import marching as mc
from invesalius3_tpu_torch.ops import mesh as mo
from invesalius3_tpu_torch.ops import watershed as ws
from invesalius3_tpu_torch.ops.kernels import DIST_BITS, DIST_MAX, INF_RANK
from invesalius3_tpu_torch.ops.morphology import (_offsets, binary_dilation,
                                                  grey_dilation, grey_erosion)
from invesalius3_tpu_torch.ops.threshold import threshold_new_mask
from invesalius3_tpu_torch.parallel import collectives as cl
from invesalius3_tpu_torch.parallel.mesh_utils import Sharded, ShardMesh, z_sharding


def _z_shards(mesh: ShardMesh, x) -> Sharded:
    """``x`` Z-sharded on ``mesh``: a ``Sharded`` of that mesh as it is, a
    host array or a tensor split evenly."""
    if isinstance(x, Sharded):
        if x.sharding.mesh is not mesh or x.sharding.spec[:1] != ("z",):
            raise ValueError("expected an array Z-sharded on this mesh")
        return x
    return z_sharding(mesh).put(x)


def _sync(tensors) -> None:
    """Wait for every card the tensors live on."""
    for d in {t.device for t in tensors if t is not None and t.device.type == "cuda"}:
        torch.cuda.synchronize(d)


def _held(xs) -> list:
    return [a for a in xs if a is not None]


def _lmap(fn, first, *rest) -> list:
    """``fn`` over the shards held here (None elsewhere), element by
    element of the lists."""
    return [None if a is None else fn(a, *(r[s] for r in rest))
            for s, a in enumerate(first)]


def _any(mesh: ShardMesh, flags: List[Optional[torch.Tensor]]) -> bool:
    """OR of per-shard 0-d device flags, read to the host once and over
    the processes."""
    return cl.any_flag(mesh, _held(flags))


def halo_exchange_z(x: Sharded) -> List[Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """For each held shard: (the previous shard's last plane, the next
    shard's first plane), each (1, Y, X) on that shard's device; zeros at
    the volume's ends (None for shards held elsewhere)."""
    sh = x.shards
    prev = _lmap(lambda a: torch.empty_like(a[:1]), sh)
    nxt = _lmap(lambda a: torch.empty_like(a[:1]), sh)
    cl.exchange_planes(x.sharding.mesh, x.sharding.ranks, _lmap(lambda a: a[:1], sh),
                       _lmap(lambda a: a[-1:], sh), prev, nxt, 0)
    return _lmap(lambda p, n: (p, n), prev, nxt)


def _ghost_pad(shards: List[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
    """(n_s + 2, ...) buffers holding each shard in planes 1..n_s; the
    ghost planes 0 and n_s + 1 are written by ``_refresh``."""

    def pad(a):
        b = torch.empty((a.shape[0] + 2,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=a.device)
        b[1:-1].copy_(a)
        return b

    return _lmap(pad, shards)


def _refresh(mesh: ShardMesh, ranks: List[int], bufs: List[Optional[torch.Tensor]],
             edge_fill) -> Tuple[int, int]:
    """Write every held ghost plane from the neighbours' boundary planes
    (``edge_fill`` at the volume's ends); reads only real planes, so the
    order of the copies does not matter.  Returns (the bytes copied into
    held shards from neighbours, those of them that crossed between
    processes)."""
    return cl.exchange_planes(mesh, ranks, _lmap(lambda b: b[1], bufs),
                              _lmap(lambda b: b[-2], bufs), _lmap(lambda b: b[0], bufs),
                              _lmap(lambda b: b[-1], bufs), edge_fill)


# ---------------------------------------------------------------------------
# Elementwise and one-plane-halo ops
# ---------------------------------------------------------------------------


def sharded_threshold_mask(mesh: ShardMesh):
    """Z-sharded threshold: elementwise, shard by shard."""

    def f(image, tmin, tmax) -> Sharded:
        return _z_shards(mesh, image).map(lambda a: threshold_new_mask(a, tmin, tmax))

    return f


def _check_halo_depth(strct) -> None:
    if any(abs(o[0]) > 1 for o in _offsets(strct)):
        raise ValueError("a one-plane halo supports structuring elements at "
                         "most 3 deep in Z")


def _dilate_with_halo(x: Sharded, strct) -> List[Optional[torch.Tensor]]:
    return _lmap(lambda a, h: binary_dilation(torch.cat([h[0], a, h[1]]), strct)[1:-1],
                 x.shards, halo_exchange_z(x))


def sharded_binary_dilation(mesh: ShardMesh, strct: np.ndarray):
    """Binary dilation of a Z-sharded volume: each shard dilates its slab
    padded with its neighbours' boundary planes (structuring elements at
    most 3 deep in Z)."""
    _check_halo_depth(strct)

    def f(x) -> Sharded:
        x = _z_shards(mesh, x).map(lambda a: a.to(torch.bool))
        return x.like(_dilate_with_halo(x, strct))

    return f


def sharded_floodfill_threshold(mesh: ShardMesh, strct: np.ndarray,
                                steps_per_check: int = 8):
    """Z-sharded region grow from ``seeds`` through voxels in [t0, t1]:
    ``steps_per_check`` halo-exchanging dilation steps between global
    "changed" checks, to the least fixpoint the single-device
    ``ops/floodfill`` reaches."""
    _check_halo_depth(strct)

    def f(data, seeds, t0, t1) -> Sharded:
        data = _z_shards(mesh, data)
        seeds = _z_shards(mesh, seeds)
        allowed = _lmap(lambda d: (d >= t0) & (d <= t1), data.shards)
        reached = _lmap(lambda s, a: s.to(torch.bool) & a, seeds.shards, allowed)
        while True:
            new = reached
            for _ in range(steps_per_check):
                grown = _dilate_with_halo(data.like(new), strct)
                new = _lmap(lambda g, a, r: g.bitwise_and_(a).bitwise_or_(r),
                            grown, allowed, new)
            changed = _any(mesh, _lmap(lambda n, r: torch.ne(n, r).any(), new, reached))
            reached = new
            if not changed:
                return data.like(reached)

    return f


def sharded_active_cell_count(mesh: ShardMesh):
    """Marching-cell count of a Z-sharded boolean volume: each shard counts
    the cells that start in it, with the next shard's first plane as its
    halo.  Returns the total once per shard (host int64 array), as the JAX
    program's per-shard psum (a SUM over the processes)."""

    def f(vis) -> np.ndarray:
        x = _z_shards(mesh, vis).map(lambda a: a.to(torch.bool))
        counts = _lmap(lambda a, h: mc.active_of(mc.cell_corners(torch.cat([a, h[1]]))).sum(),
                       x.shards, halo_exchange_z(x))
        total = int(cl.reduce_host(mesh, [sum(int(c) for c in _held(counts))], "sum")[0])
        return np.full(len(counts), total, np.int64)

    return f


# ---------------------------------------------------------------------------
# Z-sharded watershed
# ---------------------------------------------------------------------------


def sharded_watershed(mesh: ShardMesh, connectivity: int = 6,
                      levels: Optional[int] = None, quiet_rounds: int = 1,
                      stop: str = "rank"):
    """Z-sharded marker watershed: the multigrid IFT solver over the shard
    list, one relaxation round at a time.

    A round writes every shard's ghost planes of rank, label and f from its
    neighbours (Jacobi order), runs the six directional sweeps (and the
    diagonal relax for 18/26-connectivity) on each ghost-padded slab, then
    restores the frozen voxels; a global OR of the shards' flags decides
    the quiet window.  ``stop="rank"`` waits for rank and labels to settle
    (the Bellman fixpoint, bitwise tie distances); ``stop="label"`` for the
    labels only (single-device stopping, far fewer fine rounds; tie-plateau
    voxels may differ).  The multigrid pools and upsamples shard by shard,
    so the local Z must divide by 2^levels: ``levels`` None takes 3 from
    192 voxels a side (else 0) and lowers it until it does; a level stops
    coarsening at 4 local planes.

    ``run(image, markers, algorithm, mg_size, debug_rank, debug_rounds,
    sweep, stats)``: "Watershed" floods the morphological gradient, any
    other algorithm the image.  ``sweep`` replaces the axis sweep
    (``ops.kernels.watershed_sweep_ref`` runs the plain version on a card);
    ``stats``, a dict, receives "rounds", "halo_bytes" (every shard's, so
    one process and many count alike) and "wire_bytes" (those that crossed
    between processes) per level (coarse to fine), "levels" and "launches"
    (sweep kernel launches per shard and axis, from every process).
    Returns int16 labels as a ``Sharded``; with ``debug_rounds`` also the
    rounds per level, with ``debug_rank`` the final ranks.
    """
    if stop not in ("rank", "label"):
        raise ValueError(f"stop must be 'rank' or 'label', got {stop!r}")
    n_shards = mesh.shape["z"]

    def run(image, markers, algorithm: str = "Watershed", mg_size=(3, 3, 3),
            debug_rank: bool = False, debug_rounds: bool = False,
            sweep: Optional[ws.Sweep] = None, stats: Optional[dict] = None):
        sweep = sweep or kernels.watershed_sweep
        img = _z_shards(mesh, image)
        mk = _z_shards(mesh, markers)
        ranks = img.sharding.ranks
        held = img.local
        n_levels = levels
        if n_levels is None:
            n_levels = 3 if min(img.shape) >= 192 else 0
        local_z = img.shape[0] // n_shards
        while n_levels > 0 and (local_z % (2 ** n_levels)
                                or (local_z // 2 ** n_levels) < 1):
            n_levels -= 1
        rounds: List[int] = []
        moved: List[int] = []
        wired: List[int] = []
        launches = np.zeros((n_shards, 3), np.int64)

        def refresh(bufs, fill) -> Tuple[int, int]:
            return _refresh(mesh, ranks, bufs, fill)

        # the image shifted by its global minimum in the input dtype (int16
        # may wrap, as the JAX program's does), then the gradient on
        # halo-padded slabs: the volume's ends are the identity of max
        # (lo) and of min (hi), as reduce_window's SAME edges
        gmin = int(cl.reduce_host(mesh, [min(img.shards[s].min().item() for s in held)],
                                  "min")[0])
        f = _lmap(lambda a: (a - torch.tensor(gmin, dtype=a.dtype, device=a.device)
                             ).to(torch.int32), img.shards)
        if algorithm == "Watershed":
            k = tuple(2 * (int(m) // 2) + 1 for m in mg_size)
            lo, hi = _ghost_pad(f), _ghost_pad(f)
            refresh(lo, -(2**31))
            refresh(hi, 2**31 - 1)
            f = _lmap(lambda a, b: (grey_dilation(a, k) - grey_erosion(b, k))[1:-1], lo, hi)
            del lo, hi
        f = _lmap(lambda a: torch.clamp(a, 0, 2**16 - 2).contiguous(), f)
        lab_dtype = torch.int16 if mk.dtype in ws._NARROW_LABELS else torch.int32
        lab = _lmap(lambda m: m.to(lab_dtype).contiguous(), mk.shards)

        def refine(f_l, lab0_l, rank_init_l, lab_init_l):
            frozen = _lmap(lambda l0: l0 != 0, lab0_l)
            R = _ghost_pad(_lmap(lambda fr, ri: torch.where(fr, 0, ri), frozen, rank_init_l))
            L = _ghost_pad(_lmap(lambda fr, l0, li: torch.where(fr, l0, li),
                                 frozen, lab0_l, lab_init_l))
            # f never changes: its ghosts are written once.  The volume's
            # ends take 2^16 - 1, one above any real cost (f clips to
            # 2^16 - 2), so no path runs through space outside the volume;
            # a fill of 0 would be a zero-cost road through the ghosts.
            F = _ghost_pad(f_l)
            nbytes, nwire = refresh(F, 2**16 - 1)
            quiet = n = 0
            while quiet < quiet_rounds:
                # every ghost plane from the state after the last round,
                # before any held shard's sweeps write a real plane
                for bufs, fill in ((R, INF_RANK), (L, 0)):
                    hb, wb = refresh(bufs, fill)
                    nbytes, nwire = nbytes + hb, nwire + wb
                prev_l = _lmap(lambda b: b[1:-1].clone(), L)
                prev_r = _lmap(lambda b: b[1:-1].clone(), R) if stop == "rank" else None
                for s in held:
                    before = dict(kernels.LAUNCHES)
                    ws._one_round_padded(R[s], L[s], F[s], connectivity, sweep)
                    for axis in range(3):
                        launches[s, axis] += kernels.LAUNCHES[axis] - before[axis]
                    r, lb = R[s][1:-1], L[s][1:-1]
                    r.masked_fill_(frozen[s], 0)
                    lb.copy_(torch.where(frozen[s], lab0_l[s], lb))
                flags = _lmap(lambda b, p: torch.any(b[1:-1] != p), L, prev_l)
                if prev_r is not None:
                    flags = _lmap(lambda fl, b, p: fl | torch.any(b[1:-1] != p),
                                  flags, R, prev_r)
                quiet = 0 if _any(mesh, flags) else quiet + 1
                n += 1
            rounds.append(n)
            moved.append(nbytes)
            wired.append(nwire)
            return _lmap(lambda b: b[1:-1], R), _lmap(lambda b: b[1:-1], L)

        def solve(f_l, lab_l, level):
            if level == 0 or f_l[held[0]].shape[0] <= 4:  # local planes per shard
                return refine(f_l, lab_l,
                              _lmap(lambda a: torch.full_like(a, INF_RANK), f_l), lab_l)
            f_c = _lmap(lambda a: ws._pool2(a, -(2**31)), f_l)
            lab_c = _lmap(lambda a: ws._pool2(a, -(2**15)), lab_l)
            rank_c, lab_sol_c = solve(f_c, lab_c, level - 1)

            def rank_up(a, rc, fc):
                # max with the pooled f: the coarse seed cells' validity fix
                # (invesalius3_tpu/ops/watershed.py watershed_ift_multigrid)
                cost_up = ws._up2(torch.maximum(rc >> DIST_BITS, fc), a.shape)
                return torch.where(cost_up >= (INF_RANK >> DIST_BITS), INF_RANK,
                                   cost_up * (1 << DIST_BITS) + DIST_MAX)

            rank_init = _lmap(rank_up, f_l, rank_c, f_c)
            lab_init = _lmap(lambda a, lc: ws._up2(lc, a.shape), f_l, lab_sol_c)
            return refine(f_l, lab_l, rank_init, lab_init)

        rank_out, lab_out = solve(f, lab, n_levels)
        out = img.like(_lmap(lambda a: a.to(torch.int16), lab_out))
        if stats is not None:
            counts = cl.reduce_host(mesh, np.concatenate([moved, wired]), "sum")
            stats.update(rounds=list(rounds), halo_bytes=counts[:len(moved)].tolist(),
                         wire_bytes=counts[len(moved):].tolist(), levels=n_levels,
                         launches=cl.reduce_host(mesh, launches, "sum").tolist())
        if debug_rounds:
            return out, list(rounds)
        if debug_rank:
            return out, img.like(rank_out)
        return out

    return run


# ---------------------------------------------------------------------------
# Z-sharded marching-tetrahedra surface extraction and ca-smoothing
# ---------------------------------------------------------------------------


def shard_world_verts(verts3v: torch.Tensor) -> np.ndarray:
    """One shard's (3, n_own) world-frame vertices -> host (n_own, 3)
    float32.  Both the host assembly below and ``mesh_io.write_stl_sharded``
    call it, so the two export paths cannot drift apart."""
    return np.ascontiguousarray(verts3v.t().cpu().numpy(), np.float32)


def shard_wound_faces(faces3t: torch.Tensor) -> np.ndarray:
    """One shard's (3, n_tri) wound global face ids -> host (n_tri, 3)
    int32."""
    return np.ascontiguousarray(faces3t.t().cpu().numpy(), np.int32)


def gather_parts_to_rank0(mesh: ShardMesh, verts_sh: List[Optional[torch.Tensor]],
                          faces_sh: List[Optional[torch.Tensor]]):
    """Every shard's (3, n_own) world vertices and (3, n_tri) faces on rank
    0, as host tensors for the shards of other ranks: each rank sends its
    held parts' lengths, then the parts (the faces' int32 bits beside the
    vertices in one float32 message).  Returns (verts_sh, faces_sh) on rank
    0, None on every other rank once its parts are sent."""
    ranks, me = mesh.axis_ranks("z"), mesh.rank
    remote = [s for s in range(len(ranks)) if ranks[s] != 0]
    if me == 0:
        lens = {s: torch.zeros(2, dtype=torch.int64) for s in remote}
        cl.post(mesh, [], [(ranks[s], cl.tag(mesh, cl.PART, s, 0), lens[s]) for s in remote])
        bufs = {s: torch.empty((3, int(lens[s].sum())), dtype=torch.float32) for s in remote}
        cl.post(mesh, [], [(ranks[s], cl.tag(mesh, cl.PART, s, 0), bufs[s]) for s in remote])
        verts, faces = list(verts_sh), list(faces_sh)
        for s in remote:
            n_own = int(lens[s][0])
            verts[s] = bufs[s][:, :n_own]
            faces[s] = bufs[s][:, n_own:].contiguous().view(torch.int32)
        return verts, faces
    held = [s for s in remote if ranks[s] == me]
    cl.post(mesh, [(0, cl.tag(mesh, cl.PART, s, 0),
                    torch.tensor([verts_sh[s].shape[1], faces_sh[s].shape[1]])) for s in held], [])
    cl.post(mesh, [(0, cl.tag(mesh, cl.PART, s, 0),
                    torch.cat([verts_sh[s], faces_sh[s].view(torch.float32)], dim=1).cpu())
                   for s in held], [])
    return None


def _padded_slabs(vis: Sharded, ranges: List[Tuple[int, int]]) -> Tuple[list, int]:
    """For every held shard t, planes [p0, p1) = ``ranges[t]`` of the
    visible mask padded by one empty voxel on every side (plane p holds
    slice p - 1), as uint8 on its device: the repartition.  A slab's
    planes may come from up to three shards; those held by another process
    arrive as messages (every process knows every range, so no lengths
    cross).  Returns (the slabs, None for shards held elsewhere; the bytes
    received from other processes)."""
    Z, Y, X = vis.shape
    mesh, ranks, me = vis.sharding.mesh, vis.sharding.ranks, vis.sharding.mesh.rank
    devices = vis.sharding.devices
    lengths = vis.lengths()
    out: List[Optional[torch.Tensor]] = [None] * len(ranges)
    sends, recvs, landing = [], [], []
    for t, (p0, p1) in enumerate(ranges):
        if ranks[t] == me:
            out[t] = torch.zeros((p1 - p0, Y + 2, X + 2), dtype=torch.uint8, device=devices[t])
        for u, (st, n) in enumerate(zip(vis.starts, lengths)):
            lo, hi = max(p0, 1, st + 1), min(p1, Z + 1, st + 1 + n)
            if lo >= hi or me not in (ranks[t], ranks[u]):
                continue
            if ranks[t] == ranks[u]:
                out[t][lo - p0:hi - p0, 1:-1, 1:-1].copy_(
                    vis.shards[u][lo - 1 - st:hi - 1 - st], non_blocking=True)
            elif ranks[u] == me:
                sends.append((ranks[t], cl.tag(mesh, cl.SLAB, u, t),
                              vis.shards[u][lo - 1 - st:hi - 1 - st]))
            else:
                buf = torch.empty((hi - lo, Y, X), dtype=torch.uint8, device=devices[t])
                recvs.append((ranks[u], cl.tag(mesh, cl.SLAB, u, t), buf))
                landing.append((out[t][lo - p0:hi - p0, 1:-1, 1:-1], buf))
    wire = cl.post(mesh, sends, recvs)
    for dst, buf in landing:
        dst.copy_(buf)
    return out, wire


def _row_tris(c: torch.Tensor) -> torch.Tensor:
    """(n - 1,) int64 of a halo-padded slab of n planes: the triangles of
    each cell row (what the balanced cuts are chosen from)."""
    return mc.triangles_of(mc.cell_corners(c.to(torch.bool))).sum(dim=(1, 2),
                                                                  dtype=torch.int64)


def _balanced_cuts(tri_g: np.ndarray, Z: int, n_shards: int) -> List[int]:
    """Z cuts that give every shard about 1/n of the triangles, each slab
    at most twice the uniform one (the JAX package's host selection)."""
    Zs = Z // n_shards
    cap = min(Z, 2 * Zs)
    cum = np.cumsum(tri_g.astype(np.float64))
    cuts = [0]
    for s in range(1, n_shards):
        c = int(np.searchsorted(cum, cum[-1] * s / n_shards))
        c = min(max(c, cuts[-1] + 1), Z - (n_shards - s), cuts[-1] + cap)
        cuts.append(c)
    cuts.append(Z)
    for s in range(n_shards - 1, 0, -1):  # feasibility: every slab <= cap
        cuts[s] = max(cuts[s], cuts[s + 1] - cap)
    return cuts


class _Part:
    """One shard's piece of the surface: its local mesh (own vertices and
    the duplicates of the next shard's lower-plane vertices, in global key
    order), the classification and, after the stitch, global face ids."""

    def __init__(self, field: torch.Tensor, z0: int, l: int, last: bool,
                 spacing, plane_stride: int):
        dev = field.device
        self.z0, self.l, self.last = z0, l, last
        corner_lin = mc._active_cells(field, 0.5)
        if corner_lin.shape[1]:
            vals = field.reshape(-1)[corner_lin]
            case, tri_slots = mc._emit_slots(vals > 0.5)
            pts, keys = mc._materialize(corner_lin, vals.to(torch.float32), case,
                                        tri_slots, 0.5, tuple(field.shape))
            # local -> global: z += z0; a key is lattice_lin * 8 + code
            pts[:, 0, :] += z0
            keys = keys + 8 * z0 * plane_stride
        else:
            pts = torch.zeros((3, 3, 0), dtype=torch.float32, device=dev)
            keys = torch.zeros((3, 0), dtype=torch.int64, device=dev)
        self.T = T = pts.shape[2]
        pts_m = pts.transpose(0, 1).reshape(3, 3 * T)
        keys_m = keys.reshape(-1).to(torch.int32)
        self.inverse, self.order, self.gos, starts = mc._dedup_structure(keys_m)
        gkey = keys_m[self.order[starts]].long()
        plane = (gkey // 8) // plane_stride
        inplane = (gkey % 8) < 4  # both endpoints in the low endpoint's plane
        # ownership: an in-plane vertex on a cut belongs to the shard whose
        # slab starts there, so every own key of shard s sorts before every
        # own key of shard s + 1 and shard order is global key order
        self.dup = inplane & (plane == z0 + l) if not last else torch.zeros_like(inplane)
        self.lower = inplane & (plane == z0)
        self.own = ~self.dup
        self.own_rank = torch.cumsum(self.own, 0) - 1
        sx, sy, sz = spacing
        vz = pts_m[:, self.order[starts]]
        self.verts3v = torch.stack([mc._mul_add_f32(vz[2], sx, -sx),
                                    mc._mul_add_f32(vz[1], sy, -sy),
                                    mc._mul_add_f32(vz[0], sz, -sz)])
        self.faces_local = self.inverse.reshape(3, T).flip(0)

    @property
    def n_verts(self) -> int:
        return int(self.verts3v.shape[1])


def _ring_corners(part: _Part, ring: torch.Tensor):
    """For every corner on a ring vertex: (the vertex's rank among the ring
    vertices, the face's other two corners' vertices)."""
    T = part.T
    c = torch.nonzero(ring[part.inverse]).squeeze(1)
    tri, k = c % T, c // T
    rank = (torch.cumsum(ring, 0) - 1)[part.inverse[c]]
    o1 = part.inverse[((k + 1) % 3) * T + tri]
    o2 = part.inverse[((k + 2) % 3) * T + tri]
    return part.inverse[c], rank, o1, o2, int(ring.sum())


def _raw_diff(v: torch.Tensor, rc) -> Tuple[torch.Tensor, torch.Tensor]:
    """(3, n) sums over a ring's raw incidence of (v_i - v_j), both other
    corners of each incident face, and (n,) their counts."""
    vi, rank, o1, o2, n = rc
    d = (v[:, vi] - v[:, o1]) + (v[:, vi] - v[:, o2])
    out = torch.zeros((3, n), dtype=v.dtype, device=v.device).index_add_(1, rank, d)
    cnt = torch.bincount(rank, minlength=n).to(v.dtype) * 2
    return out, cnt


def _from_neighbour(mesh, ranks, kind: int, payload, out_shape, dtype, devices,
                    step: int = 1) -> Tuple[list, int]:
    """For every held shard s with a neighbour u = s - ``step`` (s - 1, or
    s + 1 for ``step`` -1): ``payload(u)`` on s's device, of shape
    ``out_shape(s)`` (a copy in one process, a message between two).
    Returns (the list, None elsewhere; bytes received from other
    processes)."""
    me, S = mesh.rank, len(ranks)
    got: List[Optional[torch.Tensor]] = [None] * S
    sends, recvs = [], []
    for s in range(S):
        u = s - step
        if not 0 <= u < S:
            continue
        if ranks[s] == me and ranks[u] == me:
            got[s] = payload(u).to(devices[s])
        elif ranks[u] == me:
            sends.append((ranks[s], cl.tag(mesh, kind, u, s), payload(u)))
        elif ranks[s] == me:
            got[s] = torch.empty(out_shape(s), dtype=dtype, device=devices[s])
            recvs.append((ranks[u], cl.tag(mesh, kind, u, s), got[s]))
    return got, cl.post(mesh, sends, recvs)


def _packed(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """A ring side's (3, n) sums and (n,) counts as one (4, n) message."""
    return torch.cat([sums, counts[None]])


def _smooth(mesh: ShardMesh, ranks: List[int], parts: List[Optional[_Part]], shape, spacing,
            smooth: dict) -> Tuple[List[Optional[torch.Tensor]], int]:
    """Context-aware smoothing of the stitched parts, the global operator
    of ``ops/mesh.ca_smoothing_device`` (grid propagation) with all mesh
    state on its shard: only the ring vertices (in-plane vertices on a cut)
    and ghost rows of the chamfer grid cross, between shards of one
    process by copies and between processes by messages.  Returns (each
    held part's smoothed (3, V_local) world vertices, None elsewhere; the
    bytes received from other processes)."""
    S = len(parts)
    me = mesh.rank
    held = [s for s in range(S) if ranks[s] == me]
    devices = [None if p is None else p.verts3v.device for p in parts]
    Z, Yp, Xp = shape[0], shape[1] + 2, shape[2] + 2
    t = float(smooth.get("t", 0.7))
    tmax = float(smooth.get("tmax", 3.0))
    bmin = float(smooth.get("bmin", 0.5))
    n_iters = int(smooth.get("n_iters", 10))
    sx, sy, sz = spacing
    lower_ids = _lmap(lambda p: torch.nonzero(p.lower).squeeze(1), parts)
    dup_ids = _lmap(lambda p: torch.nonzero(p.dup).squeeze(1), parts)
    n_ring = lambda s: int(lower_ids[s].numel())  # noqa: E731 (the stitch checked both sides)

    # 1. staircase flags.  The flag is a range test over all incident
    #    faces, so the duplicates' (vmax, vmin) go to the owner, which
    #    thresholds the combined range (an OR of per-side flags would miss
    #    a range split across the cut).
    ranges = _lmap(lambda p: mo.staircase_range(mo.face_normals_3t(p.verts3v, p.faces_local),
                                                p.faces_local, p.n_verts), parts)
    theirs, wire = _from_neighbour(
        mesh, ranks, cl.RANGE,
        lambda u: torch.stack([ranges[u][0][:, dup_ids[u]], ranges[u][1][:, dup_ids[u]]]),
        lambda s: (2, ranges[s][0].shape[0], n_ring(s)), torch.float32, devices)
    for s in held:
        if s == 0:
            continue
        for a, op in ((0, torch.maximum), (1, torch.minimum)):
            mine = ranges[s][a]
            mine[:, lower_ids[s]] = op(mine[:, lower_ids[s]], theirs[s][a])
    del theirs
    flags = _lmap(lambda r: mo.flags_of_range(r[0], r[1], t), ranges)

    # 2. weights: own staircase vertices rasterised into each shard's rows
    #    of the global grid (planes z0 - 1 .. z0 + l; the last shard up to
    #    Z + 1 and one empty ghost row), ghost rows folded into and refreshed
    #    from the neighbours before every chamfer step, so the grid is the
    #    single-device one; then each vertex samples it
    vox: List[Optional[tuple]] = [None] * S
    grids: List[Optional[torch.Tensor]] = [None] * S
    for s in held:
        p = parts[s]
        v = p.verts3v
        # the voxel of each vertex as the single-device smoother takes it
        # (world minus the origin shift, over the spacing)
        zi = torch.clamp(torch.round(mo.voxel_coord(v[2], -sz, sz)).long(), 0, Z + 1)
        yi = torch.clamp(torch.round(mo.voxel_coord(v[1], -sy, sy)).long(), 0, Yp - 1)
        xi = torch.clamp(torch.round(mo.voxel_coord(v[0], -sx, sx)).long(), 0, Xp - 1)
        rows = p.l + (4 if p.last else 2)
        row = torch.clamp(zi - (p.z0 - 1), 0, rows - 1)
        grid = torch.full((rows * Yp * Xp,), np.inf, dtype=torch.float32, device=v.device)
        seed = flags[s] & p.own
        grid[((row * Yp + yi) * Xp + xi)[seed]] = 0.0
        grids[s] = grid.reshape(rows, Yp, Xp)
        vox[s] = (row, yi, xi)
    # the fold: a shard's ghost rows (0 and -1) go into its neighbours'
    # real rows they stand for, by min (order-free)
    from_prev = _lmap(lambda g: torch.empty_like(g[0]), grids)
    from_next = _lmap(lambda g: torch.empty_like(g[0]), grids)
    wire += cl.exchange_planes(mesh, ranks, _lmap(lambda g: g[0], grids),
                               _lmap(lambda g: g[-1], grids), from_prev, from_next, np.inf)[1]
    for s in held:
        torch.minimum(grids[s][1], from_prev[s], out=grids[s][1])
        torch.minimum(grids[s][-2], from_next[s], out=grids[s][-2])
    del from_prev, from_next
    steps = min(16, int(np.ceil(tmax / min(spacing))))
    for _ in range(steps):
        wire += _refresh(mesh, ranks, grids, np.inf)[1]
        grids = _lmap(lambda g: mo._chamfer(g, (sz, sy, sx), 1), grids)
    wire += _refresh(mesh, ranks, grids, np.inf)[1]
    weights: List[Optional[torch.Tensor]] = [None] * S
    for s in held:
        row, yi, xi = vox[s]
        d = grids[s].reshape(-1)[(row * Yp + yi) * Xp + xi]
        dev = devices[s]
        weights[s] = mo.weights_of_dist(d, mo._f32(tmax, dev), mo._f32(bmin, dev))
    del grids

    # 3. weighted Taubin.  Interior vertices have closed fans on their
    #    shard and use its one-ring table; a ring vertex sums the raw
    #    incidence (both other corners of each incident face) from both
    #    sides, which counts each neighbour twice, so its mean divides by
    #    the summed counts (2 deg).  The owner moves it and sends the new
    #    position back to the duplicate after every pass.
    rings, lower_rc, dup_rc = [None] * S, [None] * S, [None] * S
    for s in held:
        p = parts[s]
        dm = mc.DeviceMesh(verts3v=p.verts3v, faces3t=p.faces_local, inverse=p.inverse,
                           order=p.order, group_of_sorted=p.gos, spacing=tuple(spacing),
                           vol_shape=tuple(shape))
        neigh, deg = mo.adjacency_from_device_mesh(dm)
        rings[s] = mo._ring(neigh, deg, p.n_verts)
        lower_rc[s] = _ring_corners(p, p.lower)
        dup_rc[s] = _ring_corners(p, p.dup)

    v = _lmap(lambda p: p.verts3v, parts)
    for _ in range(n_iters):
        for factor in (0.5, -0.53):
            new: List[Optional[torch.Tensor]] = [None] * S
            for s in held:
                fac = mo._f32(factor, devices[s])
                idx, valid, cnt = rings[s]
                new[s] = v[s] + fac * (weights[s][None]
                                       * mo._ring_mean_diff(v[s], idx, valid, cnt))
            # the duplicate side's raw sums and counts, (4, n), to the owner
            halves, w = _from_neighbour(
                mesh, ranks, cl.HALF, lambda u: _packed(*_raw_diff(v[u], dup_rc[u])),
                lambda s: (4, n_ring(s)), torch.float32, devices)
            wire += w
            sends, recvs = [], []
            for s in held:
                if s == 0:
                    continue
                fac = mo._f32(factor, devices[s])
                own_sum, own_cnt = _raw_diff(v[s], lower_rc[s])
                diff = (own_sum + halves[s][:3]) / (own_cnt + halves[s][3])[None]
                ids = lower_ids[s]
                ring_new = v[s][:, ids] + fac * (weights[s][ids][None] * diff)
                new[s][:, ids] = ring_new
                if ranks[s - 1] == me:
                    new[s - 1][:, dup_ids[s - 1]] = ring_new.to(devices[s - 1])
                else:
                    sends.append((ranks[s - 1], cl.tag(mesh, cl.RING, s, s - 1), ring_new))
            back = {}
            for s in held:
                if s < S - 1 and ranks[s + 1] != me:
                    back[s] = torch.empty((3, int(dup_ids[s].numel())), dtype=torch.float32,
                                          device=devices[s])
                    recvs.append((ranks[s + 1], cl.tag(mesh, cl.RING, s + 1, s), back[s]))
            wire += cl.post(mesh, sends, recvs)
            for s, ring_new in back.items():
                new[s][:, dup_ids[s]] = ring_new
            v = new
    return v, wire


def sharded_mask_to_surface(mesh: ShardMesh, mask,
                            spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                            smooth: Optional[dict] = None,
                            return_stats: bool = False, balance: bool = False,
                            return_parts: bool = False):
    """Surface of a Z-sharded visible mask (>= 127), extracted shard by
    shard with global lattice-edge keys and stitched by the cut-plane key
    property: a vertex is on two shards iff its lattice edge lies in a cut
    plane, and both copies sort to the same place among their shard's
    cut-plane vertices, so the upper shard's ids go to the lower shard's
    duplicates by position, without a search.

    The vertices come back in global key order, equal to the single-device
    ``marching.mask_to_surface``'s; the faces are the same set, shard by
    shard (tet slot order within a shard).  ``smooth`` ({"t", "tmax",
    "bmin", "n_iters"}) runs the fused ca-smoothing on the shards (within
    1e-4 mm of ``mesh.ca_smoothing_device``).  ``balance`` picks Z cuts
    from a per-row triangle histogram so each shard carries about 1/n of
    the triangles (slabs at most twice the uniform one).  Across
    processes the histogram, the own-vertex counts, the checks and the
    times are all-gathered, so every process picks the same cuts and
    bases; the balanced slabs' planes and the cut-plane ids cross as
    messages.

    Returns host (verts (V, 3) world mm float32, faces (F, 3) int32), on
    every process; with ``return_stats`` also {"checks", "cuts",
    "tri_hist", "times"} (the JAX package's bucket histograms are not kept:
    no static buckets); with ``return_parts`` instead (verts_sh, faces_sh,
    checks, meta): each held shard's (3, n_own) world vertices and (3,
    n_tri) global faces on its device (None for shards held elsewhere), for
    ``mesh_io.write_stl_sharded``.  ``checks`` rows are (own vertices,
    triangles, cut-plane vertices owned, duplicates, local vertices).
    ``times`` are the slowest process's; meta's "rank_times" keeps every
    process's and "wire_bytes" counts what crossed between processes.
    """
    t_start = time.perf_counter()
    n_shards = mesh.shape["z"]
    vis = _z_shards(mesh, mask).map(lambda a: (a >= 127).to(torch.uint8))
    Z, Y, X = vis.shape
    if Z % n_shards:
        raise ValueError(f"Z = {Z} must divide evenly over {n_shards} shards")
    Zs = Z // n_shards
    Yp, Xp = Y + 2, X + 2
    ranks, held = vis.sharding.ranks, vis.local
    if 8 * (Z + 2) * Yp * Xp >= 2**31:
        raise ValueError("global volume too large for int32 lattice-edge keys "
                         "(> ~640^3 equivalent)")

    # pass 1: per-row triangles from each uniform slab with its halo planes;
    # global cell rows 0..Z of the padded frame (the last closes the
    # surface against the trailing empty plane); every process gets every
    # shard's rows
    slabs, wire = _padded_slabs(vis, [(s * Zs, s * Zs + Zs + 2) for s in range(n_shards)])
    mine = np.stack([np.concatenate([[s], _row_tris(slabs[s]).cpu().numpy()]) for s in held])
    del slabs
    counts = {int(r[0]): r[1:] for r in np.concatenate(cl.allgather_host(mesh, mine))}
    tri_g = np.zeros(Z + 1, np.int64)
    for s in range(n_shards):
        tri_g[s * Zs:(s + 1) * Zs] = counts[s][:Zs]
    tri_g[Z] = counts[n_shards - 1][Zs]
    if balance and n_shards > 1 and tri_g.sum() > 0:
        cuts = _balanced_cuts(tri_g, Z, n_shards)
    else:
        cuts = [s * Zs for s in range(n_shards)] + [Z]

    # pass 2: each shard marches its own cell rows [cuts[s], cuts[s+1])
    # (the last also row Z), from planes cuts[s] .. cuts[s+1] (+1)
    last = [s == n_shards - 1 for s in range(n_shards)]
    fields, w = _padded_slabs(vis, [(cuts[s], cuts[s + 1] + 1 + last[s])
                                    for s in range(n_shards)])
    wire += w
    parts: List[Optional[_Part]] = [None] * n_shards
    for s in held:
        parts[s] = _Part(fields[s], cuts[s], cuts[s + 1] - cuts[s], last[s], spacing, Yp * Xp)
        fields[s] = None
    del fields

    # the stitch: shard bases from every shard's own count; each shard's
    # lower-plane ids go to the previous shard's duplicates, the counts
    # checked on both sides first
    own = np.concatenate(cl.allgather_host(
        mesh, np.asarray([[s, int(parts[s].own.sum())] for s in held], np.int64)))
    n_own = [int(c) for _, c in sorted(own.tolist())]
    bases = np.concatenate([[0], np.cumsum(n_own)[:-1]]).tolist()
    final = [None if p is None else
             torch.where(p.own, bases[s] + p.own_rank, torch.zeros_like(p.own_rank))
             for s, p in enumerate(parts)]
    me = mesh.rank
    n_dup = lambda s: int(parts[s].dup.sum())  # noqa: E731
    n_low = lambda s: int(parts[s].lower.sum())  # noqa: E731
    sends, recvs, theirs = [], [], {}
    for s in range(n_shards - 1):
        if ranks[s] == me and ranks[s + 1] != me:
            sends.append((ranks[s + 1], cl.tag(mesh, cl.COUNT, s, s + 1),
                          torch.tensor([n_dup(s)])))
            theirs[s] = torch.zeros(1, dtype=torch.int64)
            recvs.append((ranks[s + 1], cl.tag(mesh, cl.COUNT, s + 1, s), theirs[s]))
        elif ranks[s + 1] == me and ranks[s] != me:
            sends.append((ranks[s], cl.tag(mesh, cl.COUNT, s + 1, s),
                          torch.tensor([n_low(s + 1)])))
            theirs[s] = torch.zeros(1, dtype=torch.int64)
            recvs.append((ranks[s], cl.tag(mesh, cl.COUNT, s, s + 1), theirs[s]))
    wire += cl.post(mesh, sends, recvs)
    for s in range(n_shards - 1):
        if me not in (ranks[s], ranks[s + 1]):
            continue
        dups = n_dup(s) if ranks[s] == me else int(theirs[s])
        owned = n_low(s + 1) if ranks[s + 1] == me else int(theirs[s])
        if dups != owned:
            raise AssertionError(
                f"shards {s} and {s + 1} disagree on the cut plane's vertices: "
                f"{dups} duplicates, {owned} owned")
    exports, w = _from_neighbour(
        mesh, ranks, cl.IDS, lambda u: final[u][parts[u].lower], lambda s: (n_dup(s),),
        torch.int64, vis.sharding.devices, step=-1)
    wire += w
    for s in held:
        if s < n_shards - 1:
            final[s][parts[s].dup] = exports[s]
    faces_sh = _lmap(lambda fi, p: fi[p.inverse].reshape(3, p.T).flip(0).to(torch.int32)
                     .contiguous(), final, parts)
    _sync(faces_sh)
    t_march = time.perf_counter()

    if smooth is not None:
        verts_full, w = _smooth(mesh, ranks, parts, (Z, Y, X), spacing, smooth)
        wire += w
    else:
        verts_full = _lmap(lambda p: p.verts3v, parts)
    verts_sh = _lmap(lambda v, p: v[:, p.own].contiguous(), verts_full, parts)
    _sync(verts_sh)
    mine_t = np.asarray([[t_march - t_start, time.perf_counter() - t_march]])
    rank_times = [{"marching": a, "smoothing": b}
                  for a, b in np.concatenate(cl.allgather_host(mesh, mine_t)).tolist()]
    times = {k: max(t[k] for t in rank_times) for k in ("marching", "smoothing")}
    rows = np.concatenate(cl.allgather_host(mesh, np.asarray(
        [[s, n_own[s], parts[s].T, n_low(s), n_dup(s), parts[s].n_verts] for s in held],
        np.int64)))
    checks = rows[np.argsort(rows[:, 0]), 1:]
    wire = int(cl.reduce_host(mesh, [wire], "sum")[0])
    if return_parts:
        return verts_sh, faces_sh, checks, {
            "spacing": tuple(spacing), "smoothed": smooth is not None,
            "cuts": list(cuts), "times": times, "rank_times": rank_times,
            "wire_bytes": wire}
    verts = [shard_world_verts(verts_sh[s]) for s in held]
    faces = [shard_wound_faces(faces_sh[s]) for s in held]
    out = (np.concatenate(cl.allgather_host(mesh, np.concatenate(verts))),
           np.concatenate(cl.allgather_host(mesh, np.concatenate(faces))))
    if return_stats:
        return out + ({"checks": checks.tolist(), "cuts": [int(c) for c in cuts],
                       "tri_hist": tri_g.tolist(), "times": times},)
    return out

"""Z-sharded volume operations over a shard list (port of
invesalius3_tpu/parallel/sharded_ops.py).

The JAX package runs each op as one ``shard_map`` program: halos move by
``ppermute``, flags and counts by ``psum`` and ``all_gather``.  Here one
Python program walks a list of Z-slabs, shard s on ``mesh.devices[s]``:

- a halo is one boundary plane copied between neighbouring shards
  (``copy_``, asynchronous where the devices differ); the volume's ends get
  the fill each call site names;
- halos move in Jacobi order: every shard's ghost planes for a round are
  written from the state after the previous round before any shard runs
  its round, so the rounds, and the labels on tie lines, are the SPMD
  program's;
- a global "changed" flag is an OR over the shards' device flags, read
  once a check; per-shard counts come to the host as one list.

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
    for d in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(d)


def _any(flags: List[torch.Tensor]) -> bool:
    """OR of per-shard 0-d device flags, read to the host once."""
    dev = flags[0].device
    return bool(torch.stack([f.to(dev) for f in flags]).any())


def halo_exchange_z(x: Sharded) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """For each shard: (the previous shard's last plane, the next shard's
    first plane), each (1, Y, X) on that shard's device; zeros at the
    volume's ends."""
    sh = x.shards
    out = []
    for s, a in enumerate(sh):
        prev = (sh[s - 1][-1:].to(a.device, non_blocking=True) if s > 0
                else torch.zeros_like(a[:1]))
        nxt = (sh[s + 1][:1].to(a.device, non_blocking=True) if s < len(sh) - 1
               else torch.zeros_like(a[:1]))
        out.append((prev, nxt))
    return out


def _ghost_pad(shards: List[torch.Tensor]) -> List[torch.Tensor]:
    """(n_s + 2, ...) buffers holding each shard in planes 1..n_s; the
    ghost planes 0 and n_s + 1 are written by ``_refresh``."""
    bufs = []
    for a in shards:
        b = torch.empty((a.shape[0] + 2,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=a.device)
        b[1:-1].copy_(a)
        bufs.append(b)
    return bufs


def _refresh(bufs: List[torch.Tensor], edge_fill) -> int:
    """Write every ghost plane from the neighbours' boundary planes
    (``edge_fill`` at the volume's ends); reads only real planes, so the
    order of the copies does not matter.  Returns the bytes copied between
    shards."""
    moved = 0
    last = len(bufs) - 1
    for s, b in enumerate(bufs):
        if s > 0:
            b[0].copy_(bufs[s - 1][-2], non_blocking=True)
            moved += b[0].numel() * b.element_size()
        else:
            b[0].fill_(edge_fill)
        if s < last:
            b[-1].copy_(bufs[s + 1][1], non_blocking=True)
            moved += b[-1].numel() * b.element_size()
        else:
            b[-1].fill_(edge_fill)
    return moved


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


def _dilate_with_halo(x: Sharded, strct) -> List[torch.Tensor]:
    return [binary_dilation(torch.cat([p, a, n]), strct)[1:-1]
            for a, (p, n) in zip(x.shards, halo_exchange_z(x))]


def sharded_binary_dilation(mesh: ShardMesh, strct: np.ndarray):
    """Binary dilation of a Z-sharded volume: each shard dilates its slab
    padded with its neighbours' boundary planes (structuring elements at
    most 3 deep in Z)."""
    _check_halo_depth(strct)

    def f(x) -> Sharded:
        x = _z_shards(mesh, x).map(lambda a: a.to(torch.bool))
        return Sharded(_dilate_with_halo(x, strct), list(x.starts), x.sharding)

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
        allowed = [(d >= t0) & (d <= t1) for d in data.shards]
        reached = [s.to(torch.bool) & a for s, a in zip(seeds.shards, allowed)]
        while True:
            new = reached
            for _ in range(steps_per_check):
                grown = _dilate_with_halo(Sharded(new, data.starts, data.sharding), strct)
                new = [g.bitwise_and_(a).bitwise_or_(r)
                       for g, a, r in zip(grown, allowed, new)]
            changed = _any([torch.ne(n, r).any() for n, r in zip(new, reached)])
            reached = new
            if not changed:
                return Sharded(reached, list(data.starts), data.sharding)

    return f


def sharded_active_cell_count(mesh: ShardMesh):
    """Marching-cell count of a Z-sharded boolean volume: each shard counts
    the cells that start in it, with the next shard's first plane as its
    halo.  Returns the total once per shard (host int64 array), as the JAX
    program's per-shard psum."""

    def f(vis) -> np.ndarray:
        x = _z_shards(mesh, vis).map(lambda a: a.to(torch.bool))
        counts = [mc.active_of(mc.cell_corners(torch.cat([a, n]))).sum()
                  for a, (_, n) in zip(x.shards, halo_exchange_z(x))]
        total = sum(int(c) for c in counts)
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
    ``stats``, a dict, receives "rounds" and "halo_bytes" per level (coarse
    to fine), "levels" and "launches" (sweep kernel launches per shard and
    axis).  Returns int16 labels as a ``Sharded``; with ``debug_rounds``
    also the rounds per level, with ``debug_rank`` the final ranks.
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
        n_levels = levels
        if n_levels is None:
            n_levels = 3 if min(img.shape) >= 192 else 0
        local_z = img.shape[0] // n_shards
        while n_levels > 0 and (local_z % (2 ** n_levels)
                                or (local_z // 2 ** n_levels) < 1):
            n_levels -= 1
        rounds: List[int] = []
        moved: List[int] = []
        launches = [[0, 0, 0] for _ in range(n_shards)]

        # the image shifted by its global minimum in the input dtype (int16
        # may wrap, as the JAX program's does), then the gradient on
        # halo-padded slabs: the volume's ends are the identity of max
        # (lo) and of min (hi), as reduce_window's SAME edges
        gmin = min(a.min().item() for a in img.shards)
        f = [(a - torch.tensor(gmin, dtype=a.dtype, device=a.device)).to(torch.int32)
             for a in img.shards]
        if algorithm == "Watershed":
            k = tuple(2 * (int(m) // 2) + 1 for m in mg_size)
            lo, hi = _ghost_pad(f), _ghost_pad(f)
            _refresh(lo, -(2**31))
            _refresh(hi, 2**31 - 1)
            f = [(grey_dilation(a, k) - grey_erosion(b, k))[1:-1]
                 for a, b in zip(lo, hi)]
            del lo, hi
        f = [torch.clamp(a, 0, 2**16 - 2).contiguous() for a in f]
        lab_dtype = torch.int16 if mk.dtype in ws._NARROW_LABELS else torch.int32
        lab = [m.to(lab_dtype).contiguous() for m in mk.shards]

        def refine(f_l, lab0_l, rank_init_l, lab_init_l):
            frozen = [l0 != 0 for l0 in lab0_l]
            R = _ghost_pad([torch.where(fr, 0, ri) for fr, ri in zip(frozen, rank_init_l)])
            L = _ghost_pad([torch.where(fr, l0, li)
                            for fr, l0, li in zip(frozen, lab0_l, lab_init_l)])
            # f never changes: its ghosts are written once.  The volume's
            # ends take 2^16 - 1, one above any real cost (f clips to
            # 2^16 - 2), so no path runs through space outside the volume;
            # a fill of 0 would be a zero-cost road through the ghosts.
            F = _ghost_pad(f_l)
            nbytes = _refresh(F, 2**16 - 1)
            quiet = n = 0
            while quiet < quiet_rounds:
                nbytes += _refresh(R, INF_RANK) + _refresh(L, 0)
                prev_l = [b[1:-1].clone() for b in L]
                prev_r = [b[1:-1].clone() for b in R] if stop == "rank" else None
                for s in range(n_shards):
                    before = dict(kernels.LAUNCHES)
                    ws._one_round_padded(R[s], L[s], F[s], connectivity, sweep)
                    for axis in range(3):
                        launches[s][axis] += kernels.LAUNCHES[axis] - before[axis]
                    r, lb = R[s][1:-1], L[s][1:-1]
                    r.masked_fill_(frozen[s], 0)
                    lb.copy_(torch.where(frozen[s], lab0_l[s], lb))
                flags = [torch.any(L[s][1:-1] != prev_l[s]) for s in range(n_shards)]
                if prev_r is not None:
                    flags = [fl | torch.any(R[s][1:-1] != prev_r[s])
                             for s, fl in enumerate(flags)]
                quiet = 0 if _any(flags) else quiet + 1
                n += 1
            rounds.append(n)
            moved.append(nbytes)
            return [b[1:-1] for b in R], [b[1:-1] for b in L]

        def solve(f_l, lab_l, level):
            if level == 0 or f_l[0].shape[0] <= 4:  # local planes per shard
                return refine(f_l, lab_l, [torch.full_like(a, INF_RANK) for a in f_l],
                              lab_l)
            f_c = [ws._pool2(a, -(2**31)) for a in f_l]
            lab_c = [ws._pool2(a, -(2**15)) for a in lab_l]
            rank_c, lab_sol_c = solve(f_c, lab_c, level - 1)
            rank_init, lab_init = [], []
            for a, rc, fc, lc in zip(f_l, rank_c, f_c, lab_sol_c):
                # max with the pooled f: the coarse seed cells' validity fix
                # (invesalius3_tpu/ops/watershed.py watershed_ift_multigrid)
                cost_up = ws._up2(torch.maximum(rc >> DIST_BITS, fc), a.shape)
                rank_init.append(torch.where(cost_up >= (INF_RANK >> DIST_BITS), INF_RANK,
                                             cost_up * (1 << DIST_BITS) + DIST_MAX))
                lab_init.append(ws._up2(lc, a.shape))
            return refine(f_l, lab_l, rank_init, lab_init)

        rank_out, lab_out = solve(f, lab, n_levels)
        out = Sharded([a.to(torch.int16) for a in lab_out], list(img.starts), img.sharding)
        if stats is not None:
            stats.update(rounds=list(rounds), halo_bytes=list(moved), levels=n_levels,
                         launches=launches)
        if debug_rounds:
            return out, list(rounds)
        if debug_rank:
            return out, Sharded(list(rank_out), list(img.starts), img.sharding)
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


def _padded_planes(vis: Sharded, p0: int, p1: int, device) -> torch.Tensor:
    """Planes [p0, p1) of the visible mask padded by one empty voxel on
    every side (plane p holds slice p - 1), as uint8 on ``device``."""
    Z, Y, X = vis.shape
    out = torch.zeros((p1 - p0, Y + 2, X + 2), dtype=torch.uint8, device=device)
    for sh, st in zip(vis.shards, vis.starts):
        lo, hi = max(p0, 1, st + 1), min(p1, Z + 1, st + 1 + sh.shape[0])
        if lo < hi:
            out[lo - p0:hi - p0, 1:-1, 1:-1].copy_(
                sh[lo - 1 - st:hi - 1 - st], non_blocking=True)
    return out


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


def _smooth(parts: List[_Part], shape, spacing, smooth: dict) -> List[torch.Tensor]:
    """Context-aware smoothing of the stitched parts, the global operator
    of ``ops/mesh.ca_smoothing_device`` (grid propagation) with all mesh
    state on its shard: only the ring vertices (in-plane vertices on a cut)
    and ghost rows of the chamfer grid cross.  Returns each part's smoothed
    (3, V_local) world vertices."""
    S = len(parts)
    Z, Yp, Xp = shape[0], shape[1] + 2, shape[2] + 2
    t = float(smooth.get("t", 0.7))
    tmax = float(smooth.get("tmax", 3.0))
    bmin = float(smooth.get("bmin", 0.5))
    n_iters = int(smooth.get("n_iters", 10))
    sx, sy, sz = spacing

    # 1. staircase flags.  The flag is a range test over all incident
    #    faces, so the duplicates' (vmax, vmin) go to the owner, which
    #    thresholds the combined range (an OR of per-side flags would miss
    #    a range split across the cut).
    ranges = []
    for p in parts:
        normals = mo.face_normals_3t(p.verts3v, p.faces_local)
        ranges.append(mo.staircase_range(normals, p.faces_local, p.n_verts))
    for s in range(1, S):
        lo_ids = torch.nonzero(parts[s].lower).squeeze(1)
        dup_ids = torch.nonzero(parts[s - 1].dup).squeeze(1)
        dev = parts[s].verts3v.device
        for a, op in ((0, torch.maximum), (1, torch.minimum)):
            mine = ranges[s][a]
            mine[:, lo_ids] = op(mine[:, lo_ids], ranges[s - 1][a][:, dup_ids].to(dev))
    flags = [mo.flags_of_range(vmax, vmin, t) for vmax, vmin in ranges]

    # 2. weights: own staircase vertices rasterised into each shard's rows
    #    of the global grid (planes z0 - 1 .. z0 + l; the last shard up to
    #    Z + 1 and one empty ghost row), ghost rows folded into and refreshed
    #    from the neighbours before every chamfer step, so the grid is the
    #    single-device one; then each vertex samples it
    vox, grids = [], []
    for s, p in enumerate(parts):
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
        grids.append(grid.reshape(rows, Yp, Xp))
        vox.append((row, yi, xi))
    for s in range(S):
        if s < S - 1:
            nxt = grids[s + 1][1]
            torch.minimum(nxt, grids[s][-1].to(nxt.device), out=nxt)
        if s > 0:
            prv = grids[s - 1][-2]
            torch.minimum(prv, grids[s][0].to(prv.device), out=prv)
    steps = min(16, int(np.ceil(tmax / min(spacing))))
    for _ in range(steps):
        _refresh(grids, np.inf)
        grids = [mo._chamfer(g, (sz, sy, sx), 1) for g in grids]
    _refresh(grids, np.inf)
    weights = []
    for g, (row, yi, xi) in zip(grids, vox):
        d = g.reshape(-1)[(row * Yp + yi) * Xp + xi]
        dev = g.device
        weights.append(mo.weights_of_dist(d, mo._f32(tmax, dev), mo._f32(bmin, dev)))
    del grids

    # 3. weighted Taubin.  Interior vertices have closed fans on their
    #    shard and use its one-ring table; a ring vertex sums the raw
    #    incidence (both other corners of each incident face) from both
    #    sides, which counts each neighbour twice, so its mean divides by
    #    the summed counts (2 deg).  The owner moves it and sends the new
    #    position back to the duplicate after every pass.
    rings, lower_rc, dup_rc, lower_ids, dup_ids = [], [], [], [], []
    for p in parts:
        dm = mc.DeviceMesh(verts3v=p.verts3v, faces3t=p.faces_local, inverse=p.inverse,
                           order=p.order, group_of_sorted=p.gos, spacing=tuple(spacing),
                           vol_shape=tuple(shape))
        neigh, deg = mo.adjacency_from_device_mesh(dm)
        rings.append(mo._ring(neigh, deg, p.n_verts))
        lower_rc.append(_ring_corners(p, p.lower))
        dup_rc.append(_ring_corners(p, p.dup))
        lower_ids.append(torch.nonzero(p.lower).squeeze(1))
        dup_ids.append(torch.nonzero(p.dup).squeeze(1))
    for s in range(1, S):
        if lower_ids[s].numel() != dup_ids[s - 1].numel():
            raise AssertionError(
                f"shards {s - 1} and {s} disagree on the cut plane's vertices: "
                f"{dup_ids[s - 1].numel()} duplicates, {lower_ids[s].numel()} owned")

    v = [p.verts3v for p in parts]
    for _ in range(n_iters):
        for factor in (0.5, -0.53):
            new, halves = [], []
            for s, p in enumerate(parts):
                dev = v[s].device
                fac = mo._f32(factor, dev)
                idx, valid, cnt = rings[s]
                new.append(v[s] + fac * (weights[s][None]
                                         * mo._ring_mean_diff(v[s], idx, valid, cnt)))
                halves.append(_raw_diff(v[s], dup_rc[s]) if s < S - 1 else None)
            for s in range(1, S):
                dev = v[s].device
                fac = mo._f32(factor, dev)
                own_sum, own_cnt = _raw_diff(v[s], lower_rc[s])
                dup_sum, dup_cnt = halves[s - 1]
                diff = (own_sum + dup_sum.to(dev)) / (own_cnt + dup_cnt.to(dev))[None]
                ids = lower_ids[s]
                ring_new = v[s][:, ids] + fac * (weights[s][ids][None] * diff)
                new[s][:, ids] = ring_new
                new[s - 1][:, dup_ids[s - 1]] = ring_new.to(new[s - 1].device)
            v = new
    return v


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
    the triangles (slabs at most twice the uniform one).

    Returns host (verts (V, 3) world mm float32, faces (F, 3) int32); with
    ``return_stats`` also {"checks", "cuts", "tri_hist", "times"} (the
    JAX package's bucket histograms are not kept: no static buckets); with ``return_parts`` instead
    (verts_sh, faces_sh, checks, meta): each shard's (3, n_own) world
    vertices and (3, n_tri) global faces on its device, for
    ``mesh_io.write_stl_sharded``.  ``checks`` rows are (own vertices,
    triangles, cut-plane vertices owned, duplicates, local vertices).
    """
    t_start = time.perf_counter()
    n_shards = mesh.shape["z"]
    vis = _z_shards(mesh, mask).map(lambda a: (a >= 127).to(torch.uint8))
    Z, Y, X = vis.shape
    if Z % n_shards:
        raise ValueError(f"Z = {Z} must divide evenly over {n_shards} shards")
    Zs = Z // n_shards
    Yp, Xp = Y + 2, X + 2
    devices = list(vis.sharding.devices)
    if 8 * (Z + 2) * Yp * Xp >= 2**31:
        raise ValueError("global volume too large for int32 lattice-edge keys "
                         "(> ~640^3 equivalent)")

    # pass 1: per-row triangles from each uniform slab with its halo planes;
    # global cell rows 0..Z of the padded frame (the last closes the
    # surface against the trailing empty plane)
    counts = [_row_tris(_padded_planes(vis, s * Zs, s * Zs + Zs + 2, d)).cpu().numpy()
              for s, d in enumerate(devices)]
    tri_g = np.zeros(Z + 1, np.int64)
    for s, c in enumerate(counts):
        tri_g[s * Zs:(s + 1) * Zs] = c[:Zs]
    tri_g[Z] = counts[-1][Zs]
    if balance and n_shards > 1 and tri_g.sum() > 0:
        cuts = _balanced_cuts(tri_g, Z, n_shards)
    else:
        cuts = [s * Zs for s in range(n_shards)] + [Z]

    # pass 2: each shard marches its own cell rows [cuts[s], cuts[s+1])
    # (the last also row Z), from planes cuts[s] .. cuts[s+1] (+1)
    parts = []
    for s, d in enumerate(devices):
        z0, l = cuts[s], cuts[s + 1] - cuts[s]
        last = s == n_shards - 1
        field = _padded_planes(vis, z0, z0 + l + 1 + last, d)
        parts.append(_Part(field, z0, l, last, spacing, Yp * Xp))
        del field

    # the stitch: shard bases from the host list of own counts; each
    # shard's lower-plane ids go to the previous shard's duplicates
    n_own = [int(p.own.sum()) for p in parts]
    bases = np.concatenate([[0], np.cumsum(n_own)[:-1]]).tolist()
    final = []
    for p, base in zip(parts, bases):
        final.append(torch.where(p.own, base + p.own_rank, torch.zeros_like(p.own_rank)))
    for s in range(n_shards - 1):
        exports = final[s + 1][parts[s + 1].lower]
        dup = parts[s].dup
        if int(dup.sum()) != exports.numel():
            raise AssertionError(
                f"shards {s} and {s + 1} disagree on the cut plane's vertices: "
                f"{int(dup.sum())} duplicates, {exports.numel()} owned")
        final[s][dup] = exports.to(final[s].device)
    faces_sh = [fi[p.inverse].reshape(3, p.T).flip(0).to(torch.int32).contiguous()
                for fi, p in zip(final, parts)]
    _sync(faces_sh)
    t_march = time.perf_counter()

    verts_full = (_smooth(parts, (Z, Y, X), spacing, smooth) if smooth is not None
                  else [p.verts3v for p in parts])
    verts_sh = [v[:, p.own].contiguous() for v, p in zip(verts_full, parts)]
    _sync(verts_sh)
    times = {"marching": t_march - t_start, "smoothing": time.perf_counter() - t_march}
    checks = np.asarray([[n_own[s], parts[s].T, int(parts[s].lower.sum()),
                          int(parts[s].dup.sum()), parts[s].n_verts]
                         for s in range(n_shards)], np.int64)
    if return_parts:
        return verts_sh, faces_sh, checks, {
            "spacing": tuple(spacing), "smoothed": smooth is not None,
            "cuts": list(cuts), "times": times}
    out = (np.concatenate([shard_world_verts(v) for v in verts_sh]),
           np.concatenate([shard_wound_faces(f) for f in faces_sh]))
    if return_stats:
        return out + ({"checks": checks.tolist(), "cuts": [int(c) for c in cuts],
                       "tri_hist": tri_g.tolist(), "times": times},)
    return out

"""Mesh post-processing (port of invesalius3_tpu/ops/mesh.py): normals and
mass properties, one-ring adjacency, Taubin and Laplacian smoothing,
context-aware smoothing (the device path over a marching mesh and the host
path over any mesh), hole filling and connectivity filtering.

Staircase vertices are those whose incident faces' off-axis measure
(1 - |n . axis|) spreads by at least ``t`` on some axis.  Each vertex's
weight falls from 1 at a staircase vertex to ``bmin`` at ``tmax`` mm: the
distance is taken on a voxel grid by a 26-neighbour chamfer
(``propagate="grid"``) or exactly along the mesh by a breadth-first
relaxation (``propagate="mesh"``).  The weighted Taubin iteration (lambda
0.5, mu -0.53) then moves each vertex by the mean of (v_i - v_j) over its
one-ring (reference mesh.rs:27-87, 202-294, 345-395).

Device work takes tensors on any device; the functions that take host
arrays (``find_staircase_artifacts``, ``propagate_weights``,
``vertex_adjacency_fast``, ``laplacian_smooth``, ``ca_smoothing``) run on
``device``, the card unless the caller passes "cpu".  Hole filling and the
connectivity filters are host numpy and scipy, as in the JAX package.

The one-ring of a marching mesh comes from the marching dedup sort: corners
sorted by vertex give each vertex its run of incident corners, and on a
closed oriented mesh the next corner of each incident face lists the ring
once.  The JAX package's TPU workarounds are gone: rows sort with
``torch.sort`` (not a bitonic network) and Taubin gathers one flat (D, V)
table (not degree buckets).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device

MAX_DEG = 16  # marching-tet vertex degree bound, checked after the build


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array or a tensor as a ``dtype`` tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    if not a.flags.writeable:  # a tensor never aliases memory it may not own
        a = a.copy()
    return torch.as_tensor(a).to(device=device, dtype=dtype)


def _cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


# ---------------------------------------------------------------------------
# Adjacency
# ---------------------------------------------------------------------------


def vertex_adjacency(faces: np.ndarray, n_vertices: int) -> Tuple[np.ndarray, np.ndarray]:
    """Padded neighbor table on the host: (V, max_deg) int32 (pad = the
    vertex's own id) and per-vertex neighbor counts (V,)."""
    faces = np.asarray(faces, np.int64)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [0, 2]]])
    e = np.concatenate([e, e[:, ::-1]])
    order = np.lexsort((e[:, 1], e[:, 0]))
    e = e[order]
    keep = np.ones(len(e), bool)
    keep[1:] = (e[1:, 0] != e[:-1, 0]) | (e[1:, 1] != e[:-1, 1])
    e = e[keep]
    src = e[:, 0]
    deg = np.bincount(src, minlength=n_vertices).astype(np.int32)
    max_deg = max(1, int(deg.max()) if len(deg) else 1)
    table = np.tile(np.arange(n_vertices, dtype=np.int32)[:, None], (1, max_deg))
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    positions = np.arange(len(e)) - starts[src]
    table[src, positions] = e[:, 1]
    return table, deg


def _adjacency_device(faces: torch.Tensor, n_vertices: int, max_deg: int):
    """Padded, deduplicated neighbor table on the faces' device: sort the
    directed edges by (src, dst), mark first occurrences, place each unique
    edge at (unique rank - its source's first unique rank).  Duplicate and
    overflow writes go to a dummy row V, sliced off."""
    f = faces.long()
    V = n_vertices
    e_src = torch.cat([f[:, 0], f[:, 1], f[:, 2], f[:, 1], f[:, 2], f[:, 0]])
    e_dst = torch.cat([f[:, 1], f[:, 2], f[:, 0], f[:, 0], f[:, 1], f[:, 2]])
    key, order = torch.sort(e_src * V + e_dst)
    src_s, dst_s = e_src[order], e_dst[order]
    is_new = torch.ones_like(key, dtype=torch.bool)
    is_new[1:] = key[1:] != key[:-1]
    uniq_rank = torch.cumsum(is_new, 0) - 1
    group_start = torch.full((V,), 2**30, dtype=torch.int64, device=f.device)
    group_start.scatter_reduce_(0, src_s, uniq_rank, "amin")
    pos = uniq_rank - group_start[src_s]
    deg = torch.zeros((V,), dtype=torch.int64, device=f.device)
    deg.scatter_add_(0, src_s, is_new.long())
    ok = is_new & (pos < max_deg)
    table = torch.arange(V + 1, dtype=torch.int32, device=f.device)[:, None]
    table = table.repeat(1, max_deg)
    table[torch.where(ok, src_s, V), torch.where(ok, pos, 0)] = dst_s.to(torch.int32)
    return table[:V], torch.clamp(deg, max=max_deg).to(torch.int32)


def vertex_adjacency_fast(faces: np.ndarray, n_vertices: int,
                          device=DEFAULT_DEVICE) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table (V, max_deg) int32, deg (V,) int32) on ``device``, the same
    layout as ``vertex_adjacency``; max_deg is the largest incident-corner
    count rounded up to 8 (at least 8)."""
    dev = resolve_device(device)
    faces = np.asarray(faces)
    deg_counts = np.bincount(faces.ravel(), minlength=n_vertices)
    max_deg = int(deg_counts.max()) if len(deg_counts) else 1
    max_deg = max(8, ((max_deg + 7) // 8) * 8)
    return _adjacency_device(_as_tensor(faces, torch.int64, dev), n_vertices,
                             max_deg)


def adjacency_from_device_mesh(dm) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neigh (D, V), deg (V,)): each vertex's one-ring ascending in rows
    0..deg-1, the rest V.  D is the real max degree rounded up to 4.
    Raises if a vertex has more than ``MAX_DEG`` incident corners."""
    max_deg = MAX_DEG
    order, gos, inverse = dm.order, dm.group_of_sorted, dm.inverse
    M = order.shape[0]
    V = dm.n_verts
    T = M // 3
    dev = order.device
    new_group = torch.ones((M,), dtype=torch.bool, device=dev)
    new_group[1:] = gos[1:] != gos[:-1]
    starts = torch.nonzero(new_group).squeeze(1)  # sorted position per vertex
    run = torch.diff(starts, append=torch.tensor([M], device=dev))
    pos = torch.arange(M, device=dev) - starts[gos]
    mg = int(run.max()) if V else 0
    if mg > max_deg:
        raise ValueError(f"vertex degree {mg} exceeds the max_deg={max_deg} "
                         "bound")
    deg = torch.clamp(run, max=max_deg)
    # the ccw-next corner of each incident face (corner-major inverse)
    tri = order % T
    corner = order // T
    nb1 = inverse[((corner + 1) % 3) * T + tri]
    table = torch.full((max_deg, V), V, dtype=torch.int64, device=dev)
    table[pos, gos] = nb1
    table, _ = torch.sort(table, dim=0)
    out_deg = min(max_deg, ((max(mg, 4) + 3) // 4) * 4)
    return table[:out_deg].contiguous(), deg


# ---------------------------------------------------------------------------
# Normals and mass properties (vtkMassProperties semantics)
# ---------------------------------------------------------------------------


def face_normals_3t(verts3v: torch.Tensor, faces3t: torch.Tensor) -> torch.Tensor:
    """(3, F) unit normals from (3, V) verts and corner-major (3, F) faces."""
    f = faces3t.long()
    p0, p1, p2 = verts3v[:, f[0]], verts3v[:, f[1]], verts3v[:, f[2]]
    n = _cross3(p1 - p0, p2 - p0)
    # the sum of squares written out, in the JAX package's order
    norm = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])[None]
    return n / torch.where(norm == 0, _f32(1.0, n.device), norm)


def face_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(F, 3) unit normals of (V, 3) verts and (F, 3) faces, on their device."""
    return face_normals_3t(verts.to(torch.float32).t(), faces.t()).t()


def mass_properties(verts: torch.Tensor, faces: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(volume, area) of a closed mesh by the divergence theorem, as 0-d
    float32 tensors on the mesh's device."""
    v3 = verts.to(torch.float32).t()
    f = faces.long()
    p0, p1, p2 = v3[:, f[:, 0]], v3[:, f[:, 1]], v3[:, f[:, 2]]
    c = _cross3(p1 - p0, p2 - p0)
    dev = v3.device
    area = torch.sum(torch.sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])) / _f32(2.0, dev)
    vol = torch.abs(torch.sum(p0 * _cross3(p1, p2)) / _f32(6.0, dev))
    return vol, area


# ---------------------------------------------------------------------------
# Taubin and Laplacian smoothing (reference mesh.rs:345-395 semantics)
# ---------------------------------------------------------------------------


def _ring_mean_diff(v, idx, valid, cnt) -> torch.Tensor:
    """(3, V) mean over the one-ring of (v_i - v_j); ``valid`` masks the
    table's pad rows."""
    diff = (v[:, None, :] - v[:, idx]) * valid[None]
    return torch.sum(diff, dim=1) / cnt[None]


def _ring(neigh: torch.Tensor, deg: torch.Tensor, V: int):
    """(gather index, valid mask, neighbor count) of a (D, V) table."""
    dev = neigh.device
    D = neigh.shape[0]
    valid = (torch.arange(D, device=dev)[:, None] < deg[None, :]).to(torch.float32)
    idx = torch.clamp(neigh.long(), max=max(V - 1, 0))  # pad rows masked by valid
    cnt = torch.clamp(deg.to(torch.float32), min=1.0)
    return idx, valid, cnt


def _taubin_core(verts3v, neigh, deg, weights, lam: float, mu: float,
                 steps: int) -> torch.Tensor:
    """Weighted two-phase Taubin on (3, V) verts and a (D, V) table: per
    pass v += factor * w * mean(v - v_j).  One flat (D, V) gather a pass."""
    dev = verts3v.device
    idx, valid, cnt = _ring(neigh, deg, verts3v.shape[1])
    v = verts3v
    for _ in range(steps):
        for factor in (_f32(lam, dev), _f32(mu, dev)):
            v = v + factor * (weights[None] * _ring_mean_diff(v, idx, valid, cnt))
    return v


def taubin_smooth(verts: torch.Tensor, neigh: torch.Tensor, deg: torch.Tensor,
                  weights: torch.Tensor, lam: float = 0.5, mu: float = -0.53,
                  steps: int = 10) -> torch.Tensor:
    """Weighted Taubin on (V, 3) verts and a (V, D) table, sign convention
    of the reference Rust (v += w * lambda * mean(v - neighbors)); returns
    (V, 3) on the inputs' device."""
    out = _taubin_core(verts.to(torch.float32).t(), neigh.t(), deg, weights,
                       lam, mu, steps)
    return out.t()


def laplacian_smooth(verts: np.ndarray, faces: np.ndarray,
                     iterations: int = 20, relaxation: float = 0.4,
                     device=DEFAULT_DEVICE) -> np.ndarray:
    """vtkSmoothPolyDataFilter-style Laplacian relaxation on ``device``
    (reference surface.py:355 ApplySmoothFilter defaults 20 x 0.4)."""
    dev = resolve_device(device)
    table, deg = vertex_adjacency_fast(np.asarray(faces), len(verts), dev)
    v = _as_tensor(verts, torch.float32, dev).t()
    idx, valid, cnt = _ring(table.t(), deg, v.shape[1])
    relax = _f32(relaxation, dev)
    for _ in range(int(iterations)):
        v = v - relax * _ring_mean_diff(v, idx, valid, cnt)
    return v.t().cpu().numpy()


# ---------------------------------------------------------------------------
# Context-aware smoothing (reference mesh.rs:27-87)
# ---------------------------------------------------------------------------


def find_staircase_artifacts(verts: np.ndarray, faces: np.ndarray,
                             normals: np.ndarray, t: float = 0.7,
                             stack_orientation=(0.0, 0.0, 1.0),
                             device=DEFAULT_DEVICE) -> np.ndarray:
    """Boolean (V,): vertices whose incident-face normals' axis-deviation
    spread reaches ``t`` on any axis; ``t=0`` flags every vertex with a
    face (the reference build's effective behaviour)."""
    dev = resolve_device(device)
    flags = staircase_flags(_as_tensor(normals, torch.float32, dev).t(),
                            _as_tensor(faces, torch.int64, dev).t(), len(verts), t,
                            (stack_orientation, (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)))
    return flags.cpu().numpy()


def staircase_flags(normals3f: torch.Tensor, faces3t: torch.Tensor,
                    n_verts: int, t: float,
                    axes=((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0))
                    ) -> torch.Tensor:
    """(V,) bool: vertex has a face and its off-axis measure spans >= t on
    some axis (the rows of ``axes``, by default z, y, x of the stack)."""
    vmax, vmin = staircase_range(normals3f, faces3t, n_verts, axes)
    return flags_of_range(vmax, vmin, t)


def staircase_range(normals3f: torch.Tensor, faces3t: torch.Tensor,
                    n_verts: int,
                    axes=((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0))):
    """(vmax, vmin), each (axes, V): the largest and smallest off-axis
    measure over each vertex's faces (-inf and inf for a vertex without
    one).  Ranges from two parts of a mesh combine by max and min."""
    dev = normals3f.device
    ax = torch.tensor(axes, dtype=torch.float32, device=dev)
    # axes @ normals written out, so no matmul precision mode (TF32) can
    # touch the flags; a unit axis picks one normal component exactly
    of = 1.0 - torch.abs(ax[:, 0, None] * normals3f[0] + ax[:, 1, None] * normals3f[1]
                         + ax[:, 2, None] * normals3f[2])  # (axes, F)
    vmax = torch.full((len(axes), n_verts), -np.inf, dtype=torch.float32, device=dev)
    vmin = torch.full((len(axes), n_verts), np.inf, dtype=torch.float32, device=dev)
    for a in range(len(axes)):
        for c in range(3):
            idx = faces3t[c].long()
            vmax[a].scatter_reduce_(0, idx, of[a], "amax")
            vmin[a].scatter_reduce_(0, idx, of[a], "amin")
    return vmax, vmin


def flags_of_range(vmax: torch.Tensor, vmin: torch.Tensor, t: float) -> torch.Tensor:
    """(V,) bool: the vertex has a face and its range reaches ``t`` on some
    axis."""
    t32 = _f32(t, vmax.device)
    return torch.isfinite(vmax[0]) & ((vmax - vmin) >= t32).any(dim=0)


def _propagate_core_t(verts3v, neigh, deg, seeds, tmax: float, bmin: float,
                      max_iters: int = 24) -> torch.Tensor:
    """Weights by the mesh BFS on (3, V) verts and a (D, V) table: each
    round, every vertex takes the neighbor seed nearest to it (squared
    distance within tmax, the first such neighbor on a tie) if nearer than
    its own.  Stops after a round in which no vertex changed (one host read
    a round) or after ``max_iters`` rounds."""
    dev = verts3v.device
    V = verts3v.shape[1]
    idx, valid, _ = _ring(neigh, deg, V)
    valid = valid.bool()
    inf = _f32(np.inf, dev)
    tmax_t, bmin_t = _f32(tmax, dev), _f32(bmin, dev)
    tmax_sq = tmax_t * tmax_t
    dist = torch.where(seeds, _f32(0.0, dev), inf)
    seed_pos = torch.where(seeds[None], verts3v, _f32(0.0, dev))
    for _ in range(max_iters):
        nb_dist = dist[idx]  # (D, V)
        nb_seed = seed_pos[:, idx]  # (3, D, V)
        diff = verts3v[:, None, :] - nb_seed
        d_sq = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
        ok = valid & torch.isfinite(nb_dist) & (d_sq <= tmax_sq)
        d_sq = torch.where(ok, d_sq, inf)
        best = torch.argmin(d_sq, dim=0)  # first index of the minimum
        best_d = d_sq.gather(0, best[None])[0]
        take = best_d < dist
        dist = torch.where(take, best_d, dist)
        chosen = nb_seed.gather(1, best[None, None, :].expand(3, 1, V))[:, 0]
        seed_pos = torch.where(take[None], chosen, seed_pos)
        if not bool(take.any()):
            break
    reached = torch.isfinite(dist)
    w = ((1.0 - torch.sqrt(torch.where(reached, dist, _f32(0.0, dev))) / tmax_t)
         * (1.0 - bmin_t) + bmin_t)
    return torch.where(reached, w, bmin_t)


def propagate_weights(verts: np.ndarray, neigh: np.ndarray, deg: np.ndarray,
                      seeds: np.ndarray, tmax: float, bmin: float,
                      max_iters: int = 24, device=DEFAULT_DEVICE) -> np.ndarray:
    """BFS weight propagation from staircase vertices (reference
    mesh.rs:202-294): each vertex takes the squared distance to the seed
    that reaches it (within tmax), weight = (1 - d/tmax)(1-bmin)+bmin,
    unreached -> bmin.  (V, 3) verts, (V, D) table; runs on ``device``."""
    dev = resolve_device(device)
    return _propagate_core_t(
        _as_tensor(verts, torch.float32, dev).t(),
        _as_tensor(neigh, torch.int64, dev).t(),
        _as_tensor(deg, torch.int64, dev), _as_tensor(seeds, torch.bool, dev),
        tmax, bmin, max_iters).cpu().numpy()


def _rasterize_seeds(vox3v, flagged, shape) -> torch.Tensor:
    """Grid of 0 at the voxels nearest to flagged vertices, inf elsewhere."""
    Z, Y, X = shape
    zi = torch.clamp(torch.round(vox3v[0]).long(), 0, Z - 1)
    yi = torch.clamp(torch.round(vox3v[1]).long(), 0, Y - 1)
    xi = torch.clamp(torch.round(vox3v[2]).long(), 0, X - 1)
    grid = torch.full((Z * Y * X,), np.inf, dtype=torch.float32,
                      device=vox3v.device)
    grid[((zi * Y + yi) * X + xi)[flagged]] = 0.0
    return grid.reshape(shape)


def _chamfer(grid: torch.Tensor, spacing_zyx, steps: int) -> torch.Tensor:
    """``steps`` passes of 26-neighbour min-plus relaxation.  A neighbour
    outside the grid is inf in the JAX package, and min(x, inf) = x, so
    each offset only touches the overlapping slabs."""
    sz, sy, sx = spacing_zyx
    offs = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1) if (dz, dy, dx) != (0, 0, 0)]
    costs = [float(np.sqrt((dz * sz) ** 2 + (dy * sy) ** 2 + (dx * sx) ** 2))
             for dz, dy, dx in offs]
    Z, Y, X = grid.shape

    def span(d, n):  # (destination, source) slices for out[i] = g[i - d]
        return (slice(max(d, 0), n + min(d, 0)), slice(max(-d, 0), n - max(d, 0)))

    for _ in range(steps):
        g = grid
        out = g.clone()
        for (dz, dy, dx), c in zip(offs, costs):
            (zd, zs), (yd, ys), (xd, xs) = span(dz, Z), span(dy, Y), span(dx, X)
            dst = out[zd, yd, xd]
            torch.minimum(dst, g[zs, ys, xs] + c, out=dst)
        grid = out
    return grid


def _grid_weights(grid, vox3v, tmax, bmin) -> torch.Tensor:
    Z, Y, X = grid.shape
    zi = torch.clamp(torch.round(vox3v[0]).long(), 0, Z - 1)
    yi = torch.clamp(torch.round(vox3v[1]).long(), 0, Y - 1)
    xi = torch.clamp(torch.round(vox3v[2]).long(), 0, X - 1)
    return weights_of_dist(grid.reshape(-1)[(zi * Y + yi) * X + xi], tmax, bmin)


def voxel_coord(world: torch.Tensor, origin: float, spacing: float) -> torch.Tensor:
    """(world - origin) / spacing in float32, rounded as a true division on
    every device.  On the card torch divides by a host float as a product
    with its float32 reciprocal, one ulp off; marching-cubes vertices of a
    binary mask sit at half voxels, where one ulp picks the other voxel."""
    return (world - origin) / _f32(spacing, world.device)


def weights_of_dist(d, tmax, bmin) -> torch.Tensor:
    """Weight 1 at a staircase vertex falling linearly to ``bmin`` at
    ``tmax`` mm, ``bmin`` beyond (0-d float32 ``tmax`` and ``bmin``)."""
    w = (1.0 - d / tmax) * (1.0 - bmin) + bmin
    return torch.where(d <= tmax, w, bmin)


def ca_smoothing_device(dm, t: float = 0.7, tmax: float = 3.0,
                        bmin: float = 0.5, n_iters: int = 10,
                        propagate: str = "grid",
                        propagate_iters: int = 12) -> torch.Tensor:
    """Context-aware smoothing over a ``marching.DeviceMesh``; returns the
    smoothed (3, V) world verts on the mesh's device.  ``propagate="grid"``
    takes the staircase distance by the voxel-grid chamfer, ``"mesh"`` by
    the exact mesh BFS (at most ``propagate_iters`` rounds)."""
    verts3v = dm.verts3v
    dev = verts3v.device
    normals3f = face_normals_3t(verts3v, dm.faces3t)
    flagged = staircase_flags(normals3f, dm.faces3t, dm.n_verts, t)
    neigh, deg = adjacency_from_device_mesh(dm)
    if propagate == "grid":
        sx, sy, sz = dm.spacing
        ox, oy, oz = dm.origin_shift
        vox3v = torch.stack([voxel_coord(verts3v[2], oz, sz), voxel_coord(verts3v[1], oy, sy),
                             voxel_coord(verts3v[0], ox, sx)])  # (3 zyx, V)
        steps = min(16, int(np.ceil(tmax / min(dm.spacing))))
        grid = _rasterize_seeds(vox3v, flagged, dm.vol_shape)
        grid = _chamfer(grid, (sz, sy, sx), steps)
        weights = _grid_weights(grid, vox3v, _f32(tmax, dev), _f32(bmin, dev))
    else:
        weights = _propagate_core_t(verts3v, neigh, deg, flagged, tmax, bmin,
                                    propagate_iters)
    return _taubin_core(verts3v, neigh, deg, weights, 0.5, -0.53, n_iters)


def ca_smoothing(verts: np.ndarray, faces: np.ndarray, t: float = 0.7,
                 tmax: float = 3.0, bmin: float = 0.5, n_iters: int = 10,
                 propagate_iters: int = 12, device=DEFAULT_DEVICE) -> np.ndarray:
    """Context-aware smoothing of a host mesh on ``device`` (reference
    mesh.rs:27-87): staircase flags, mesh BFS weights (at most
    ``propagate_iters`` rounds), weighted Taubin; returns (V, 3) float32."""
    dev = resolve_device(device)
    faces = np.asarray(faces)
    V = len(verts)
    verts3v = _as_tensor(verts, torch.float32, dev).t().contiguous()
    faces3t = _as_tensor(faces, torch.int64, dev).t()
    flagged = staircase_flags(face_normals_3t(verts3v, faces3t), faces3t, V, t)
    neigh, deg = vertex_adjacency_fast(faces, V, dev)
    neigh_dv = neigh.t()
    weights = _propagate_core_t(verts3v, neigh_dv, deg, flagged, tmax, bmin,
                                propagate_iters)
    out = _taubin_core(verts3v, neigh_dv, deg, weights, 0.5, -0.53, n_iters)
    return out.t().cpu().numpy()


# ---------------------------------------------------------------------------
# Hole filling (vtkFillHolesFilter semantics, reference
# surface_process.py:397-415 and the mesh-import flow surface.py:619)
# ---------------------------------------------------------------------------


def boundary_loops(faces: np.ndarray, n_vertices: int) -> list:
    """Closed boundary loops (vertex index lists in the walk order of the
    existing faces' directed boundary edges).  An undirected edge in exactly
    one face is a boundary edge; open or non-manifold chains are dropped."""
    faces = np.asarray(faces, np.int64)
    if len(faces) == 0:
        return []
    src = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    dst = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    key = np.minimum(src, dst) * n_vertices + np.maximum(src, dst)
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    on_boundary = counts[inv] == 1
    bsrc, bdst = src[on_boundary], dst[on_boundary]
    succ: dict = {}
    for a, b in zip(bsrc.tolist(), bdst.tolist()):
        if a in succ:  # non-manifold pinch: keep first, drop rest
            continue
        succ[a] = b
    loops = []
    visited: set = set()
    for start in succ:
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        cur = succ[start]
        ok = True
        while cur != start:
            if cur in visited or cur not in succ or len(loop) > len(succ):
                ok = False
                break
            loop.append(cur)
            visited.add(cur)
            cur = succ[cur]
        if ok and len(loop) >= 3:
            loops.append(loop)
    return loops


def fill_holes(verts: np.ndarray, faces: np.ndarray,
               hole_size: float = 300.0) -> Tuple[np.ndarray, np.ndarray, int]:
    """Cap boundary loops whose circumsphere radius <= ``hole_size`` with a
    centroid fan (one new vertex a hole; a 3-loop gets one triangle), wound
    against the boundary edges.  Returns (verts, faces, n_filled)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    loops = boundary_loops(faces, len(verts))
    new_verts = [verts]
    new_faces = [faces]
    n_total = len(verts)
    n_filled = 0
    for loop in loops:
        pts = verts[loop]
        radius = 0.5 * float(np.linalg.norm(pts.max(0) - pts.min(0)))
        if radius > hole_size:
            continue
        if len(loop) == 3:
            a, b, c = loop
            cap = np.array([[c, b, a]], np.int32)
        else:
            centroid = pts.mean(0, dtype=np.float64).astype(np.float32)
            ci = n_total
            new_verts.append(centroid[None])
            n_total += 1
            nxt = np.roll(loop, -1)
            cap = np.stack([nxt, np.asarray(loop), np.full(len(loop), ci)],
                           axis=1).astype(np.int32)
        new_faces.append(cap)
        n_filled += 1
    if n_filled == 0:
        return verts, faces, 0
    return (np.concatenate(new_verts), np.concatenate(new_faces), n_filled)


# ---------------------------------------------------------------------------
# Connectivity filtering (vtkPolyDataConnectivityFilter semantics)
# ---------------------------------------------------------------------------


def mesh_components(faces: np.ndarray, n_vertices: int) -> np.ndarray:
    """Connected-component id per vertex (scipy sparse BFS)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    faces = np.asarray(faces, np.int64)
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    g = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                   shape=(n_vertices, n_vertices))
    _, labels = connected_components(g, directed=False)
    return labels


def _extract_vertex_subset(verts: np.ndarray, faces: np.ndarray,
                           keep_v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Compact a mesh to the vertices flagged in boolean keep_v, keeping
    faces whose three corners all survive."""
    remap = -np.ones(len(verts), np.int64)
    remap[keep_v] = np.arange(int(keep_v.sum()))
    keep_f = keep_v[faces].all(axis=1)
    return verts[keep_v], remap[faces[keep_f]].astype(np.int32)


def keep_largest_component(verts: np.ndarray, faces: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep only the largest connected surface by vertex count (reference
    surface_process.py:377-391 keep_largest branch)."""
    comp = mesh_components(faces, len(verts))
    ids, counts = np.unique(comp, return_counts=True)
    return _extract_vertex_subset(verts, faces, comp == ids[np.argmax(counts)])


def split_components(verts: np.ndarray, faces: np.ndarray
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The mesh's connected components, largest first (reference
    surface.py:431 OnSplitSurface)."""
    comp = mesh_components(faces, len(verts))
    ids, counts = np.unique(comp, return_counts=True)
    return [_extract_vertex_subset(verts, faces, comp == cid)
            for cid in ids[np.argsort(-counts)]]


def select_components_by_seeds(verts: np.ndarray, faces: np.ndarray,
                               seed_vertices) -> Tuple[np.ndarray, np.ndarray]:
    """Keep every connected component holding at least one seed vertex id
    (reference surface.py:319 OnSeedSurface)."""
    seed_vertices = np.atleast_1d(np.asarray(seed_vertices, np.int64))
    comp = mesh_components(faces, len(verts))
    wanted = np.unique(comp[seed_vertices])
    return _extract_vertex_subset(verts, faces, np.isin(comp, wanted))


def nearest_vertex(verts: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Vertex id nearest to each query point (world mm)."""
    points = np.atleast_2d(np.asarray(points, np.float32))
    out = np.empty(len(points), np.int64)
    v = np.asarray(verts, np.float32)
    for i, p in enumerate(points):
        out[i] = int(np.argmin(((v - p) ** 2).sum(axis=1)))
    return out


# ---------------------------------------------------------------------------
# Remesh utilities of the brain-peel chain (reference brainmesh_handler.py
# downsample / upsample / warp helpers :418-500).  Host numpy, as in the
# JAX package, with its casts and its np.unique / np.add.at orders, so the
# two agree bit for bit on equal inputs.
# ---------------------------------------------------------------------------


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, normalized (the quantity
    vtkPolyDataNormals feeds vtkWarpVector in reference SliceDown
    brainmesh_handler.py:200-210); float32."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for c in range(3):
        np.add.at(vn, f[:, c], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


def cluster_remesh(verts: np.ndarray, faces: np.ndarray,
                   n_clusters: int = 3000) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform vertex-clustering remesh, the stand-in for the reference's
    pyacvd ``Clustering(...).cluster(3000)`` (brainmesh_handler.py:466).
    The grid spans the vertices' bounding box; its resolution is
    binary-searched so that about ``n_clusters`` cells are occupied.  A
    new vertex is its cluster's mean; degenerate faces and duplicates (in
    any rotation) drop."""
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    lo = v.min(axis=0)
    span = np.maximum(v.max(axis=0) - lo, 1e-6)
    res_lo, res_hi = 2, 256
    best = None
    for _ in range(10):
        res = (res_lo + res_hi) // 2
        cell = np.floor((v - lo) / span * (res - 1e-4)).astype(np.int64)
        key = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
        uniq, inverse = np.unique(key, return_inverse=True)
        if best is None or abs(len(uniq) - n_clusters) < abs(best[0] - n_clusters):
            best = (len(uniq), inverse)
        if len(uniq) < n_clusters:
            res_lo = res + 1
        else:
            res_hi = res - 1
        if res_lo > res_hi:
            break
    n_new, inverse = best
    sums = np.zeros((n_new, 3), np.float64)
    np.add.at(sums, inverse, v)
    counts = np.bincount(inverse, minlength=n_new)
    new_v = (sums / counts[:, None]).astype(np.float32)
    nf = inverse[f]
    keep = ((nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2])
            & (nf[:, 0] != nf[:, 2]))
    nf = nf[keep]
    sf = np.sort(nf, axis=1)
    _, first = np.unique((sf[:, 0] * n_new + sf[:, 1]) * n_new + sf[:, 2],
                         return_index=True)
    return new_v, nf[np.sort(first)].astype(np.int32)


def subdivide_linear(verts: np.ndarray, faces: np.ndarray,
                     n_subdivisions: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Midpoint (linear) subdivision, vtkLinearSubdivisionFilter (reference
    brainmesh_handler.py:438 upsample): each pass splits a triangle in four,
    shared edge midpoints deduplicated by their sorted-edge key."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    for _ in range(n_subdivisions):
        V = len(v)
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        ek = np.sort(e, axis=1)
        uniq, inv = np.unique(ek[:, 0] * V + ek[:, 1], return_inverse=True)
        mids = (v[uniq // V] + v[uniq % V]) * 0.5
        m = inv.reshape(3, -1).T + V  # midpoint ids per face: 01, 12, 20
        v = np.concatenate([v, mids])
        f = np.concatenate([
            np.stack([f[:, 0], m[:, 0], m[:, 2]], 1),
            np.stack([m[:, 0], f[:, 1], m[:, 1]], 1),
            np.stack([m[:, 2], m[:, 1], f[:, 2]], 1),
            m,
        ])
    return v.astype(np.float32), f.astype(np.int32)


def warp_along_normals(verts: np.ndarray, faces: np.ndarray,
                       distance: float) -> np.ndarray:
    """Every vertex moved ``distance`` along its normal: vtkWarpVector with
    SetScaleFactor (reference SliceDown warps by -1 to peel inward,
    brainmesh_handler.py:202-210)."""
    return (np.asarray(verts, np.float32)
            + np.float32(distance) * vertex_normals(verts, faces))

"""Context-aware smoothing of a marching mesh (port of
invesalius3_tpu/ops/mesh.py: ``ca_smoothing_device`` with the grid-chamfer
weights, and what it calls).

Staircase vertices are those whose incident faces' off-axis measure
(1 - |n . axis|) spreads by at least ``t`` on some axis.  Each vertex's
weight falls from 1 at a staircase vertex to ``bmin`` at ``tmax`` mm, with
the distance taken on a voxel grid by a 26-neighbour chamfer.  The weighted
Taubin iteration (lambda 0.5, mu -0.53) then moves each vertex by the mean
of (v_i - v_j) over its one-ring (reference mesh.rs:27-87, 345-395).

The one-ring comes from the marching dedup sort: corners sorted by vertex
give each vertex its run of incident corners, and on a closed oriented
mesh the next corner of each incident face lists the ring once.  The JAX
package's TPU workarounds are gone: rows sort with ``torch.sort`` (not a
bitonic network) and Taubin gathers one flat (D, V) table (not degree
buckets).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MAX_DEG = 16  # marching-tet vertex degree bound, checked after the build


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def face_normals_3t(verts3v: torch.Tensor, faces3t: torch.Tensor) -> torch.Tensor:
    """(3, F) unit normals from (3, V) verts and corner-major (3, F) faces."""
    f = faces3t.long()
    p0, p1, p2 = verts3v[:, f[0]], verts3v[:, f[1]], verts3v[:, f[2]]
    u = p1 - p0
    w = p2 - p0
    n = torch.stack([u[1] * w[2] - u[2] * w[1],
                     u[2] * w[0] - u[0] * w[2],
                     u[0] * w[1] - u[1] * w[0]])
    # the sum of squares written out, in the JAX package's order
    norm = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])[None]
    return n / torch.where(norm == 0, _f32(1.0, n.device), norm)


def staircase_flags(normals3f: torch.Tensor, faces3t: torch.Tensor,
                    n_verts: int, t: float) -> torch.Tensor:
    """(V,) bool: vertex has a face and its off-axis measure spans >= t on
    some axis (axes z, y, x of the stack)."""
    # axes @ normals with unit axes (0,0,1), (0,1,0), (1,0,0): elementwise,
    # so no matmul precision mode (TF32) can touch the flags
    of = 1.0 - torch.abs(torch.stack([normals3f[2], normals3f[1], normals3f[0]]))
    dev = normals3f.device
    t32 = _f32(t, dev)
    has_face = None
    flag = torch.zeros((n_verts,), dtype=torch.bool, device=dev)
    for a in range(3):
        vmax = torch.full((n_verts,), -np.inf, dtype=torch.float32, device=dev)
        vmin = torch.full((n_verts,), np.inf, dtype=torch.float32, device=dev)
        for c in range(3):
            idx = faces3t[c].long()
            vmax.scatter_reduce_(0, idx, of[a], "amax")
            vmin.scatter_reduce_(0, idx, of[a], "amin")
        if has_face is None:
            has_face = torch.isfinite(vmax)
        flag |= (vmax - vmin) >= t32
    return has_face & flag


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
    d = grid.reshape(-1)[(zi * Y + yi) * X + xi]
    w = (1.0 - d / tmax) * (1.0 - bmin) + bmin
    return torch.where(d <= tmax, w, bmin)


def taubin_smooth(verts3v, neigh, deg, weights, lam: float, mu: float,
                  steps: int) -> torch.Tensor:
    """Weighted two-phase Taubin: per pass v += factor * w * mean(v - v_j)
    over the one-ring.  One flat (D, V) gather per pass."""
    dev = verts3v.device
    V = verts3v.shape[1]
    D = neigh.shape[0]
    valid = (torch.arange(D, device=dev)[:, None] < deg[None, :]).to(torch.float32)
    idx = torch.clamp(neigh, max=max(V - 1, 0))  # pad rows masked by valid
    cnt = torch.clamp(deg.to(torch.float32), min=1.0)
    v = verts3v
    for _ in range(steps):
        for factor in (_f32(lam, dev), _f32(mu, dev)):
            diff = (v[:, None, :] - v[:, idx]) * valid[None]
            d = torch.sum(diff, dim=1) / cnt[None]
            v = v + factor * (weights[None] * d)
    return v


def ca_smoothing_device(dm, t: float = 0.7, tmax: float = 3.0,
                        bmin: float = 0.5, n_iters: int = 10) -> torch.Tensor:
    """Context-aware smoothing over a ``marching.DeviceMesh``; returns the
    smoothed (3, V) world verts on the mesh's device."""
    verts3v = dm.verts3v
    dev = verts3v.device
    normals3f = face_normals_3t(verts3v, dm.faces3t)
    flagged = staircase_flags(normals3f, dm.faces3t, dm.n_verts, t)
    neigh, deg = adjacency_from_device_mesh(dm)
    sx, sy, sz = dm.spacing
    ox, oy, oz = dm.origin_shift
    vox3v = torch.stack([(verts3v[2] - oz) / sz, (verts3v[1] - oy) / sy,
                         (verts3v[0] - ox) / sx])  # (3 zyx, V)
    steps = min(16, int(np.ceil(tmax / min(dm.spacing))))
    grid = _rasterize_seeds(vox3v, flagged, dm.vol_shape)
    grid = _chamfer(grid, (sz, sy, sx), steps)
    weights = _grid_weights(grid, vox3v, _f32(tmax, dev), _f32(bmin, dev))
    return taubin_smooth(verts3v, neigh, deg, weights, 0.5, -0.53, n_iters)

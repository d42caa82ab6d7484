"""Voronoi labeling over voxel grids: jump flooding (JFA) and
floodfill-Voronoi (port of invesalius3_tpu/ops/voronoi.py).

Reference: invesalius_rs/src/floodfill.rs ``jump_flooding_internal`` :298
(27-neighbour JFA with halving offsets; the optional normalization that
recentres each basin on its centroid and scales its distances to [0, 1])
and ``floodfill_voronoi_inplace`` :239.

Each round with offset ``step`` looks at the 26 voxels ``step`` away in the
fixed (dz, dy, dx) order and takes a candidate owner whose site is strictly
nearer, so ties keep the earlier owner, as in the JAX package.  Site and
voxel coordinates are integers, so every squared distance is an exact
float32 integer, whatever order the sums take; up to 1182 voxels a side
the squares order exactly as the JAX package's float32 distances, so the
rounds compare squares and the distances (square roots rounded once)
equal the JAX package's bit for bit.

The rounds run on ``device`` (the card unless the caller passes "cpu") in
z-slabs of at most ``_SLAB_VOXELS`` voxels, reading the previous round's
owners and writing the next: at 512^3 the owners (int32) and distances
(float32) take 512 MiB each and the slab temporaries a few hundred MiB.
The normalization pass and the Manhattan distance are host numpy, as in
the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from invesalius3_tpu_torch.ops.morphology import shift_nd

_INF = 3.0e38
_SLAB_VOXELS = 1 << 24
_SQUARES_BELOW = 1 << 22  # squared distances that order as their float32 roots


def _steps(max_dim: int):
    k = 1
    while k < max_dim:
        k *= 2
    k //= 2
    out = []
    while k >= 1:
        out.append(k)
        k //= 2
    return out


def _shape_of(shape_vol) -> Tuple[int, int, int]:
    shape = shape_vol.shape if hasattr(shape_vol, "shape") else shape_vol
    return tuple(int(s) for s in shape)


def _sqrt(d2: torch.Tensor) -> torch.Tensor:
    """float32 square roots rounded once, the same on the card and the CPU
    (the card's float32 sqrt can be an ulp off)."""
    return torch.sqrt(d2.double()).float()


def _shifted_slab(owners: torch.Tensor, z0: int, z1: int, off) -> torch.Tensor:
    """Rows z0..z1 of ``shift_nd(owners, off, fill=0)``."""
    dz, dy, dx = off
    Z = owners.shape[0]
    out = torch.zeros((z1 - z0,) + tuple(owners.shape[1:]), dtype=owners.dtype,
                      device=owners.device)
    s0, s1 = max(z0 - dz, 0), min(z1 - dz, Z)
    if s0 < s1:
        out[s0 + dz - z0:s1 + dz - z0] = shift_nd(owners[s0:s1], (0, dy, dx), fill=0)
    return out


def jump_flooding(shape_vol, sites, device=DEFAULT_DEVICE
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(owners int32 (Z, Y, X), distance float32) on ``device``: owners are
    1-based site indices (the reference's convention), 0 unclaimed; the
    distance is to the owner's site, 3e38 where unclaimed.  ``shape_vol``
    is a (Z, Y, X) shape or anything with that ``.shape``; ``sites`` (S, 3)
    integer (z, y, x), rows outside the volume ignored."""
    dev = resolve_device(device)
    Z, Y, X = _shape_of(shape_vol)
    s = as_tensor(sites, dev, torch.int32).reshape(-1, 3)
    valid = ((s[:, 0] >= 0) & (s[:, 0] < Z) & (s[:, 1] >= 0) & (s[:, 1] < Y)
             & (s[:, 2] >= 0) & (s[:, 2] < X))
    zero = torch.zeros_like(s[:, 0])
    lin = ((torch.where(valid, s[:, 0], zero).long() * Y + torch.where(valid, s[:, 1], zero))
           * X + torch.where(valid, s[:, 2], zero))
    ids = torch.where(valid, torch.arange(1, s.shape[0] + 1, dtype=torch.int32, device=dev),
                      zero)
    owners = torch.zeros(Z * Y * X, dtype=torch.int32, device=dev)
    dist = torch.full((Z * Y * X,), _INF, dtype=torch.float32, device=dev)
    owners.scatter_reduce_(0, lin, ids, "amax", include_self=True)
    seed_d = torch.where(valid, torch.zeros((), device=dev), torch.full((), _INF, device=dev))
    dist.scatter_reduce_(0, lin, seed_d, "amin", include_self=True)
    owners, dist = owners.reshape(Z, Y, X), dist.reshape(Z, Y, X)

    site_pos = s.to(torch.float32)
    pz_t, py_t, px_t = site_pos[:, 0], site_pos[:, 1], site_pos[:, 2]
    yy = torch.arange(Y, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(X, dtype=torch.float32, device=dev)[None, None, :]
    inf = torch.full((), _INF, dtype=torch.float32, device=dev)
    rows = max(1, _SLAB_VOXELS // max(Y * X, 1))

    # below 2^22 the squared distances order as their float32 square roots
    # (the gap between the roots of two such integers exceeds an ulp), so
    # the rounds compare squares and take the roots once at the end
    compare_squares = 3 * (max(Z, Y, X) - 1) ** 2 < _SQUARES_BELOW

    def site_dist(owner: torch.Tensor, zz: torch.Tensor) -> torch.Tensor:
        idx = torch.clamp(owner - 1, min=0)
        dz, dy, dx = zz - pz_t[idx], yy - py_t[idx], xx - px_t[idx]
        d2 = dz * dz + dy * dy + dx * dx
        return torch.where(owner > 0, d2 if compare_squares else _sqrt(d2), inf)

    for step in _steps(max(Z, Y, X)):
        new_owners = torch.empty_like(owners)
        for z0 in range(0, Z, rows):
            z1 = min(z0 + rows, Z)
            zz = torch.arange(z0, z1, dtype=torch.float32, device=dev)[:, None, None]
            best_owner = owners[z0:z1].clone()
            best_dist = site_dist(best_owner, zz)
            for dz in (-step, 0, step):
                for dy in (-step, 0, step):
                    for dx in (-step, 0, step):
                        if dz == dy == dx == 0:
                            continue
                        cand = _shifted_slab(owners, z0, z1, (dz, dy, dx))
                        cand_dist = site_dist(cand, zz)
                        take = cand_dist < best_dist
                        best_owner = torch.where(take, cand, best_owner)
                        best_dist = torch.where(take, cand_dist, best_dist)
            new_owners[z0:z1] = best_owner
            dist[z0:z1] = best_dist
        owners = new_owners
    if compare_squares:
        dist = _sqrt(dist)
    return owners, torch.where(owners > 0, dist, inf)


def jump_flooding_normalized(shape_vol, sites, device=DEFAULT_DEVICE
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """JFA + the reference's ``normalize`` post-pass (floodfill.rs:421-503),
    on the host: per basin, the distance to its (integer) centroid scaled
    to [0, 1]."""
    owners, _ = jump_flooding(shape_vol, sites, device)
    owners_np = owners.cpu().numpy()
    Z, Y, X = owners_np.shape
    zz, yy, xx = np.mgrid[:Z, :Y, :X]
    n_sites = len(sites)
    dist = np.zeros(owners_np.shape, np.float32)
    for i in range(1, n_sites + 1):
        sel = owners_np == i
        if not sel.any():
            continue
        cz, cy, cx = (int(zz[sel].mean()), int(yy[sel].mean()), int(xx[sel].mean()))
        d = np.sqrt((zz[sel] - cz) ** 2 + (yy[sel] - cy) ** 2 + (xx[sel] - cx) ** 2)
        mx = d.max()
        dist[sel] = d / mx if mx > 0 else 0.0
    return owners_np, dist


def floodfill_voronoi(data_shape: Tuple[int, int, int], seeds_zyx, distance_fn: int = 0,
                      device=DEFAULT_DEVICE) -> Tuple[np.ndarray, np.ndarray]:
    """Voronoi by JFA (the reference's floodfill_voronoi computes the same
    partition with a stack walk); host (owners int32, distance float32):
    ``distance_fn`` 0 the squared Euclidean, 1 the Manhattan distance to the
    owner's site."""
    seeds = np.asarray(seeds_zyx)
    owners, dist = jump_flooding(data_shape, seeds.astype(np.int32), device)
    owners_np = owners.cpu().numpy()
    if distance_fn == 0:
        return owners_np, dist.cpu().numpy() ** 2
    Z, Y, X = data_shape
    zz, yy, xx = np.mgrid[:Z, :Y, :X]
    idx = np.maximum(owners_np - 1, 0)
    d = (np.abs(zz - seeds[idx, 0]) + np.abs(yy - seeds[idx, 1])
         + np.abs(xx - seeds[idx, 2])).astype(np.float32)
    return owners_np, d

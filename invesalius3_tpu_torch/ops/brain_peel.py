"""Brain peeling: N inward cortical "peel" surfaces textured with image
intensity, the cortex a TMS operator navigates on (port of
invesalius3_tpu/ops/brain_peel.py).

Reference: invesalius/data/brainmesh_handler.py ``Brain`` :49.  Peel 0 is
the mask's isosurface through downsample -> smooth -> upsample -> smooth;
each later peel re-downsamples, warps the surface ``peel_depth_mm`` inward
along its vertex normals, upsamples and smooths (``SliceDown`` :200-219).
Every peel carries the image's intensity at its vertices
(``MapImageOnCurrentPeel`` :238).

``regularize="remesh"`` (the default) runs that chain with array stages:
``cluster_remesh`` (3000 clusters), Taubin smoothing (lambda 0.5, mu -0.53),
``subdivide_linear`` (two passes) and ``warp_along_normals``.  ``"volume"``
erodes the mask and takes the isosurface of its low-passed occupancy;
``"none"`` erodes the mask and takes its raw isosurface.

Device work (marching, adjacency, Taubin, erosion, intensity) runs on
``device``, the card unless the caller passes "cpu"; the remesh stages are
host numpy, as in the JAX package.

Taubin runs in the order XLA's CPU code evaluates the JAX package's
compiled loop: the one-ring sum in row order, a true division by the
degree, and ``v + factor * d`` as one fused multiply-add
(``ops/xla_float``).  ``cluster_remesh`` floors coordinates into cells, so
a vertex that moved by one ulp could change cluster and every later peel;
in this order the smoothed vertices equal the JAX package's bit for bit on
the CPU whenever the one-ring table has at most 16 rows (no vertex of more
than 16 incident corners, as on every peel so far).  XLA sums wider tables
in another order, and the results then agree within float32 rounding.

Departure: the port's marching mesh has no padding "orphan" vertex.  The
JAX peel keeps that vertex, unused by any face, at world ``(-sx, -sy,
-sz)`` through every stage, and it anchors the JAX ``cluster_remesh`` grid
(its ``lo``).  Here the grid is anchored at the surface's own minimum.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from invesalius3_tpu_torch.ops import marching, mesh as mesh_ops
from invesalius3_tpu_torch.ops.filters import gaussian
from invesalius3_tpu_torch.ops.morphology import binary_erosion, brush_element, pad_const
from invesalius3_tpu_torch.ops.reslice import trilinear
from invesalius3_tpu_torch.ops.resize import resize_volume
from invesalius3_tpu_torch.ops.xla_float import fma

_N_CLUSTERS = 3000      # reference downsample() cluster count
_SUBDIVISIONS = 2       # reference upsample() SetNumberOfSubdivisions(2)
_SMOOTH_ITERS = 20      # reference smooth() SetNumberOfIterations(20)


def _u8(vis: torch.Tensor) -> torch.Tensor:
    """A bool mask as the uint8 0 / 255 mask ``mask_to_surface`` takes."""
    return vis.to(torch.uint8) * 255


def _ring_sum(terms):
    """The one-ring sum in row order, as XLA's CPU loop sums a table of at
    most 16 rows."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def taubin_xla_order(verts: np.ndarray, faces: np.ndarray, iters: int,
                     device, lam: float = 0.5, mu: float = -0.53) -> np.ndarray:
    """Unweighted Taubin smoothing of a host mesh on ``device``, in XLA's
    CPU order (module docstring); (V, 3) float32 on the host."""
    neigh, deg = mesh_ops.vertex_adjacency_fast(faces, len(verts), device=device)
    neigh = neigh.t().long()  # (D, V), pad rows = the vertex itself
    D = neigh.shape[0]
    valid = (torch.arange(D, device=device)[:, None] < deg[None, :]).to(torch.float32)
    cnt = torch.clamp(deg.to(torch.float32), min=1.0)
    v = as_tensor(np.asarray(verts, np.float32), device).t().contiguous()

    def ring_mean(v):
        diff = (v[:, None, :] - v[:, neigh]) * valid[None]
        return _ring_sum([diff[:, j] for j in range(D)]) / cnt[None]

    for _ in range(iters):
        for factor in (lam, mu):
            v = fma(np.float32(factor), ring_mean(v), v)
    return v.t().cpu().numpy()


class Brain:
    """Peeled cortex surfaces (reference brainmesh_handler.Brain).

    ``peels`` is a list of dicts: ``verts`` (V, 3) float32 world mm,
    ``faces`` (F, 3) int32, ``intensity`` (V,) float32, ``depth_mm``.
    ``times`` holds the seconds spent in each stage, summed over peels."""

    def __init__(self, image, mask, spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                 n_peels: int = 5, peel_depth_mm: float = 1.0,
                 smooth_iters: int = _SMOOTH_ITERS, regularize: str | bool = "remesh",
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.image = as_tensor(image, self.device)
        self.spacing = spacing
        self.n_peels = n_peels
        if regularize is True:
            regularize = "volume"
        elif regularize is False:
            regularize = "none"
        self.regularize = regularize
        self.peels: List[dict] = []
        self.times: Dict[str, float] = {}
        self._build(as_tensor(mask, self.device) > 127, peel_depth_mm, smooth_iters)

    def _timed(self, stage: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.times[stage] = self.times.get(stage, 0.0) + time.perf_counter() - t0
        return out

    # -- volume-space path ------------------------------------------------

    def _occupancy_surface(self, vis: torch.Tensor):
        """Isosurface of the low-passed occupancy field: mean-pool 2x ->
        gaussian (sigma one coarse voxel) -> trilinear upsample -> marching
        at occupancy 0.5 of a uint8 field."""
        occ = vis.to(torch.float32)
        coarse_shape = tuple(max(2, s // 2) for s in occ.shape)
        occ = resize_volume(occ, coarse_shape)
        occ = gaussian(occ, sigma=1.0)
        occ = resize_volume(occ, tuple(vis.shape))
        field = torch.clamp(occ * 255.0, 0.0, 255.0).to(torch.uint8)
        field = pad_const(field, [(1, 1)] * 3, 0)
        sx, sy, sz = self.spacing
        dm = marching.marching_cubes_device(field, 127.5, self.spacing,
                                            origin_shift=(-sx, -sy, -sz))
        return marching.mesh_to_host(dm, fp16=False)

    # -- the mesh-space chain -----------------------------------------------

    def _smooth(self, verts, faces, iters):
        if iters <= 0 or len(verts) < 5:
            return verts
        return self._timed("smooth", taubin_xla_order, verts, faces, iters, self.device)

    def _refine(self, verts, faces, smooth_iters):
        """upsample -> smooth (the common tail of the first surface and of
        SliceDown)."""
        verts, faces = self._timed("subdivide", mesh_ops.subdivide_linear, verts, faces,
                                   _SUBDIVISIONS)
        verts = self._smooth(verts, faces, smooth_iters)
        return verts, faces

    def _slice_down(self, verts, faces, depth_mm, smooth_iters):
        """One inward peel step (reference SliceDown :200-219)."""
        verts, faces = self._timed("cluster", mesh_ops.cluster_remesh, verts, faces,
                                   _N_CLUSTERS)
        if len(faces) == 0:
            return verts, faces
        verts = self._timed("warp", mesh_ops.warp_along_normals, verts, faces, -depth_mm)
        return self._refine(verts, faces, smooth_iters)

    def _add_peel(self, verts, faces, depth_mm: float) -> None:
        self.peels.append({
            "verts": np.asarray(verts, np.float32),
            "faces": np.asarray(faces, np.int32),
            "intensity": self._timed("intensity", self.sample_intensity, verts),
            "depth_mm": depth_mm,
        })

    def _build(self, vis: torch.Tensor, depth_mm: float, smooth_iters: int) -> None:
        if self.regularize == "remesh":
            verts, faces = self._timed("marching", marching.mask_to_surface, _u8(vis),
                                       self.spacing, self.device)
            if len(faces) == 0:
                return
            verts, faces = self._timed("cluster", mesh_ops.cluster_remesh, verts, faces,
                                       _N_CLUSTERS)
            verts = self._smooth(verts, faces, smooth_iters)
            verts, faces = self._refine(verts, faces, smooth_iters)
            for k in range(self.n_peels):
                if len(faces) == 0:
                    break
                self._add_peel(verts, faces, k * depth_mm)
                verts, faces = self._slice_down(verts, faces, depth_mm, smooth_iters)
            return

        strct = brush_element(depth_mm, self.spacing, "circle", dims=3)
        current = vis
        for k in range(self.n_peels):
            if not bool(torch.any(current)):
                break
            if self.regularize == "volume":
                verts, faces = self._timed("marching", self._occupancy_surface, current)
            else:
                verts, faces = self._timed("marching", marching.mask_to_surface,
                                           _u8(current), self.spacing, self.device)
            if len(faces) == 0:
                break
            if len(verts) > 4:
                verts = self._smooth(verts, faces, min(4, smooth_iters))
            self._add_peel(verts, faces, k * depth_mm)
            current = self._timed("erosion", binary_erosion, current, strct)

    def sample_intensity(self, verts_world: np.ndarray) -> np.ndarray:
        """Texture: the image trilinearly sampled at the vertices (world mm
        (x, y, z) -> voxel (z, y, x)), reference MapImageOnCurrentPeel
        (brainmesh_handler.py:238); (V,) float32 on the host."""
        sx, sy, sz = self.spacing
        v = np.asarray(verts_world)
        x, y, z = (as_tensor(v[:, c] / s, self.device) for c, s in enumerate((sx, sy, sz)))
        return trilinear(self.image, x, y, z).cpu().numpy()

    def get_peel(self, level: int) -> dict:
        return self.peels[min(level, len(self.peels) - 1)]

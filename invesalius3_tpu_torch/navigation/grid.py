"""Stimulation-grid generation: rectangular / circular grids of coil
targets around a reference marker, projected onto the scalp surface.

Reference: invesalius/data/markers/grid_generator.py — ``GridGenerator``
:35 (``generate_rectangular_grid`` :46, ``generate_circular_grid`` :102,
``_create_grid_point`` :151, ``_move_marker`` :204 with the marker-space
y-inversion, ``_project_to_scalp`` :243 with radius-averaged normals and
the ``90 + z_rotation`` coil-frame offset) and
invesalius/data/markers/surface_geometry.py (closest-point + normal
queries on the smoothed scalp).

Port of invesalius3_tpu/navigation/grid.py.  The reference loops a
vtkPointLocator per grid point; here every grid point's nearest-vertex
query and radius-averaged normal is batched over the grid
(``ScalpGeometry.project``) in float64 numpy on the host, with the JAX
module's arithmetic, so the chosen vertices (``argmin``'s first minimum)
and normals are the JAX module's.  The query blocks hold at most
``PROJECT_BLOCK`` distances (1024 rows as in the JAX module on a small
mesh, fewer on a real scalp, where the JAX module's 1024 x V float64 block
takes GBs); a distance does not depend on the block it is computed in.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from invesalius3_tpu_torch.navigation.markers import Marker, MarkerType
from invesalius3_tpu_torch.ops import transforms as tr

# Guard against accidental creation of excessive markers
# (reference grid_generator.py:32 MAX_GRID_DIMENSION).
MAX_GRID_DIMENSION = 100

# query rows x scalp vertices per block of ScalpGeometry.project
PROJECT_BLOCK = 1 << 22


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (scatter-add of face normals)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.where(n > 0, n, 1.0)


class ScalpGeometry:
    """Closest-point / smoothed-normal queries on the scalp mesh
    (reference surface_geometry.py GetSmoothedScalpSurface consumer API),
    vectorized over query batches."""

    def __init__(self, verts: np.ndarray, faces: Optional[np.ndarray] = None,
                 normals: Optional[np.ndarray] = None):
        self.verts = np.asarray(verts, np.float64)
        if normals is None:
            if faces is None:
                raise ValueError("need faces or precomputed normals")
            normals = vertex_normals(self.verts, faces)
        self.normals = np.asarray(normals, np.float64)

    def project(self, points: np.ndarray, smooth_radius: float = 15.0
                ) -> Tuple[np.ndarray, np.ndarray]:
        """For each query point: nearest scalp vertex and the normal
        averaged over all vertices within ``smooth_radius`` of it
        (reference grid_generator.py:243-298)."""
        pts = np.atleast_2d(np.asarray(points, np.float64))  # (G, 3)
        # (g, V) distance blocks of at most PROJECT_BLOCK entries
        b = int(min(1024, max(1, PROJECT_BLOCK // max(1, len(self.verts)))))
        closest = np.empty(len(pts), np.int64)
        for s in range(0, len(pts), b):
            d = np.linalg.norm(self.verts[None] - pts[s:s + b, None], axis=2)
            closest[s:s + b] = np.argmin(d, axis=1)
        cpts = self.verts[closest]  # (G, 3)
        # radius-averaged normals around each closest point
        avg = np.empty_like(cpts)
        for s in range(0, len(cpts), b):
            d = np.linalg.norm(self.verts[None] - cpts[s:s + b, None], axis=2)
            w = (d <= smooth_radius).astype(np.float64)  # (g, V)
            acc = w @ self.normals
            nn = np.linalg.norm(acc, axis=1, keepdims=True)
            fallback = self.normals[closest[s:s + b]]
            avg[s:s + b] = np.where(nn > 1e-12, acc / np.where(nn > 0, nn, 1),
                                    fallback)
        return cpts, avg


def _pose_matrix(position, orientation_deg) -> np.ndarray:
    """Position + Euler degrees (sxyz) -> 4x4 (reference
    coordinates.py:582 coordinates_to_transformation_matrix)."""
    m = tr.euler_matrix(*np.radians(orientation_deg), axes="sxyz")
    m[:3, 3] = position
    return m


def _matrix_pose(m) -> Tuple[np.ndarray, np.ndarray]:
    return m[:3, 3].copy(), np.degrees(tr.euler_from_matrix(m, axes="sxyz"))


def move_marker(marker: Marker, displacement) -> None:
    """Displace a marker in its local frame; marker space has y inverted
    vs the 3-D view (reference grid_generator.py:204-242 _move_marker /
    marker_transformator.py:82 MoveMarker)."""
    pos = list(marker.position)
    pos[1] = -pos[1]
    m_new = _pose_matrix(pos, marker.orientation) @ _pose_matrix(
        displacement[:3], displacement[3:])
    new_pos, new_ori = _matrix_pose(m_new)
    new_pos[1] = -new_pos[1]
    marker.position = tuple(new_pos)
    marker.orientation = tuple(new_ori)


def _normal_to_euler_deg(normal: np.ndarray) -> np.ndarray:
    """Euler angles (sxyz, degrees) of the rotation taking +z onto
    ``normal`` — the coil points toward the brain (reference
    grid_generator.py:296-327)."""
    ref = np.array([0.0, 0.0, 1.0])
    axis = np.cross(ref, normal)
    na = np.linalg.norm(axis)
    if na < 1e-10:
        return np.zeros(3)
    ang = np.arccos(np.clip(np.dot(ref, normal) / np.linalg.norm(normal), -1, 1))
    axis = axis / na
    c, s = np.cos(ang), np.sin(ang)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    rot = np.eye(4)
    rot[:3, :3] = np.eye(3) + s * K + (1 - c) * (K @ K)
    return np.degrees(tr.euler_from_matrix(rot, axes="sxyz"))


class GridGenerator:
    """Grids of COIL_TARGET markers centred on a reference target,
    snapped to the scalp (reference grid_generator.py GridGenerator)."""

    def __init__(self, scalp: ScalpGeometry):
        self.scalp = scalp

    def generate_rectangular_grid(self, reference: Marker, rows: int,
                                  cols: int, spacing: float) -> List[Marker]:
        if rows > MAX_GRID_DIMENSION or cols > MAX_GRID_DIMENSION:
            raise ValueError(
                f"grid {rows}x{cols} exceeds {MAX_GRID_DIMENSION} per side")
        r0, c0 = (rows - 1) / 2.0, (cols - 1) / 2.0
        offs, labels = [], []
        for r in range(rows):
            for c in range(cols):
                if r == r0 and c == c0:  # centre is the reference itself
                    continue
                offs.append(((r - r0) * spacing, (c - c0) * spacing))
                labels.append(f"{reference.label} {r + 1}_{c + 1}")
        return self._make_points(reference, offs, labels)

    def generate_circular_grid(self, reference: Marker, rings: int,
                               points_per_ring: int, spacing: float
                               ) -> List[Marker]:
        if rings * points_per_ring > MAX_GRID_DIMENSION ** 2:
            raise ValueError("too many grid points")
        offs, labels = [], []
        for ring in range(1, rings + 1):
            rad = ring * spacing
            for k in range(points_per_ring):
                a = 2 * np.pi * k / points_per_ring
                offs.append((rad * np.cos(a), rad * np.sin(a)))
                labels.append(f"{reference.label} {ring}_{k + 1}")
        return self._make_points(reference, offs, labels)

    def _make_points(self, reference: Marker, offsets, labels) -> List[Marker]:
        """Displace in the reference's local frame, batch-project onto the
        scalp, orient tangentially, re-apply z_rotation and z_offset
        (reference grid_generator.py:151-203 _create_grid_point)."""
        if not offsets:  # e.g. a 1x1 grid is just the (skipped) centre
            return []
        markers = []
        for (dx, dy), label in zip(offsets, labels):
            m = Marker.from_dict(reference.to_dict())
            move_marker(m, [dx, dy, 0, 0, 0, 0])
            markers.append(m)
        # batched scalp projection (view space: y inverted)
        qpts = np.array([[p[0], -p[1], p[2]] for p in
                         (m.position for m in markers)])
        cpts, normals = self.scalp.project(qpts)
        for m, cp, nv in zip(markers, cpts, normals):
            m.position = (cp[0], -cp[1], cp[2])
            m.orientation = tuple(_normal_to_euler_deg(nv))
            # coil frame is rotated 90 deg about z vs world, plus the
            # user z_rotation (reference grid_generator.py:335-339)
            move_marker(m, [0, 0, 0, 0, 0, 90.0 + reference.z_rotation])
            if reference.z_offset:
                move_marker(m, [0, 0, reference.z_offset, 0, 0, 0])
        for m, label in zip(markers, labels):
            m.marker_type = MarkerType.COIL_TARGET
            m.label = label
            m.z_rotation = reference.z_rotation
            m.z_offset = reference.z_offset
            m.is_target = False
        return markers

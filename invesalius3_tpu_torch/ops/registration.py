"""Registration math: fiducial base change, FRE, object registration and
point-cloud ICP, the navigation geometry core (port of
invesalius3_tpu/ops/registration.py).

Reference: invesalius/data/bases.py ``base_creation`` :69, ``calculate_fre``
:111, ``object_registration`` :190; ICP applied at :174-189.

The setup-time calls are float64 numpy on the host, as in the JAX package
(the SVD's sign rule in ``estimate_rigid_transform`` is part of the
result).  ``apply_affine`` and the ICP's nearest-neighbour search run on
the points' device, the card unless the caller passes "cpu".  The search
is the expanded form |s|^2 - 2 s.t + |t|^2 in float32 with ``argmin``
taking the first of tied targets, as in the JAX package.  Its dot products
(and ``apply_affine``'s) are written out term by term, not as a matrix
product (no TF32, and the same rounding on the card as on the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from invesalius3_tpu_torch.ops import transforms as tr

_ICP_TARGET_CHUNK = 1 << 28  # distance-matrix entries computed at once


def base_creation(fiducials: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Base-change matrix from 3 fiducials (reference bases.py:69-108):
    (m, q), m the 3x3 base matrix and q the origin.  g1 = p1 - q (the
    axis through the ears), g2 = p3 - q, g3 = g2 x g1; q is the foot of p3
    on the line p1 p2."""
    p1, p2, p3 = np.asarray(fiducials, np.float64)
    sub1 = p2 - p1
    sub2 = p3 - p1
    lamb = float(sub1 @ sub2) / float(sub1 @ sub1)
    q = p1 + lamb * sub1
    g1 = p1 - q
    g2 = p3 - q
    if not g1.any():
        g1 = p2 - q
    g3 = np.cross(g2, g1)
    m = np.array([g1 / np.linalg.norm(g1), g2 / np.linalg.norm(g2),
                  g3 / np.linalg.norm(g3)]).T
    return m, q


def estimate_rigid_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares rigid transform (Kabsch, no scaling) mapping src points
    to dst points, a 4x4 float64 matrix: the fiducial-based tracker-to-image
    estimate (reference navigation.py:549)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    cs = src.mean(axis=0)
    cd = dst.mean(axis=0)
    H = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    m = np.eye(4)
    m[:3, :3] = R
    m[:3, 3] = cd - R @ cs
    return m


def calculate_fre(fiducials_raw: np.ndarray, fiducials_img: np.ndarray,
                  m_change: np.ndarray) -> float:
    """Fiducial registration error: RMS distance between the transformed
    tracker fiducials and the image fiducials (reference bases.py:111-140)."""
    errs = []
    for raw, img in zip(np.asarray(fiducials_raw), np.asarray(fiducials_img)):
        p = m_change @ np.append(raw[:3], 1.0)
        errs.append(np.sum((p[:3] - img[:3]) ** 2))
    return float(np.sqrt(np.mean(errs)))


def _dot3(a, b) -> torch.Tensor:
    """a0 b0 + a1 b1 + a2 b2 over the last axis, in that order: each step
    rounds as it does on the CPU, so the card and the CPU agree bit for
    bit (a matrix product sums in another order on each)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def apply_affine(m, points) -> torch.Tensor:
    """(4, 4) @ (N, 3) -> (N, 3) float32 with the homogeneous divide, on the
    points' device (a host array goes to the card)."""
    dev = points.device if isinstance(points, torch.Tensor) else resolve_device()
    pts = as_tensor(points, dev, torch.float32)
    m = as_tensor(m, dev, torch.float32)
    out = [_dot3(pts, m[r, :3]) + m[r, 3] for r in range(4)]
    return torch.stack(out[:3], dim=-1) / out[3][..., None]


def _nearest(src: torch.Tensor, tgt: torch.Tensor, tgt_sq: torch.Tensor):
    """(matched target points, distances, target indices) of each source
    point: argmin of |s|^2 - 2 s.t + |t|^2 over the targets in float32, the
    first target winning a tie.  The targets are taken in chunks; a later
    chunk replaces the running best only where strictly nearer."""
    src_sq = _dot3(src, src)[:, None]
    chunk = max(1, _ICP_TARGET_CHUNK // max(src.shape[0], 1))
    best = idx = None
    for t0 in range(0, tgt.shape[0], chunk):
        t = tgt[t0:t0 + chunk]
        d2 = src_sq - 2.0 * _dot3(src[:, None, :], t[None]) + tgt_sq[None, t0:t0 + chunk]
        m, i = torch.min(d2, dim=1)
        if best is None:
            best, idx = m, i
        else:
            take = m < best
            best = torch.where(take, m, best)
            idx = torch.where(take, i + t0, idx)
    return tgt[idx], torch.sqrt(torch.clamp(best, min=0.0)), idx


def icp(source: np.ndarray, target: np.ndarray, max_iterations: int = 50,
        tolerance: float = 1e-5, init: Optional[np.ndarray] = None,
        device=DEFAULT_DEVICE, history: Optional[list] = None) -> Tuple[np.ndarray, float]:
    """Point-to-point ICP refining source onto target (reference
    iterativeclosestpoint.py uses vtkIterativeClosestPointTransform): per
    iteration the nearest target of every moved source point on ``device``
    and a float64 Kabsch step on the host.  Returns (4x4 float64, the RMS
    error of the iteration before the last), and stops once the error
    changes by less than ``tolerance``, as the JAX package does.
    ``history``, when given, receives each iteration's matched target
    indices."""
    dev = resolve_device(device)
    src, tgt = (as_tensor(x, dev, torch.float32) for x in (source, target))
    tgt_sq = _dot3(tgt, tgt)
    m_total = np.eye(4) if init is None else np.asarray(init)
    cur = apply_affine(m_total, src)
    prev_err = np.inf
    for _ in range(max_iterations):
        matched, dists, idx = _nearest(cur, tgt, tgt_sq)
        if history is not None:
            history.append(idx.cpu().numpy())
        err = float(torch.sqrt(torch.mean(dists * dists)))
        m_step = estimate_rigid_transform(cur.cpu().numpy(), matched.cpu().numpy())
        m_total = m_step @ m_total
        cur = apply_affine(m_total, src)
        if abs(prev_err - err) < tolerance:
            break
        prev_err = err
    return m_total, prev_err


def object_registration(fiducials: np.ndarray, orients: np.ndarray, coord_raw: np.ndarray,
                        m_change: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Coil/object registration (reference bases.py:190-250): from 4 object
    fiducials (tracker space) and the reference sensor's pose, the object's
    fixed transforms the coregistration loop uses every frame.  Returns
    (t_obj_reference, r_s0_raw, s0_dyn, m_obj_raw)."""
    obj_fids = np.asarray(fiducials, np.float64)[:, :3]
    m, q = base_creation(obj_fids[:3])
    m_obj_raw = np.eye(4)
    m_obj_raw[:3, :3] = m.T
    m_obj_raw[:3, 3] = q
    a, b, g = np.radians(coord_raw[1, 3:])
    r_s0_raw = tr.euler_matrix(a, b, g, axes="rzyx")
    s0_trans = np.eye(4)
    s0_trans[:3, 3] = coord_raw[1, :3]
    s0_dyn = s0_trans @ r_s0_raw
    t_obj_reference = np.linalg.inv(s0_dyn) @ m_obj_raw
    return t_obj_reference, r_s0_raw, s0_dyn, m_obj_raw

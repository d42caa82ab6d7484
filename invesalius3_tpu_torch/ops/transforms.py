"""Rigid-body transform math: euler angles, quaternions, affine
compose/decompose (the port's own copy of invesalius3_tpu/ops/transforms.py,
numpy only; the tests hold the two equal).

Covers the subset of the vendored Gohlke ``transformations.py`` (reference
invesalius/data/transformations.py, 1961 LoC) that the reference actually
uses: euler_matrix / euler_from_matrix ('rzyx', 'sxyz' conventions),
quaternion_matrix / quaternion_from_matrix, translation and concatenation
helpers.  The euler routines follow Shoemake's Graphics Gems IV
formulation as popularized by Gohlke's canonical ``transformations.py``
(BSD) — bit-compatibility with the reference's euler conventions is a
requirement, so the axis-tuple encoding and cos/sin products match that
canonical algorithm.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# axis sequence tables (standard Shoemake encoding)
_NEXT_AXIS = [1, 2, 0, 1]
_AXES2TUPLE = {
    "sxyz": (0, 0, 0, 0), "sxyx": (0, 0, 1, 0), "sxzy": (0, 1, 0, 0),
    "sxzx": (0, 1, 1, 0), "syzx": (1, 0, 0, 0), "syzy": (1, 0, 1, 0),
    "syxz": (1, 1, 0, 0), "syxy": (1, 1, 1, 0), "szxy": (2, 0, 0, 0),
    "szxz": (2, 0, 1, 0), "szyx": (2, 1, 0, 0), "szyz": (2, 1, 1, 0),
    "rzyx": (0, 0, 0, 1), "rxyx": (0, 0, 1, 1), "ryzx": (0, 1, 0, 1),
    "rxzx": (0, 1, 1, 1), "rxzy": (1, 0, 0, 1), "ryzy": (1, 0, 1, 1),
    "rzxy": (1, 1, 0, 1), "ryxy": (1, 1, 1, 1), "ryxz": (2, 0, 0, 1),
    "rzxz": (2, 0, 1, 1), "rxyz": (2, 1, 0, 1), "rzyz": (2, 1, 1, 1),
}
_EPS = np.finfo(float).eps * 4.0


def euler_matrix(ai: float, aj: float, ak: float, axes: str = "sxyz") -> np.ndarray:
    """4x4 rotation matrix from Euler angles (Gohlke-compatible)."""
    firstaxis, parity, repetition, frame = _AXES2TUPLE[axes]
    i = firstaxis
    j = _NEXT_AXIS[i + parity]
    k = _NEXT_AXIS[i - parity + 1]

    if frame:
        ai, ak = ak, ai
    if parity:
        ai, aj, ak = -ai, -aj, -ak

    si, sj, sk = np.sin(ai), np.sin(aj), np.sin(ak)
    ci, cj, ck = np.cos(ai), np.cos(aj), np.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk

    M = np.eye(4)
    if repetition:
        M[i, i] = cj
        M[i, j] = sj * si
        M[i, k] = sj * ci
        M[j, i] = sj * sk
        M[j, j] = -cj * ss + cc
        M[j, k] = -cj * cs - sc
        M[k, i] = -sj * ck
        M[k, j] = cj * sc + cs
        M[k, k] = cj * cc - ss
    else:
        M[i, i] = cj * ck
        M[i, j] = sj * sc - cs
        M[i, k] = sj * cc + ss
        M[j, i] = cj * sk
        M[j, j] = sj * ss + cc
        M[j, k] = sj * cs - sc
        M[k, i] = -sj
        M[k, j] = cj * si
        M[k, k] = cj * ci
    return M


def euler_from_matrix(matrix: np.ndarray, axes: str = "sxyz") -> Tuple[float, float, float]:
    firstaxis, parity, repetition, frame = _AXES2TUPLE[axes]
    i = firstaxis
    j = _NEXT_AXIS[i + parity]
    k = _NEXT_AXIS[i - parity + 1]

    M = np.asarray(matrix, dtype=np.float64)[:3, :3]
    if repetition:
        sy = np.sqrt(M[i, j] * M[i, j] + M[i, k] * M[i, k])
        if sy > _EPS:
            ax = np.arctan2(M[i, j], M[i, k])
            ay = np.arctan2(sy, M[i, i])
            az = np.arctan2(M[j, i], -M[k, i])
        else:
            ax = np.arctan2(-M[j, k], M[j, j])
            ay = np.arctan2(sy, M[i, i])
            az = 0.0
    else:
        cy = np.sqrt(M[i, i] * M[i, i] + M[j, i] * M[j, i])
        if cy > _EPS:
            ax = np.arctan2(M[k, j], M[k, k])
            ay = np.arctan2(-M[k, i], cy)
            az = np.arctan2(M[j, i], M[i, i])
        else:
            ax = np.arctan2(-M[j, k], M[j, j])
            ay = np.arctan2(-M[k, i], cy)
            az = 0.0

    if parity:
        ax, ay, az = -ax, -ay, -az
    if frame:
        ax, az = az, ax
    return ax, ay, az


def quaternion_matrix(q: Sequence[float]) -> np.ndarray:
    """4x4 rotation from quaternion (w, x, y, z)."""
    q = np.asarray(q, dtype=np.float64)
    n = q @ q
    if n < _EPS:
        return np.eye(4)
    q = q * np.sqrt(2.0 / n)
    q = np.outer(q, q)
    return np.array(
        [
            [1.0 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0], 0.0],
            [q[1, 2] + q[3, 0], 1.0 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0], 0.0],
            [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1.0 - q[1, 1] - q[2, 2], 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


def quaternion_from_matrix(matrix: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion from a rotation matrix (Shepperd)."""
    M = np.asarray(matrix, dtype=np.float64)[:4, :4]
    t = np.trace(M[:3, :3])
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        w = 0.25 / s
        x = (M[2, 1] - M[1, 2]) * s
        y = (M[0, 2] - M[2, 0]) * s
        z = (M[1, 0] - M[0, 1]) * s
    else:
        i = int(np.argmax(np.diag(M[:3, :3])))
        j = (i + 1) % 3
        k = (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + M[i, i] - M[j, j] - M[k, k])
        vals = [0.0, 0.0, 0.0]
        vals[i] = 0.25 * s
        vals[j] = (M[j, i] + M[i, j]) / s
        vals[k] = (M[k, i] + M[i, k]) / s
        w = (M[k, j] - M[j, k]) / s
        x, y, z = vals
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def translation_matrix(direction: Sequence[float]) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = direction[:3]
    return m


def concatenate_matrices(*matrices: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    for mat in matrices:
        m = m @ mat
    return m

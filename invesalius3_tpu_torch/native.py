"""The port's host-side native decimator (port of
invesalius3_tpu/native/__init__.py ``decimate_qem``).

``csrc/decimate.cpp`` is a Garland-Heckbert QEM edge-collapse simplifier
replacing the reference's vtkQuadricDecimation (surface_process.py:350-372).
It is built by ``_build`` with g++ at first use; a failed build raises, and
nothing falls back to another algorithm.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from invesalius3_tpu_torch import _build


def decimate_qem(verts: np.ndarray, faces: np.ndarray,
                 reduction: float) -> Tuple[np.ndarray, np.ndarray]:
    """QEM edge-collapse decimation to (1 - reduction) of the input
    triangle count (at least 4); returns compacted (verts, faces)."""
    lib = _build.decimate_lib()
    verts = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    faces = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    if len(faces) and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("decimate_qem: face index out of range")
    target = max(4, int(len(faces) * (1.0 - reduction)))
    out_v = np.empty_like(verts)
    out_f = np.empty_like(faces)
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    rc = lib.decimate_qem(verts.ctypes.data, len(verts), faces.ctypes.data,
                          len(faces), target, out_v.ctypes.data,
                          out_f.ctypes.data, ctypes.addressof(nv),
                          ctypes.addressof(nf))
    if rc != 0:
        raise RuntimeError(f"decimate_qem failed with code {rc}")
    return out_v[: nv.value].copy(), out_f[: nf.value].copy()

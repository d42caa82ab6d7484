"""The port's host-side native decimator and DICOM decoders (port of
invesalius3_tpu/native/__init__.py ``decimate_qem``, ``jpegll_decode`` and
``packbits_decode``).

``csrc/decimate.cpp`` is a Garland-Heckbert QEM edge-collapse simplifier
replacing the reference's vtkQuadricDecimation (surface_process.py:350-372).
``csrc/codecs.cpp`` decodes lossless JPEG (process 14) frames and PackBits
(DICOM RLE) segments.  Each is built by ``_build`` with g++ at first use; a
failed build raises, and nothing falls back to another implementation.
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


def jpegll_decode(data: bytes) -> np.ndarray:
    """Decode one lossless-JPEG (SOF3) frame -> (rows, cols) or
    (rows, cols, ncomp) uint16.  Raises RuntimeError on a bad stream."""
    lib = _build.codecs_lib()
    src = np.frombuffer(data, np.uint8)
    # the JAX package's capacity: the compressed length's bound or 2^22
    # samples, whichever is larger
    cap = max(len(data) * 8, 1 << 22)
    out = np.empty(cap, np.uint16)
    dims = np.zeros(3, np.int32)  # rows, cols, ncomp
    rc = lib.jpegll_decode(src.ctypes.data, len(src), out.ctypes.data, cap,
                           dims[0:].ctypes.data, dims[1:].ctypes.data,
                           dims[2:].ctypes.data)
    if rc != 0:
        raise RuntimeError(f"jpegll_decode failed with code {rc}")
    rows, cols, ncomp = (int(d) for d in dims)
    arr = out[: rows * cols * ncomp].copy()
    if ncomp > 1:
        return arr.reshape(rows, cols, ncomp)
    return arr.reshape(rows, cols)


def packbits_decode(data: bytes, expected: int) -> bytes:
    """Decode one PackBits-compressed RLE segment to at most ``expected``
    bytes."""
    lib = _build.codecs_lib()
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(expected, np.uint8)
    n = lib.packbits_decode(src.ctypes.data, len(src), dst.ctypes.data, expected)
    return dst[:n].tobytes()

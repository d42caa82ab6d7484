"""Binary STL export of a device mesh (port of
invesalius3_tpu/io/mesh_io.py ``write_stl_from_device``).

The vertices round through float16 on the device (``marching.mesh_to_host``),
as the JAX package's packed transfer does, so the records are
byte-identical to its writer on the same vertices.  The mesh comes to the
host in one synchronous copy (the JAX package's producer threads hid a slow
device link) and the records are packed by the port's native packer
(``csrc/meshpack.cpp``, the same arithmetic as the JAX package's).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from invesalius3_tpu_torch import _build
from invesalius3_tpu_torch.ops import marching


def stl_records(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(F, 50)-byte binary-STL records (normal, 3 corners, attribute 0)."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    out = np.empty((len(faces), 50), np.uint8)
    rc = _build.meshpack_lib().stl_pack_mt(
        verts.ctypes.data, len(verts), faces.ctypes.data, len(faces),
        out.ctypes.data, min(os.cpu_count() or 1, 16))
    if rc != 0:
        raise RuntimeError("stl_pack: face index out of range")
    return out


def write_stl_from_device(path, dm, name: str = "invesalius3_tpu") -> None:
    """Write a ``marching.DeviceMesh`` as a binary STL."""
    records = stl_records(*marching.mesh_to_host(dm))
    with open(path, "wb") as f:
        f.write((name.encode()[:80]).ljust(80, b"\0"))
        f.write(struct.pack("<I", dm.n_tris))
        f.write(records)

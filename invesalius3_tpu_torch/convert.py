"""Numpy bridge: inputs onto a device, outputs back to the host, and the
JAX package's device mesh carried over into the port's.

The system runs no model; its "weights" are its inputs and the state one
stage hands the next.  This module moves that state across, so each port
stage can be fed the JAX stage's exact input.  It never imports jax:
anything array-like goes through ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from invesalius3_tpu_torch.ops.marching import DeviceMesh


def to_device(array, device="cpu") -> torch.Tensor:
    """A numpy (or array-like) volume, marker grid or table as a tensor on
    ``device``, dtype preserved."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(array))).to(device)


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy()


def from_jax_mesh(jm, device="cpu") -> DeviceMesh:
    """The port's ``DeviceMesh`` equal to a JAX ``marching.DeviceMesh``.

    The JAX mesh is sized to buckets: faces and corners past ``n_tris`` are
    padding, and when there is padding its slots (key -1) sort first and
    form one orphan vertex, id 0.  This drops the padding and the orphan
    and shifts every vertex id down by one in that case.  Corner ids
    m = c * T_pad + t become c * n_tris + t.
    """
    n_tris = int(jm.n_tris)
    n_verts = int(jm.n_verts)
    faces3t = np.asarray(jm.faces3t)
    T_pad = faces3t.shape[1]
    sorted_valid = np.asarray(jm.sorted_valid)
    shift = 0 if sorted_valid.size == 0 or sorted_valid[0] else 1
    n_pad_corners = 3 * (T_pad - n_tris)

    order = np.asarray(jm.order).astype(np.int64)[n_pad_corners:]
    order = (order // T_pad) * n_tris + order % T_pad
    gos = np.asarray(jm.group_of_sorted).astype(np.int64)[n_pad_corners:] - shift
    inverse = (np.asarray(jm.inverse).astype(np.int64).reshape(3, T_pad)
               [:, :n_tris].reshape(-1) - shift)
    return DeviceMesh(
        verts3v=to_device(np.asarray(jm.verts3v)[:, shift:n_verts], device),
        faces3t=to_device(faces3t[:, :n_tris].astype(np.int32) - shift, device),
        inverse=to_device(inverse, device),
        order=to_device(order, device),
        group_of_sorted=to_device(gos, device),
        spacing=tuple(jm.spacing), vol_shape=tuple(jm.vol_shape),
        origin_shift=tuple(jm.origin_shift))


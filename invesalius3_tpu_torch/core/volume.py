"""The voxel volume on a device (port of invesalius3_tpu/core/volume.py).

``Volume`` is a frozen dataclass: ``data`` is a (Z, Y, X) tensor on its
device (a 512^3 int16 CT is 256 MiB); spacing, affine, modality and window
are host metadata.  No pytree: PyTorch needs none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class Volume:
    """A 3D scalar volume.

    Attributes:
      data: (Z, Y, X) tensor of voxel intensities (typically int16 HU).
      spacing: (sx, sy, sz) voxel size in mm, X-first like the reference's
        ``Slice.spacing``.
      affine: optional 4x4 voxel-index -> world (mm, RAS) matrix.
      modality: e.g. "CT", "MR".
      window_width / window_level: current display window.
    """

    data: torch.Tensor
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    affine: Optional[np.ndarray] = None
    modality: str = "CT"
    window_width: float = 255.0
    window_level: float = 127.5

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(int(s) for s in self.data.shape)  # type: ignore[return-value]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @classmethod
    def from_numpy(cls, array: np.ndarray,
                   spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                   affine: Optional[np.ndarray] = None, modality: str = "CT",
                   device=DEFAULT_DEVICE, **kw) -> "Volume":
        """The volume of ``array`` on ``device`` (the card unless "cpu").
        A read-only array (a file's bytes) is copied, so the tensor never
        aliases memory it may not own."""
        device = resolve_device(device)
        a = np.ascontiguousarray(array)
        if not a.flags.writeable:
            a = a.copy()
        return cls.from_tensor(torch.from_numpy(a).to(device), spacing=spacing,
                               affine=affine, modality=modality, **kw)

    @classmethod
    def from_tensor(cls, data: torch.Tensor,
                    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                    affine: Optional[np.ndarray] = None, modality: str = "CT",
                    **kw) -> "Volume":
        """The volume of a tensor where it lies, without a copy."""
        if affine is None:
            affine = default_affine(tuple(data.shape), spacing)
        return cls(data=data, spacing=tuple(spacing), affine=affine,
                   modality=modality, **kw)

    def to_numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    def replace(self, **kw) -> "Volume":
        return dataclasses.replace(self, **kw)

    def voxel_to_world(self, zyx: np.ndarray) -> np.ndarray:
        """Map (N, 3) voxel indices (z, y, x) to world mm via the affine."""
        aff = self.affine if self.affine is not None else default_affine(self.shape, self.spacing)
        pts = np.asarray(zyx, dtype=np.float64)
        homo = np.concatenate([pts[..., ::-1], np.ones(pts.shape[:-1] + (1,))], axis=-1)
        return (homo @ aff.T)[..., :3]

    def world_to_voxel(self, xyz: np.ndarray) -> np.ndarray:
        aff = self.affine if self.affine is not None else default_affine(self.shape, self.spacing)
        inv = np.linalg.inv(aff)
        pts = np.asarray(xyz, dtype=np.float64)
        homo = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], axis=-1)
        return (homo @ inv.T)[..., :3][..., ::-1]

    def min_max(self) -> Tuple[float, float]:
        lo, hi = torch.aminmax(self.data)
        return (float(lo), float(hi))


def default_affine(shape, spacing) -> np.ndarray:
    """Scale-only affine: x_world = x_index * sx etc. (x, y, z order)."""
    sx, sy, sz = spacing
    return np.diag([sx, sy, sz, 1.0])

"""Volume resampling / resizing for the surface-quality presets (port of
invesalius3_tpu/ops/resize.py).

Reference: invesalius/data/imagedata_utils.py:50-131 (resize_image /
image_resize).  Nearest (order 0) as three index selections, trilinear
(order 1) through ``reslice.trilinear`` in z-slabs, both on the volume's
device and endpoint-aligned like scipy.ndimage.zoom.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.ops.casting import cast_like_jax
from invesalius3_tpu_torch.ops.reslice import slab_rows, trilinear
from invesalius3_tpu_torch.ops.xla_float import recip


def _axis_coords(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jnp.linspace(0, n_in - 1, n_out)`` bit for bit: XLA evaluates it as
    ``(stop * (1 / (n_out - 1))) * i`` in float32, the last entry ``stop``."""
    if n_out == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    stop = np.float32(n_in - 1)
    step = stop * np.float32(recip(n_out - 1))
    c = np.append(np.arange(n_out - 1, dtype=np.float32) * step, stop)
    return torch.from_numpy(c.astype(np.float32)).to(device)


def resize_volume(volume: torch.Tensor, out_shape: Tuple[int, int, int],
                  order: int = 1) -> torch.Tensor:
    """Resample to ``out_shape`` (order 0 = nearest, 1 = trilinear),
    endpoint-aligned like scipy.ndimage.zoom, in the volume's dtype (the
    trilinear values cast as JAX casts them)."""
    Z, Y, X = volume.shape
    oz, oy, ox = (int(s) for s in out_shape)
    dev = volume.device
    z, y, x = (_axis_coords(n, o, dev) for n, o in ((Z, oz), (Y, oy), (X, ox)))
    if order == 0:
        zi, yi, xi = (torch.round(c).long() for c in (z, y, x))
        return volume.index_select(0, zi).index_select(1, yi).index_select(2, xi)
    out = torch.empty((oz, oy, ox), dtype=volume.dtype, device=dev)
    rows = slab_rows(oy * ox)
    for z0 in range(0, oz, rows):
        zs = z[z0:z0 + rows]
        shape = (len(zs), oy, ox)
        res = trilinear(volume, x[None, None, :].expand(shape),
                        y[None, :, None].expand(shape), zs[:, None, None].expand(shape))
        out[z0:z0 + rows] = cast_like_jax(res, volume.dtype)
    return out


def resize_by_spacing_scale(volume: torch.Tensor, scale: int) -> torch.Tensor:
    """Quality-preset downsampling: 'Low' = 3, 'Medium' = 2 (reference
    SURFACE_QUALITY image_spacing_scale; surface.py:1349-1357 resizes the
    image before contouring)."""
    if scale <= 1:
        return volume
    out_shape = tuple(max(2, s // scale) for s in volume.shape)
    return resize_volume(volume, out_shape, order=1)

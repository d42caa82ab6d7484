"""Screen-space rasterization for the 3D mask editor: polygon -> mask, and
the mask cut by a screen polygon with a depth limit (port of
invesalius3_tpu/ops/rasterize.py).

Reference: invesalius_rs/src/polygon_mask.rs ``polygon2mask_rs``
(ray-casting point-in-polygon over a pixel grid), mask_cut.rs
``mask_cut_internal`` (project every visible-mask voxel through the
world->NDC matrix; zero it if it lands inside the screen polygon within
``max_depth`` of the camera — include mode also zeroes off-viewport
voxels, reference fix #1084), used by
invesalius/data/mask3d_editor_state.py:14.

On the tensors' device: point-in-polygon is an even-odd count over the
polygon's edges for every pixel; the mask cut projects the voxels of one
z-slab at a time (``reslice.slab_rows``), so a 512^3 mask needs a few
hundred MiB of work space.  The projections are evaluated in XLA's order
(``ops/xla_float``), as the JAX package computes them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.ops.reslice import host_matrix, slab_rows
from invesalius3_tpu_torch.ops.xla_float import fma, row4


def point_in_polygon(px: torch.Tensor, py: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Vectorized even-odd ray casting.  ``points``: (E, 2) polygon vertices
    in the same (x, y) convention as the query tensors."""
    xi = points[:, 0]
    yi = points[:, 1]
    xj = torch.roll(xi, 1)
    yj = torch.roll(yi, 1)
    px_e = px[..., None]
    py_e = py[..., None]
    cond = (yi > py_e) != (yj > py_e)
    dy = yj - yi
    denom = torch.where(dy == 0, torch.ones_like(dy), dy)
    x_int = (xj - xi) * (py_e - yi) / denom + xi
    crossing = cond & (px_e < x_int)
    return crossing.sum(dim=-1, dtype=torch.int32) % 2 == 1


def polygon2mask(shape: Tuple[int, int], points, device=DEFAULT_DEVICE) -> torch.Tensor:
    """(w, h) bool mask of pixels inside the polygon — the reference's axis
    convention (mask indexed [x, y] = polygon2mask_rs's (w, h)).  A tensor
    of points is used on its device; host points go to ``device``."""
    if isinstance(points, torch.Tensor):
        dev = points.device
    else:
        dev = resolve_device(device)
        points = torch.from_numpy(np.array(points, np.float32))
    pts = points.to(device=dev, dtype=torch.float32)
    w, h = shape
    px = torch.arange(w, dtype=torch.float32, device=dev)[:, None].expand(w, h)
    py = torch.arange(h, dtype=torch.float32, device=dev)[None, :].expand(w, h)
    return point_in_polygon(px, py, pts)


def mask_cut(
    mask_volume: torch.Tensor,  # (Z, Y, X) uint8; a modified copy is returned
    spacing: Tuple[float, float, float],
    max_depth: float,
    screen_polygon_mask: torch.Tensor,  # (H, W) bool from polygon2mask (transposed)
    m,  # 4x4 world -> NDC (model-view-projection)
    mv,  # 4x4 world -> camera (model-view), for depth
    edit_mode: int = 0,  # 0 = include (cut outside-viewport too), 1 = exclude
) -> torch.Tensor:
    """Zero visible-mask voxels whose screen projection falls inside the
    polygon within max_depth (reference mask_cut.rs semantics), on the
    mask's device, one z-slab at a time."""
    dev = mask_volume.device
    sx, sy, sz = (float(np.float32(s)) for s in spacing)
    Z, Y, X = mask_volume.shape
    poly = screen_polygon_mask.to(dev)
    h, w = poly.shape
    mh, mvh = host_matrix(m), host_matrix(mv)
    depth = float(np.float32(max_depth))
    yy = (torch.arange(Y, dtype=torch.float32, device=dev) * sy)[None, :, None]
    xx = (torch.arange(X, dtype=torch.float32, device=dev) * sx)[None, None, :]
    zz_all = torch.arange(Z, dtype=torch.float32, device=dev) * sz
    zero = torch.zeros((), dtype=mask_volume.dtype, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    out = torch.empty_like(mask_volume)
    rows = slab_rows(Y * X)
    for z0 in range(0, Z, rows):
        zz = zz_all[z0:z0 + rows, None, None]
        qx, qy, _, qw = (row4(mh[i], xx, yy, zz) for i in range(4))
        front = qw > 0
        qw_safe = torch.where(front, qw, one)
        ndc_x = qx / qw_safe
        ndc_y = qy / qw_safe

        cx, cy, cz, cw = (row4(mvh[i], xx, yy, zz) for i in range(4))
        cw_safe = torch.where(cw == 0, one, cw)
        cx, cy, cz = cx / cw_safe, cy / cw_safe, cz / cw_safe
        dist = torch.sqrt(fma(cz, cz, fma(cx, cx, cy * cy)))

        px = (ndc_x * 0.5 + 0.5) * float(w - 1)
        py = (ndc_y * 0.5 + 0.5) * float(h - 1)
        on_screen = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        pxi = px.long().clamp(0, w - 1)
        pyi = py.long().clamp(0, h - 1)
        in_poly = poly[pyi, pxi]

        part = mask_volume[z0:z0 + rows]
        visible = part > 127
        within = front & (dist <= depth)
        cut = within & torch.where(on_screen, in_poly,
                                   torch.tensor(edit_mode == 0, device=dev))
        out[z0:z0 + rows] = torch.where(visible & cut, zero, part)
    return out

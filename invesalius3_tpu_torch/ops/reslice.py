"""Oblique volume reslicing under a 4x4 view matrix with nearest, trilinear,
tricubic (Catmull-Rom) and Lanczos-4 interpolation (port of
invesalius3_tpu/ops/reslice.py).

Reference: invesalius_rs/src/transforms.rs ``coord_transform`` (sample at
M @ (z*sz, y*sy, x*sx, 1), homogeneous divide, back to voxel units, cval
outside [0, dim-1)) and interpolation.rs (trilinear :67, Catmull-Rom
tricubic :105, Lanczos a=4 with 7 taps :140, all with wrap-by-one-period
boundary handling), driven from Slice.get_image_slice for rotated volumes
and from Slice.apply_reorientation.

Design: the taps are accumulated one at a time.  Each tap is one gather of
the samples' voxels from the flat volume and a multiply-add into a float32
accumulator; the (..., 4, 4, 4) or (..., 7, 7, 7) tap tensor that the JAX
code sums never exists (at 512^3 it would take 32 GiB for tricubic and
172 GiB for Lanczos).  ``apply_view_matrix_transform`` resamples the output
in z-slabs of at most ``_SLAB_VOXELS`` voxels, so its working set is a few
hundred MiB whatever the volume.  The sum order differs from XLA's, so
tricubic and Lanczos values agree with the JAX package's within float32
rounding.  Sample coordinates are evaluated in XLA's order
(``ops/xla_float``), so nearest samples agree bit for bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch.ops.casting import cast_like_jax
from invesalius3_tpu_torch.ops.xla_float import fma, recip, row4

_SLAB_VOXELS = 1 << 23  # output voxels resampled at once (32 MiB a float32 plane)


def _wrap(idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Reference get_value boundary: out-of-range wraps by one period
    (interpolation.rs:6-35)."""
    return torch.where(idx < 0, idx + dim, torch.where(idx >= dim, idx - dim, idx))


def _take_flat(flat: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """``flat[lin]`` with the JAX package's gather rule: a negative index
    counts from the end once, then every index is clamped into the array
    (an index beyond one period, from a coordinate far outside the volume,
    reads an end voxel instead of raising)."""
    n = flat.numel()
    lin = torch.where(lin < 0, lin + n, lin).clamp_(0, n - 1)
    return flat[lin]


def _gather(volume: torch.Tensor, zi, yi, xi) -> torch.Tensor:
    """The voxels at integer (z, y, x) indices, each wrapped by one period."""
    dz, dy, dx = volume.shape
    lin = (_wrap(zi, dz) * dy + _wrap(yi, dy)) * dx + _wrap(xi, dx)
    return _take_flat(volume.reshape(-1), lin)


def _axis_taps(i0: torch.Tensor, offsets, dim: int, stride: int) -> List[torch.Tensor]:
    """Per offset, the wrapped index along one axis times its stride: a
    tap's flat index is the sum of one entry per axis."""
    return [_wrap(i0 + o, dim) * stride for o in offsets]


def _split(volume: torch.Tensor, x, y, z):
    """(flat float32-able volume, integer floors, fractions) of the sample
    coordinates."""
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    frac = (x - x0, y - y0, z - z0)
    return volume.contiguous().reshape(-1), (x0.long(), y0.long(), z0.long()), frac


def trilinear(volume: torch.Tensor, x, y, z) -> torch.Tensor:
    """Trilinear samples at float32 coordinates (any common shape), float32;
    the blends in the JAX package's order (interpolation.rs:67)."""
    dz, dy, dx = volume.shape
    flat, (x0, y0, z0), (xd, yd, zd) = _split(volume, x, y, z)
    zs = _axis_taps(z0, (0, 1), dz, dy * dx)
    ys = _axis_taps(y0, (0, 1), dy, dx)
    xs = _axis_taps(x0, (0, 1), dx, 1)

    def g(dx_, dy_, dz_):
        return _take_flat(flat, zs[dz_] + ys[dy_] + xs[dx_]).float()

    # the order in which XLA's CPU code fuses the JAX package's compiled
    # trilinear (on its own and in the raycaster): the first three x blends
    # on their second product, the other four on their first.  Elsewhere
    # XLA may fuse otherwise; the samples then agree within float32 rounding.
    ux, uy, uz = 1 - xd, 1 - yd, 1 - zd
    c00 = fma(g(1, 0, 0), xd, g(0, 0, 0) * ux)
    c10 = fma(g(1, 1, 0), xd, g(0, 1, 0) * ux)
    c01 = fma(g(1, 0, 1), xd, g(0, 0, 1) * ux)
    c11 = fma(g(0, 1, 1), ux, g(1, 1, 1) * xd)
    c0 = fma(c00, uy, c10 * yd)
    c1 = fma(c01, uy, c11 * yd)
    return fma(c0, uz, c1 * zd)


def _cr_weights(t: torch.Tensor) -> torch.Tensor:
    """Catmull-Rom weights for taps [-1, 0, 1, 2] (interpolation.rs:37-43),
    stacked on a last axis of 4."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return torch.stack([w0, w1, w2, w3], dim=-1)


def _lanczos_weights(t: torch.Tensor, a: int = 4) -> torch.Tensor:
    """Weights for the reference's 7 taps [-3..3] around the floor
    (interpolation.rs:140-188), stacked on a last axis of 2a - 1."""
    offs = torch.arange(-a + 1, a, dtype=torch.float32, device=t.device)
    d = t[..., None] - offs
    pi = np.float32(np.pi)
    pd = d * float(pi)
    w = (float(a) * torch.sin(pd) * torch.sin(pd * recip(a))) / (float(pi * pi) * d * d)
    w = torch.where(d == 0.0, torch.ones_like(w), w)
    return torch.where(d.abs() >= float(a), torch.zeros_like(w), w)


def _separable(volume: torch.Tensor, x, y, z, offsets, weights) -> torch.Tensor:
    """sum over the taps (ox, oy, oz) of v[floor + o] * wx[ox] * wy[oy] *
    wz[oz], one tap at a time; ``weights(t)`` stacks a tap's weights on a
    last axis."""
    dz, dy, dx = volume.shape
    flat, (x0, y0, z0), (xf, yf, zf) = _split(volume, x, y, z)
    wx, wy, wz = (weights(t).unbind(-1) for t in (xf, yf, zf))
    zs = _axis_taps(z0, offsets, dz, dy * dx)
    ys = _axis_taps(y0, offsets, dy, dx)
    xs = _axis_taps(x0, offsets, dx, 1)
    acc = torch.zeros(x0.shape, dtype=torch.float32, device=x0.device)
    for i, xi in enumerate(xs):
        for j, yj in enumerate(ys):
            wxy = wx[i] * wy[j]
            base = xi + yj
            for k, zk in enumerate(zs):
                acc += flat[base + zk].float() * (wxy * wz[k])
    return acc


def tricubic(volume: torch.Tensor, x, y, z) -> torch.Tensor:
    """Catmull-Rom tricubic samples, 4 x 4 x 4 taps (interpolation.rs:105)."""
    return _separable(volume, x, y, z, range(-1, 3), _cr_weights)


def lanczos(volume: torch.Tensor, x, y, z, a: int = 4) -> torch.Tensor:
    """Lanczos-a samples, (2a - 1)^3 taps (interpolation.rs:140)."""
    return _separable(volume, x, y, z, range(-a + 1, a),
                      lambda t: _lanczos_weights(t, a))


def sample_volume(volume: torch.Tensor, x, y, z, method: int, cval: float) -> torch.Tensor:
    """Interpolate at fractional voxel coords with the reference's bounds
    and clamping rules (transforms.rs:32-54): valid iff coord in
    [0, dim-1); tricubic/lanczos results clamped below by cval.  float32."""
    dz, dy, dx = volume.shape
    valid = ((z >= 0) & (z < dz - 1) & (y >= 0) & (y < dy - 1)
             & (x >= 0) & (x < dx - 1))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xs = torch.where(valid, x, zero)
    ys = torch.where(valid, y, zero)
    zs = torch.where(valid, z, zero)
    cv = torch.tensor(cval, dtype=torch.float32, device=x.device)
    if method == const.INTERP_NEAREST:
        out = _gather(volume.contiguous(), zs.long(), ys.long(), xs.long()).float()
    elif method == const.INTERP_TRILINEAR:
        out = trilinear(volume, xs, ys, zs)
    elif method == const.INTERP_TRICUBIC:
        out = torch.maximum(tricubic(volume, xs, ys, zs), cv)
    else:
        out = torch.maximum(lanczos(volume, xs, ys, zs), cv)
    return torch.where(valid, out, cv)


def slab_rows(plane_voxels: int) -> int:
    """Output z-planes resampled at once for planes of ``plane_voxels``."""
    return max(1, _SLAB_VOXELS // max(plane_voxels, 1))


def host_matrix(m) -> np.ndarray:
    """A 4x4 matrix (array or tensor) as a float32 host array."""
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
    return np.asarray(m, dtype=np.float32).reshape(4, 4)


def apply_view_matrix_transform(
    volume: torch.Tensor,
    spacing: Tuple[float, float, float],
    m,
    n: int,
    orientation: str,
    method: int,
    cval: float,
    out_shape: Tuple[int, int, int],
) -> torch.Tensor:
    """Resample an oblique slab through the volume under the 4x4 view
    matrix ``m`` (array or tensor; reference transforms_py.rs:12-49, (z, y,
    x) world coordinate order with homogeneous divide), on the volume's
    device, into a new ``out_shape`` tensor of the volume's dtype.  An
    integer volume's samples are rounded half to even before the cast."""
    dev = volume.device
    sx, sy, sz = (float(s) for s in spacing)
    mh = host_matrix(m)
    oz, oy, ox = (int(s) for s in out_shape)
    shift = {"AXIAL": (n, 0, 0), "CORONAL": (0, n, 0),
             "SAGITAL": (0, 0, n), "SAGITTAL": (0, 0, n)}.get(orientation, (0, 0, 0))

    def axis(size, s, k):
        c = torch.arange(size, dtype=torch.float32, device=dev) + float(shift[k])
        return c * float(np.float32(s))

    wy = axis(oy, sy, 1)[None, :, None]
    wx = axis(ox, sx, 2)[None, None, :]
    integer = not (volume.dtype.is_floating_point or volume.dtype == torch.bool)
    out = torch.empty((oz, oy, ox), dtype=volume.dtype, device=dev)
    volume = volume.contiguous()
    rows = slab_rows(oy * ox)
    wz_all = axis(oz, sz, 0)
    for z0 in range(0, oz, rows):
        wz = wz_all[z0:z0 + rows, None, None]
        tz, ty, tx, tw = (row4(mh[i], wz, wy, wx) for i in range(4))
        nz = (tz / tw) * recip(sz)
        ny = (ty / tw) * recip(sy)
        nx = (tx / tw) * recip(sx)
        res = sample_volume(volume, nx, ny, nz, method, cval)
        if integer:
            res = torch.round(res)
        out[z0:z0 + rows] = cast_like_jax(res, volume.dtype)
    return out

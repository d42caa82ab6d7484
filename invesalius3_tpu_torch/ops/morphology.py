"""Structuring elements, binary and grey morphology, brushes and the crop
(port of invesalius3_tpu/ops/morphology.py).

Grey dilation and erosion follow ``lax.reduce_window`` with ``padding="SAME"``:
the border is padded with the dtype's min (dilation) or max (erosion), so a
window never sees a value from outside the volume.  A box window's max is
separable, so it is taken one axis at a time; max and min are exact in any
order, so the result equals the JAX package's bit for bit.

Binary dilation and erosion are an OR (AND) over the structuring element's
offsets of zero-filled shifts, as in the JAX package; each shift is written
as a slice of the output or-ed (and-ed) with a slice of the input
(``out[dst] |= x[src]``), which gives the same bits without a padded copy
per offset.

The drag-stroke brushes (``paint_brush_trajectory*``) place each stamp as
``lax.dynamic_slice`` does in the JAX scan: ``start = min(max(c - half, 0),
dim - size)``, so a stamp near a border moves inward whole.  Every one of
their ops writes, inside a stamp's footprint, a function of the voxel's
image value and its value before the stroke, so the order of the stamps
cannot change the result: the port applies the stroke as one union of the
footprints (gathered voxel indices, a chunk of stamps at a time).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Structuring elements (scipy.ndimage.generate_binary_structure semantics)
# ---------------------------------------------------------------------------


def generate_binary_structure(rank: int, connectivity: int) -> np.ndarray:
    """A 3^rank bool array where an element is True iff its offset from the
    centre has L1 norm <= connectivity (scipy's contract)."""
    grid = np.indices((3,) * rank) - 1
    dist = np.abs(grid).sum(axis=0)
    return (dist <= connectivity).astype(bool)


# Connectivity aliases matching the reference's CON2D/CON3D maps
# (reference styles.py: CON2D = {4: 1, 8: 2}; CON3D = {6: 1, 18: 2, 26: 3}).
def structure_2d(conn: int) -> np.ndarray:
    return generate_binary_structure(2, {4: 1, 8: 2}[conn])


def structure_3d(conn: int) -> np.ndarray:
    return generate_binary_structure(3, {6: 1, 18: 2, 26: 3}[conn])


def _offsets(strct: np.ndarray) -> Tuple[Tuple[int, ...], ...]:
    """Nonzero offsets of a structuring element, centred."""
    strct = np.asarray(strct)
    center = [s // 2 for s in strct.shape]
    return tuple(
        tuple(int(c) - ctr for c, ctr in zip(idx, center))
        for idx in zip(*np.nonzero(strct))
    )


# ---------------------------------------------------------------------------
# Shifts
# ---------------------------------------------------------------------------


def pad_const(x: torch.Tensor, pads: Sequence[Tuple[int, int]],
              value) -> torch.Tensor:
    """Pad each axis by (low, high) with a constant (any dtype)."""
    if not any(lo or hi for lo, hi in pads):
        return x
    shape = [s + lo + hi for s, (lo, hi) in zip(x.shape, pads)]
    out = torch.full(shape, value, dtype=x.dtype, device=x.device)
    out[tuple(slice(lo, lo + s) for s, (lo, _) in zip(x.shape, pads))] = x
    return out


def shift_nd(x: torch.Tensor, offset: Sequence[int], fill=0) -> torch.Tensor:
    """Fill-padded shift: out[i] = x[i - offset] (a positive offset moves
    content toward larger indices)."""
    out = x
    for axis, off in enumerate(offset):
        if off == 0:
            continue
        n = x.shape[axis]
        pads = [(0, 0)] * x.dim()
        if off > 0:
            pads[axis] = (off, 0)
            out = pad_const(out, pads, fill).narrow(axis, 0, n)
        else:
            pads[axis] = (0, -off)
            out = pad_const(out, pads, fill).narrow(axis, -off, n)
    return out


def shift_slices(shape: Sequence[int], offset: Sequence[int]):
    """(dst, src) index tuples with ``out[dst] = x[src]`` being the part of
    ``shift_nd(x, offset)`` that comes from ``x``; None when the shift
    leaves nothing of ``x``."""
    dst, src = [], []
    for n, off in zip(shape, offset):
        if abs(off) >= n:
            return None
        dst.append(slice(max(off, 0), n + min(off, 0)))
        src.append(slice(max(-off, 0), n - max(off, 0)))
    return tuple(dst), tuple(src)


# ---------------------------------------------------------------------------
# Binary morphology
# ---------------------------------------------------------------------------


def binary_dilation(x: torch.Tensor, strct: np.ndarray) -> torch.Tensor:
    """OR over the structuring element's offsets of zero-filled shifts."""
    x = x.to(torch.bool)
    out = torch.zeros_like(x)
    for off in _offsets(strct):
        sl = shift_slices(x.shape, off)
        if sl is not None:
            out[sl[0]].bitwise_or_(x[sl[1]])
    return out


def binary_erosion(x: torch.Tensor, strct: np.ndarray) -> torch.Tensor:
    """AND over the offsets of zero-filled shifts: the band a shift fills
    with False clears the output."""
    x = x.to(torch.bool)
    out = torch.ones_like(x)
    for off in _offsets(strct):
        sl = shift_slices(x.shape, off)
        if sl is None:
            out.zero_()
            continue
        out[sl[0]].bitwise_and_(x[sl[1]])
        for axis, o in enumerate(off):
            band = [slice(None)] * x.dim()
            if o > 0:
                band[axis] = slice(0, o)
            elif o < 0:
                band[axis] = slice(x.shape[axis] + o, None)
            else:
                continue
            out[tuple(band)] = False
    return out


def binary_opening(x: torch.Tensor, strct: np.ndarray) -> torch.Tensor:
    return binary_dilation(binary_erosion(x, strct), strct)


def binary_closing(x: torch.Tensor, strct: np.ndarray) -> torch.Tensor:
    return binary_erosion(binary_dilation(x, strct), strct)


# ---------------------------------------------------------------------------
# Grey morphology
# ---------------------------------------------------------------------------


def _same_pads(size: Sequence[int]):
    # lax.padtype_to_pads for stride 1: total k - 1, low half rounded down
    return [((k - 1) // 2, (k - 1) - (k - 1) // 2) for k in size]


def _box_reduce(x: torch.Tensor, size: Sequence[int], fill, op) -> torch.Tensor:
    out = pad_const(x, _same_pads(size), fill)
    for axis, k in enumerate(size):
        n = x.shape[axis]
        acc = out.narrow(axis, 0, n)
        for j in range(1, k):
            acc = op(acc, out.narrow(axis, j, n))
        out = acc
    return out.contiguous()


def _limits(dtype: torch.dtype):
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return info.min, info.max


def grey_dilation(x: torch.Tensor, size: Tuple[int, ...]) -> torch.Tensor:
    return _box_reduce(x, size, _limits(x.dtype)[0], torch.maximum)


def grey_erosion(x: torch.Tensor, size: Tuple[int, ...]) -> torch.Tensor:
    return _box_reduce(x, size, _limits(x.dtype)[1], torch.minimum)


def morphological_gradient(x: torch.Tensor,
                           size: Tuple[int, ...] = (3, 3, 3)) -> torch.Tensor:
    """dilation - erosion, the watershed pre-filter (reference
    watershed_process.py:36-52, scipy.ndimage.morphological_gradient)."""
    return grey_dilation(x, size) - grey_erosion(x, size)


# ---------------------------------------------------------------------------
# Brushes (reference brush_mask.rs + cursor_actors.py semantics)
# ---------------------------------------------------------------------------


def brush_element(
    radius_mm: float,
    spacing: Tuple[float, float, float],
    shape: str = "circle",
    dims: int = 3,
) -> np.ndarray:
    """Boolean brush footprint in voxel units for a physical radius in mm.

    ``shape`` in {"circle" (sphere in 3D), "square" (cube in 3D)}.
    ``spacing`` is (sx, sy, sz) like Volume.spacing.
    """
    sx, sy, sz = spacing
    if dims == 3:
        rz = max(int(round(radius_mm / sz)), 0)
        ry = max(int(round(radius_mm / sy)), 0)
        rx = max(int(round(radius_mm / sx)), 0)
        zz, yy, xx = np.mgrid[-rz : rz + 1, -ry : ry + 1, -rx : rx + 1]
        if shape == "square":
            return np.ones(zz.shape, bool)
        d = (zz * sz) ** 2 + (yy * sy) ** 2 + (xx * sx) ** 2
        return d <= radius_mm**2
    else:
        ry = max(int(round(radius_mm / sy)), 0)
        rx = max(int(round(radius_mm / sx)), 0)
        yy, xx = np.mgrid[-ry : ry + 1, -rx : rx + 1]
        if shape == "square":
            return np.ones(yy.shape, bool)
        d = (yy * sy) ** 2 + (xx * sx) ** 2
        return d <= radius_mm**2


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def paint_brush(
    mask: torch.Tensor,
    brush: np.ndarray,
    center: Tuple[int, ...],
    value: int,
) -> torch.Tensor:
    """Stamp a brush footprint into a new copy of the mask at ``center``
    (z, y, x; clipped at the borders): reference brush_mask.rs.  Paint
    sets ``value`` to 254 (a manual edit), erase to 1 (the erased code)."""
    brush = _host(brush).astype(bool)
    starts = [int(c) - s // 2 for c, s in zip(center, brush.shape)]
    slices_mask, slices_brush = [], []
    for ax, (st, bs) in enumerate(zip(starts, brush.shape)):
        lo = max(st, 0)
        hi = min(st + bs, mask.shape[ax])
        if hi <= lo:
            return mask
        slices_mask.append(slice(lo, hi))
        slices_brush.append(slice(lo - st, hi - st))
    out = mask.clone()
    b = torch.from_numpy(np.ascontiguousarray(brush[tuple(slices_brush)]))
    out[tuple(slices_mask)].masked_fill_(b.to(mask.device), value)
    return out


# voxel indices gathered at once by a stroke: a chunk of stamps at a time
_STROKE_CHUNK = 1 << 24

# threshold-brush op -> (new value inside the window, outside; None keeps)
_THRESHOLD_OPS = {
    "thresh": (254, 1),
    "thresh_erase": (1, 254),
    "thresh_add": (254, None),
    "thresh_erase_only": (None, 1),
}


def _stamp_starts(centers, brush_shape: Sequence[int],
                 shape: Sequence[int]) -> np.ndarray:
    """(N, 3) int64 corners of the stamps, clamped as ``lax.dynamic_slice``
    clamps them: ``min(max(c - size // 2, 0), dim - size)``."""
    size = np.asarray(brush_shape, np.int64)
    dims = np.asarray(shape, np.int64)
    if (size > dims).any():
        raise ValueError(f"brush {tuple(brush_shape)} is larger than the "
                         f"volume {tuple(shape)}")
    c = _host(centers).astype(np.int64).reshape(-1, len(shape))
    return np.minimum(np.maximum(c - size // 2, 0), dims - size)


def _stroke(mask: torch.Tensor, brush, centers, brush_shape, write) -> torch.Tensor:
    """A new mask with ``write(flat voxel index, old values)`` stored at
    every voxel of the stroke's footprints.  ``write`` must depend only on
    the voxel, so repeated voxels get one value."""
    brush = _host(brush).astype(bool)
    if tuple(brush.shape) != tuple(brush_shape):
        raise ValueError(f"brush shape {brush.shape} != brush_shape {tuple(brush_shape)}")
    starts = _stamp_starts(centers, brush_shape, mask.shape)
    out = mask.contiguous().clone()
    flat = out.view(-1)
    strides = torch.tensor(out.stride(), dtype=torch.int64, device=out.device)
    foot = (torch.from_numpy(np.argwhere(brush)).to(out.device) * strides).sum(1)
    if foot.numel() == 0 or len(starts) == 0:
        return out
    per = max(1, _STROKE_CHUNK // foot.numel())
    for i in range(0, len(starts), per):
        base = (torch.from_numpy(starts[i:i + per]).to(out.device) * strides).sum(1)
        idx = (base[:, None] + foot[None, :]).reshape(-1)
        flat[idx] = write(idx, flat[idx])
    return out


def paint_brush_trajectory(
    mask: torch.Tensor,
    brush,
    centers,
    value: int,
    brush_shape: Tuple[int, int, int],
) -> torch.Tensor:
    """Stamp the same brush at many (z, y, x) centers (a drag stroke):
    every voxel of the clamped footprints becomes ``value``."""
    v = torch.tensor(value, dtype=mask.dtype, device=mask.device)
    return _stroke(mask, brush, centers, brush_shape,
                   lambda idx, old: v.expand(old.shape))


def _image_scalar(t, dtype: torch.dtype):
    """A bound as ``jnp.asarray(t, dtype)`` makes it: floats keep float32
    rounding, integer types truncate toward zero."""
    t = float(t)
    return t if dtype.is_floating_point else int(np.trunc(t))


def paint_brush_trajectory_threshold(
    mask: torch.Tensor,
    image: torch.Tensor,
    brush,
    centers,
    tmin,
    tmax,
    brush_shape: Tuple[int, int, int],
    op: str = "thresh",
) -> torch.Tensor:
    """Threshold-gated brush ops (reference slice_.py:722-736 editor
    semantics over const.BRUSH_THRESH* codes, styles.py:1361):

    - ``thresh``: inside the footprint, voxels whose image value lies in
      [tmin, tmax] become 254 (edited-in), all others become 1 (erased).
    - ``thresh_erase``: the inverse gate: out-of-range voxels become 254,
      in-range become 1.
    - ``thresh_add``: only in-range voxels are set (to 254); the rest of
      the footprint is untouched (BRUSH_THRESH_ADD_ONLY).
    - ``thresh_erase_only``: only out-of-range voxels are cleared (to 1)
      (BRUSH_THRESH_ERASE_ONLY).

    ``tmin``/``tmax`` are first cast to the image's dtype, as in the JAX
    package (an integer image truncates them toward zero).
    """
    if op not in _THRESHOLD_OPS:
        raise ValueError(f"unknown threshold-brush op {op!r}")
    if image.shape != mask.shape:
        raise ValueError(f"image {tuple(image.shape)} and mask {tuple(mask.shape)} differ")
    lo = torch.tensor(_image_scalar(tmin, image.dtype), dtype=image.dtype, device=image.device)
    hi = torch.tensor(_image_scalar(tmax, image.dtype), dtype=image.dtype, device=image.device)
    img = image.reshape(-1)
    v_in, v_out = _THRESHOLD_OPS[op]

    def write(idx, old):
        g = img[idx]
        inside = (g >= lo) & (g <= hi)
        new_in = old if v_in is None else torch.full_like(old, v_in)
        new_out = old if v_out is None else torch.full_like(old, v_out)
        return torch.where(inside, new_in, new_out)

    return _stroke(mask, brush, centers, brush_shape, write)


def crop_mask(mask: torch.Tensor,
              limits: Tuple[int, int, int, int, int, int]) -> torch.Tensor:
    """Zero everything outside the (zi, zf, yi, yf, xi, xf) box, limits
    inclusive: the crop tool (reference styles.py:2596)."""
    zi, zf, yi, yf, xi, xf = limits
    Z, Y, X = mask.shape
    ar = lambda n: torch.arange(n, device=mask.device)  # noqa: E731
    zz = ar(Z)[:, None, None]
    yy = ar(Y)[None, :, None]
    xx = ar(X)[None, None, :]
    inside = ((zz >= zi) & (zz <= zf) & (yy >= yi) & (yy <= yf)
              & (xx >= xi) & (xx <= xf))
    return torch.where(inside, mask, torch.zeros((), dtype=mask.dtype,
                                                 device=mask.device))

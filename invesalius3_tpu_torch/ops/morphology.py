"""Shifts, grey morphology and the crop (port of
invesalius3_tpu/ops/morphology.py, the parts the watershed and the slice
use).

Grey dilation and erosion follow ``lax.reduce_window`` with ``padding="SAME"``:
the border is padded with the dtype's min (dilation) or max (erosion), so a
window never sees a value from outside the volume.  A box window's max is
separable, so it is taken one axis at a time; max and min are exact in any
order, so the result equals the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


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

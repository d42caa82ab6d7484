"""Image filters producing new image versions: gaussian, median, mean,
unsharp, sharpen, despeckle and border detection, and the non-zero
correlation behind the mask area (port of invesalius3_tpu/ops/filters.py).

Every filter works on any rank, as in the JAX package.  ``batch_dims``
leading axes are independent images (the port's form of the JAX package's
``jax.vmap`` of a filter over the slices of a volume): each is padded and,
where a filter takes the image's min or max, reduced on its own.

Accumulations run in float32 in the JAX package's order, each product
and sum rounded on its own, the same on the CPU and the card.  XLA on the
CPU contracts ``acc + w * x`` into one fused multiply-add, so a float32
result can differ from the JAX package's in the last bits, and an integer
result by one grey level on a rounding edge.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from invesalius3_tpu_torch.ops.casting import cast_like_jax

# the median's stack of shifted copies is built this many bytes at a time
_MEDIAN_CHUNK_BYTES = 1 << 30

# the gaussian's radius in sigmas (scipy's default; every caller uses it)
_TRUNCATE = 4.0


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d kernel (radius = _TRUNCATE*sigma)."""
    radius = int(_TRUNCATE * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _sym_pad(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """``np.pad(mode="symmetric")`` along one axis (edge repeated; pads
    longer than the axis reflect again)."""
    if not (lo or hi):
        return x
    n = x.shape[axis]
    i = torch.arange(-lo, n + hi, device=x.device) % (2 * n)
    i = torch.where(i < n, i, 2 * n - 1 - i)
    return x.index_select(axis, i)


def _spatial(x: torch.Tensor, batch_dims: int):
    return range(batch_dims, x.dim())


def _gaussian_f32(v: torch.Tensor, sigma: float, batch_dims: int) -> torch.Tensor:
    k = [float(w) for w in _gauss_kernel1d(sigma)]
    r = (len(k) - 1) // 2
    out = v.to(torch.float32)
    for axis in _spatial(v, batch_dims):
        n = out.shape[axis]
        padded = _sym_pad(out, axis, r, r)
        acc = torch.zeros_like(out)
        for i, w in enumerate(k):
            acc = acc + w * padded.narrow(axis, i, n)
        out = acc
    return out


def gaussian(volume: torch.Tensor, sigma: float = 1.0, *, batch_dims: int = 0) -> torch.Tensor:
    """Separable gaussian blur, reflect boundary (scipy's default)."""
    return cast_like_jax(_gaussian_f32(volume, sigma, batch_dims), volume.dtype)


def mean(volume: torch.Tensor, size: int = 3, *, batch_dims: int = 0) -> torch.Tensor:
    """Uniform (box) filter, reflect boundary.  XLA turns the division by
    the constant ``size`` into a multiply by its float32 reciprocal; so
    does the port."""
    out = volume.to(torch.float32)
    r = size // 2
    inv = float(np.float32(1) / np.float32(size))
    for axis in _spatial(volume, batch_dims):
        n = out.shape[axis]
        padded = _sym_pad(out, axis, r, size - 1 - r)
        acc = torch.zeros_like(out)
        for i in range(size):
            acc = acc + padded.narrow(axis, i, n)
        out = acc * inv
    return cast_like_jax(out, volume.dtype)


def median(volume: torch.Tensor, size: int = 3, *, batch_dims: int = 0) -> torch.Tensor:
    """Exact median over a size^rank window (symmetric boundary): the middle
    of the sorted shifted copies, as ``jnp.median`` of an odd count.  The
    copies are stacked a chunk of the first axis at a time, so at most
    about ``_MEDIAN_CHUNK_BYTES`` of them exist at once."""
    if size % 2 == 0:
        raise ValueError(f"median size {size} must be odd")
    r = size // 2
    axes = list(_spatial(volume, batch_dims))
    padded = volume
    for axis in axes:
        padded = _sym_pad(padded, axis, r, size - 1 - r)
    offs = list(itertools.product(range(size), repeat=len(axes)))
    out = torch.empty_like(volume)
    n0 = volume.shape[0]
    per_row = volume[0].numel() * len(offs) * volume.element_size()
    step = max(1, _MEDIAN_CHUNK_BYTES // max(per_row, 1))
    halo = size - 1 if batch_dims == 0 else 0
    for z0 in range(0, n0, step):
        z1 = min(z0 + step, n0)
        part = padded.narrow(0, z0, z1 - z0 + halo)
        shape = (z1 - z0,) + tuple(volume.shape[1:])
        windows = []
        for off in offs:
            w = part
            for axis, o in zip(axes, off):
                w = w.narrow(axis, o, shape[axis])
            windows.append(w)
        stack = torch.stack(windows, dim=-1)
        out[z0:z1] = torch.median(stack, dim=-1).values
        del stack, windows
    return out


def unsharp(volume: torch.Tensor, sigma: float = 1.0, amount: float = 1.0,
            *, batch_dims: int = 0) -> torch.Tensor:
    """img + amount * (img - gaussian(img)) (reference filters.py unsharp)."""
    v = volume.to(torch.float32)
    blurred = _gaussian_f32(v, sigma, batch_dims)
    return cast_like_jax(v + float(np.float32(amount)) * (v - blurred), volume.dtype)


def _reduce(x: torch.Tensor, batch_dims: int, fn) -> torch.Tensor:
    """min or max over the spatial axes, one value per image."""
    dims = tuple(_spatial(x, batch_dims))
    return fn(x, dim=dims, keepdim=True)


def sharpen(volume: torch.Tensor, amount: float = 1.0, *, batch_dims: int = 0) -> torch.Tensor:
    """Unsharp-mask sharpening clipped to the input's range (reference
    filters.py sharpening_filter: img + value*0.5*(img - gauss(img, 1))
    clamped to [img.min, img.max])."""
    v = volume.to(torch.float32)
    blurred = _gaussian_f32(v, 1.0, batch_dims)
    out = v + float(np.float32(amount * 0.5)) * (v - blurred)
    lo, hi = _reduce(v, batch_dims, torch.amin), _reduce(v, batch_dims, torch.amax)
    return cast_like_jax(torch.minimum(torch.maximum(out, lo), hi), volume.dtype)


def despeckle(volume: torch.Tensor, sigma: float = 1.0, *, batch_dims: int = 0) -> torch.Tensor:
    """Gaussian speckle reduction (reference filters.py despeckle_filter is
    a gaussian with sigma=value)."""
    return gaussian(volume, float(sigma), batch_dims=batch_dims)


def _sobel_axis(v: torch.Tensor, axis: int, batch_dims: int = 0) -> torch.Tensor:
    """scipy.ndimage.sobel: derivative [-1, 0, 1] on ``axis``, smoothing
    [1, 2, 1] on the other spatial axes, reflect boundary."""
    out = v
    for ax in _spatial(v, batch_dims):
        p = _sym_pad(out, ax, 1, 1)
        n = out.shape[ax]
        a, b, c = (p.narrow(ax, i, n) for i in range(3))
        out = (c - a) if ax == axis else (a + 2.0 * b) + c
    return out


def border_detection(volume: torch.Tensor, sigma: float = 1.0, *,
                     batch_dims: int = 0) -> torch.Tensor:
    """Sobel gradient magnitude after gaussian pre-smoothing, rescaled to
    the input's range (reference filters.py border_detection_filter)."""
    v = _gaussian_f32(volume, float(sigma), batch_dims)
    sq = None
    for ax in _spatial(v, batch_dims):
        s = _sobel_axis(v, ax, batch_dims)
        sq = s * s if sq is None else sq + s * s
    mag = torch.sqrt(sq)
    f = volume.to(torch.float32)
    vmin, vmax = _reduce(f, batch_dims, torch.amin), _reduce(f, batch_dims, torch.amax)
    mmin, mmax = _reduce(mag, batch_dims, torch.amin), _reduce(mag, batch_dims, torch.amax)
    rng = mmax - mmin
    scaled = (mag - mmin) / torch.clamp(rng, min=1e-30) * (vmax - vmin) + vmin
    return cast_like_jax(torch.where(rng > 0, scaled, mag), volume.dtype)


FILTERS = {
    "Gaussian": gaussian,
    "Median": median,
    "Mean": mean,
    "Unsharp": unsharp,
    "Sharpen": sharpen,
    "Despeckle": despeckle,
    "Border": border_detection,
}


def convolve_non_zero(volume: torch.Tensor, kernel, cval: float = 0.0) -> torch.Tensor:
    """Correlate (the reference's "convolve" indexes v[p - c + k] * k[k])
    only at voxels whose value is non-zero, with a constant out-of-bounds
    fill (reference invesalius_rs/src/transforms_py.rs:52-95).  The taps
    are summed in float64 and rounded once to float32: never in TF32, and
    the same on the CPU and the card."""
    k = (kernel.detach().cpu().numpy() if isinstance(kernel, torch.Tensor)
         else np.asarray(kernel)).astype(np.float32)
    kd, kh, kw = k.shape
    pads = [(kd // 2, kd - 1 - kd // 2), (kh // 2, kh - 1 - kh // 2),
            (kw // 2, kw - 1 - kw // 2)]
    v = volume.to(torch.float32)
    shape = [s + lo + hi for s, (lo, hi) in zip(v.shape, pads)]
    padded = torch.full(shape, float(np.float32(cval)), dtype=torch.float32,
                        device=v.device)
    padded[tuple(slice(lo, lo + s) for s, (lo, _) in zip(v.shape, pads))] = v
    D, H, W = v.shape
    acc = torch.zeros(v.shape, dtype=torch.float64, device=v.device)
    for (i, j, l), w in np.ndenumerate(k):
        acc += float(w) * padded[i:i + D, j:j + H, l:l + W].double()
    return torch.where(volume != 0, acc.to(torch.float32),
                       torch.zeros((), dtype=torch.float32, device=v.device))


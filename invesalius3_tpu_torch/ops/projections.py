"""Slab projections: MaxIP / MinIP / MeanIP / LMIP / MIDA and the
contour-enhanced (FCM) variants (port of invesalius3_tpu/ops/projections.py).

LMIP and MIDA walk rays: on a CUDA tensor through the hand-written kernels
of ``projection_kernels`` (the port of the TPU kernels ``lmip_axis0`` and
``mida_axis0``), on a CPU tensor through their plain versions.  ``plain=True``
takes the plain versions on any device, so the card's kernels can be held
against them.  Every ``.astype(volume.dtype)`` of the JAX module is
``cast_like_jax`` here.
"""

from __future__ import annotations

import torch

from invesalius3_tpu_torch.ops import projection_kernels as rays
from invesalius3_tpu_torch.ops.casting import cast_like_jax


def maxip(volume: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return torch.amax(volume, dim=axis)


def minip(volume: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return torch.amin(volume, dim=axis)


def meanip(volume: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """``jnp.mean``: a float32 sum (exact while an integer slab's sums stay
    under 2**24) times the float32 reciprocal of the count, which is what
    XLA makes of the division by a constant."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=volume.device)  # noqa: E731
    recip = f32(1.0) / f32(volume.shape[axis])
    return cast_like_jax(volume.to(torch.float32).sum(dim=axis) * recip, volume.dtype)


def lmip(volume: torch.Tensor, axis: int, tmin: float, tmax: float,
         plain: bool = False) -> torch.Tensor:
    """First local maximum after the ray enters [tmin, tmax]: track the
    running max; once a value inside [tmin, tmax] has been seen, the first
    strictly decreasing step ends the ray."""
    fn = rays.lmip_ref if plain else rays.lmip_rays
    return fn(volume, axis, tmin, tmax)


def mida(volume: torch.Tensor, axis: int, wl: float, ww: float,
         plain: bool = False) -> torch.Tensor:
    """MIDA projection with WW/WL-weighted opacity, normalised by the
    slab's own min and range."""
    fn = rays.mida_ref if plain else rays.mida_rays
    return fn(volume, axis, wl, ww)


def _central_gradient(volume: torch.Tensor) -> torch.Tensor:
    """Central finite differences with edge clamping, h = 1 (reference
    mips.rs:171-195).  Returns (3, Z, Y, X) = gx, gy, gz."""
    v = volume.to(torch.float32)

    def diff(axis: int) -> torch.Tensor:
        n = v.shape[axis]
        fwd = torch.cat([v.narrow(axis, 1, n - 1), v.narrow(axis, n - 1, 1)], axis)
        bwd = torch.cat([v.narrow(axis, 0, 1), v.narrow(axis, 0, n - 1)], axis)
        return (fwd - bwd) / 2.0

    gz = diff(0)
    gy = diff(1)
    gx = diff(2)
    return torch.stack([gx, gy, gz])


def fcm_intensity(volume: torch.Tensor, n: float, axis: int) -> torch.Tensor:
    """Per-voxel contour intensity |g| * (1 - |cos(g, dir)|)^n (reference
    mips.rs:197-213), cast back to the input dtype (it can exceed int16's
    range: |g| reaches about 32767 * sqrt(3), which saturates)."""
    g = _central_gradient(volume)
    gm = torch.sqrt(torch.sum(g * g, dim=0))
    # the gradient component along the view axis: axis 0 -> gz, 1 -> gy, 2 -> gx
    d = g[{0: 2, 1: 1, 2: 0}[axis]]
    one = torch.ones((), dtype=torch.float32, device=gm.device)
    zero = torch.zeros((), dtype=torch.float32, device=gm.device)
    sf = torch.pow(1.0 - torch.abs(d / torch.where(gm == 0.0, one, gm)), n)
    fcm = torch.where(gm == 0.0, zero, gm * sf)
    return cast_like_jax(fcm, volume.dtype)


def fast_contour_mip(volume: torch.Tensor, n: float, axis: int, wl: float,
                     ww: float, tmip: int, plain: bool = False) -> torch.Tensor:
    """Contour-enhanced projection: the FCM intensity volume, then MIP
    (tmip=0), LMIP with the reference's fixed 700..3033 window (tmip=1),
    or MIDA (tmip=2) — reference mips.rs:215-279."""
    if tmip not in (0, 1, 2):
        raise ValueError(f"unknown tmip {tmip}")
    tmp = fcm_intensity(volume, n, axis)
    if tmip == 0:
        return torch.amax(tmp, dim=axis)
    if tmip == 1:
        return lmip(tmp, axis, 700.0, 3033.0, plain=plain)
    return mida(tmp, axis, wl, ww, plain=plain)

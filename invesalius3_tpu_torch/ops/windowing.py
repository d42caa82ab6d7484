"""Window/level intensity mapping (port of invesalius3_tpu/ops/windowing.py).

Everything computes in float32 with the JAX package's operation order, on
0-d float32 tensors on the data's device (a Python scalar divisor on a CUDA
tensor would be turned into a multiply by its reciprocal), so the results
are bit-identical.
"""

from __future__ import annotations

import torch

from invesalius3_tpu_torch.ops.casting import cast_like_jax


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _lut_piecewise(data: torch.Tensor, window: float, level: float,
                   out_max: float) -> torch.Tensor:
    """0 below the window, ``out_max`` above, a linear ramp within."""
    d = data.to(torch.float32)
    w = _f32(window, d.device)
    lv = _f32(level, d.device)
    top = _f32(out_max, d.device)
    lo = lv - 0.5 - (w - 1.0) / 2.0
    hi = lv - 0.5 + (w - 1.0) / 2.0
    ramp = ((d - (lv - 0.5)) / (w - 1.0) + 0.5) * top
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(d <= lo, zero, torch.where(d > hi, top, ramp))


def get_lut_value(data: torch.Tensor, window: float, level: float) -> torch.Tensor:
    """Map intensities into [0, window] (reference get_LUT_value)."""
    return _lut_piecewise(data, window, level, window)


def get_lut_value_255(data: torch.Tensor, window: float, level: float) -> torch.Tensor:
    """Map intensities into [0, 255] (reference get_LUT_value_255)."""
    return _lut_piecewise(data, window, level, 255.0)


def get_lut_value_normalized(data: torch.Tensor, a_min: float, a_max: float,
                             b_min: float = 0.0, b_max: float = 1.0,
                             clip: bool = True) -> torch.Tensor:
    """Linear intensity rescale (reference get_LUT_value_normalized).

    XLA on the CPU contracts ``img * scale + b_min`` into one fused
    multiply-add; the product of two float32 values is exact in float64,
    so the sum is taken there and rounded once to float32 (the same value
    except on a double-rounding tie)."""
    dev = data.device
    lo, hi = _f32(a_min, dev), _f32(a_max, dev)
    b0, b1 = _f32(b_min, dev), _f32(b_max, dev)
    img = (data.to(torch.float32) - lo) / (hi - lo)
    img = (img.double() * (b1 - b0).double() + b0.double()).to(torch.float32)
    if clip:
        img = torch.clamp(img, b0, b1)
    return img


def apply_ww_wl_rgb(data: torch.Tensor, window: float, level: float) -> torch.Tensor:
    """WW/WL to an (..., 3) uint8 grayscale RGB image (reference
    slice_.py:1688-1698, vtkImageMapToWindowLevelColors)."""
    g = cast_like_jax(torch.clamp(get_lut_value_255(data, window, level),
                                  0.0, 255.0), torch.uint8)
    return torch.stack([g, g, g], dim=-1)


def get_opacity(value: torch.Tensor, wl: float, ww: float) -> torch.Tensor:
    """Linear opacity ramp over the WW/WL window (reference mips.rs:89-100
    ``get_opacity``), used by MIDA.  NaN propagates through the clamp, as
    through ``jnp.clip``."""
    v = value.to(torch.float32)
    wl32, ww32 = _f32(wl, v.device), _f32(ww, v.device)
    min_v = wl32 - ww32 / 2.0
    max_v = wl32 + ww32 / 2.0
    ramp = (v - min_v) / (max_v - min_v)
    return torch.clamp(ramp, 0.0, 1.0)

"""Window/level intensity mapping (port of invesalius3_tpu/ops/windowing.py).

Only the ramp the watershed's ``use_ww_wl`` branch needs is ported; it
computes in float32 with the JAX package's operation order, so the result
is bit-identical.
"""

from __future__ import annotations

import torch


def _lut_piecewise(data: torch.Tensor, window: float, level: float,
                   out_max: float) -> torch.Tensor:
    """0 below the window, ``out_max`` above, a linear ramp within."""
    d = data.to(torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=d.device)  # noqa: E731
    w = f32(window)
    lv = f32(level)
    top = f32(out_max)
    lo = lv - 0.5 - (w - 1.0) / 2.0
    hi = lv - 0.5 + (w - 1.0) / 2.0
    ramp = ((d - (lv - 0.5)) / (w - 1.0) + 0.5) * top
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(d <= lo, zero, torch.where(d > hi, top, ramp))


def get_lut_value(data: torch.Tensor, window: float, level: float) -> torch.Tensor:
    """Map intensities into [0, window] (reference get_LUT_value)."""
    return _lut_piecewise(data, window, level, window)

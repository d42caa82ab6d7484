"""Float32 arithmetic in the order the JAX package's programs evaluate it.

XLA on the CPU contracts ``a * b + c`` into one fused multiply-add.  In
``L + R`` it fuses ``L`` when ``L`` is a product, else ``R``; so
``m0*x + m1*y + m2*z + m3`` is ``fma(m2, z, fma(m0, x, m1*y)) + m3``.  It
also turns a division by a constant into a multiply by the constant's
float32 reciprocal.  Where such a value is then floored, rounded or
compared (sample coordinates, splat positions, the mask cut's projection),
the port evaluates it the same way, on the card as on the CPU: an FMA is a
float64 product and sum rounded once to float32.  The product of two
float32 values is exact in float64, so this is the fused result except when
the float64 sum itself rounds onto a float32 tie, which the tests have not
met.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    return float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` with one rounding to float32.  Python numbers count as
    float32 constants, as JAX's weakly typed scalars do."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def row4(m, x, y, z) -> torch.Tensor:
    """``m[0]*x + m[1]*y + m[2]*z + m[3]`` in XLA's order: one row of a 4x4
    transform (``m``: four float32 numbers)."""
    m = [np.float32(v) for v in m]
    return fma(m[2], z, fma(m[0], x, y * float(m[1]))) + float(m[3])


def recip(c) -> float:
    """The float32 reciprocal that replaces a division by the constant
    ``c``."""
    return float(np.float32(1.0) / np.float32(c))

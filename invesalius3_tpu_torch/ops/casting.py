"""Float-to-integer casts with the JAX package's semantics.

``x.astype(int16)`` in JAX (XLA) saturates and maps NaN to 0; ``x.to(int16)``
in PyTorch wraps around.  ``[nan, 4e4, -4e4, -1.7, 1.7]`` gives
``[0, 32767, -32768, -1, 1]`` in JAX and ``[0, -25536, 25536, -1, 1]`` in
torch.  Every place where the JAX package writes ``.astype(volume.dtype)``
after float arithmetic goes through ``cast_like_jax`` here.
"""

from __future__ import annotations

import torch


def cast_like_jax(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as ``dtype``, the way ``jnp.astype`` converts: for an integer
    dtype from a float tensor, NaN -> 0, then clamp to the dtype's range,
    then truncate toward zero.  Floats and integer inputs convert as torch
    does (the same as JAX for those)."""
    if dtype.is_floating_point or not x.dtype.is_floating_point or dtype == torch.bool:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    # both bounds are exact in float32 for types of up to 16 bits; wider
    # types clamp in float64, where int32's bounds are exact
    work = torch.float32 if info.bits <= 16 else torch.float64
    y = torch.nan_to_num(x.to(work), nan=0.0, posinf=info.max, neginf=info.min)
    return y.clamp(info.min, info.max).trunc().to(dtype)

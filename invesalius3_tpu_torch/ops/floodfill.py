"""Region growing (floodfill) (port of invesalius3_tpu/ops/floodfill.py).

The reference grows a BFS over a queue (invesalius_rs/src/floodfill.rs).
As in the JAX package, reachability is the least fixpoint of
``reached = seeds | (dilate(reached) & allowed)``: the set a BFS reaches
under the same structuring element, whatever the visit order, so the port's
masks equal the JAX package's bit for bit.  The fixpoint runs as a host
loop of ``_STEPS_PER_CHECK`` masked dilations between reads of one
"changed" flag, the JAX ``while_loop``'s body and predicate; each op can
append its number of checks to a ``checks`` list.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.ops.casting import cast_like_jax
from invesalius3_tpu_torch.ops.morphology import (binary_dilation, shift_slices,
                                                  structure_3d)
from invesalius3_tpu_torch.ops.windowing import get_lut_value_255

# Dilations per convergence check (one host read of a flag each)
_STEPS_PER_CHECK = 8

_FACE_OFFSETS = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]


def seeds_to_mask(shape: Tuple[int, int, int],
                  seeds_zyx: Sequence[Tuple[int, int, int]],
                  device=DEFAULT_DEVICE) -> torch.Tensor:
    """Boolean seed mask from (z, y, x) seed coordinates, made on ``device``
    (the card unless "cpu").  The reference's public API passes (x, y, z);
    this framework uses (z, y, x) everywhere."""
    m = torch.zeros(tuple(shape), dtype=torch.bool, device=resolve_device(device))
    for seed in seeds_zyx:
        m[tuple(int(c) for c in seed)] = True
    return m


def _fixpoint(start: torch.Tensor, step, checks: Optional[list]) -> torch.Tensor:
    """Iterate ``step`` from ``start`` in batches of ``_STEPS_PER_CHECK``
    until a batch changes nothing."""
    reached = start
    n = 0
    while True:
        new = reached
        for _ in range(_STEPS_PER_CHECK):
            new = step(new)
        n += 1
        changed = bool(torch.ne(new, reached).any())
        reached = new
        if not changed:
            break
    if checks is not None:
        checks.append(n)
    return reached


def _grow_fixpoint(seeds: torch.Tensor, allowed: torch.Tensor, strct: np.ndarray,
                   checks: Optional[list] = None) -> torch.Tensor:
    """Least fixpoint of reached = seeds | (dilate(reached) & allowed)."""

    def step(r):
        d = binary_dilation(r, strct)
        return d.bitwise_and_(allowed).bitwise_or_(r)

    return _fixpoint(seeds & allowed, step, checks)


def floodfill_threshold(
    data: torch.Tensor,
    seeds: torch.Tensor,
    t0,
    t1,
    strct: Optional[np.ndarray] = None,
    checks: Optional[list] = None,
) -> torch.Tensor:
    """Grow seeds through voxels whose intensity lies in [t0, t1] under the
    structuring element (reference floodfill.rs:96-166).  Returns the
    reached boolean mask; callers write their fill value into it.  The
    bounds compare as in JAX: a float bound against an integer image in
    float32."""
    if strct is None:
        strct = structure_3d(6)
    allowed = (data >= t0) & (data <= t1)
    return _grow_fixpoint(seeds.to(torch.bool), allowed, strct, checks)


def floodfill_value(data: torch.Tensor, seeds: torch.Tensor, value,
                    strct: Optional[np.ndarray] = None,
                    checks: Optional[list] = None) -> torch.Tensor:
    """Grow through voxels exactly equal to ``value`` (reference
    floodfill.rs:5-49 ``floodfill_internal``, 6-connected)."""
    if strct is None:
        strct = structure_3d(6)
    return _grow_fixpoint(seeds.to(torch.bool), data == value, strct, checks)


def floodfill_auto_threshold(data: torch.Tensor, seeds: torch.Tensor, p: float,
                             checks: Optional[list] = None) -> torch.Tensor:
    """Dynamic-window region grow: a neighbour n of a reached voxel v joins
    iff data[n] in [ceil(data[v]*(1-p)), floor(data[v]*(1+p))] (reference
    floodfill_py.rs:13-80, 6-connected).  The window depends on the source
    voxel, so each step tests the six shifted edges."""
    d = data.to(torch.float32)
    lo_f = torch.tensor(1.0 - p, dtype=torch.float32, device=data.device)
    hi_f = torch.tensor(1.0 + p, dtype=torch.float32, device=data.device)
    t0 = cast_like_jax(torch.ceil(d * lo_f), data.dtype)
    t1 = cast_like_jax(torch.floor(d * hi_f), data.dtype)
    del d
    pairs = [s for s in (shift_slices(data.shape, o) for o in _FACE_OFFSETS)
             if s is not None]

    def step(reached):
        new = reached.clone()
        for dst, src in pairs:
            g = data[dst]
            ok = reached[src] & (g >= t0[src]) & (g <= t1[src])
            new[dst].bitwise_or_(ok)
        return new

    return _fixpoint(seeds.to(torch.bool), step, checks)


# ---------------------------------------------------------------------------
# GUI-level region-grow flavours (reference styles.py:3015-3250)
# ---------------------------------------------------------------------------


def region_grow_dynamic(
    data: torch.Tensor,
    seed_zyx: Tuple[int, int, int],
    dev_min: float,
    dev_max: float,
    use_ww_wl: bool = False,
    ww: float = 255.0,
    wl: float = 127.5,
    strct: Optional[np.ndarray] = None,
    checks: Optional[list] = None,
) -> torch.Tensor:
    """'Dynamic' method: window [v - dev_min, v + dev_max] around the seed
    value, optionally on the WW/WL-mapped image (reference
    styles.py:3166-3179).  ``v - dev_min`` promotes as in JAX: an int16
    seed value minus a Python float is float32."""
    img = get_lut_value_255(data, ww, wl) if use_ww_wl else data
    v = img[tuple(int(c) for c in seed_zyx)]
    seeds = seeds_to_mask(data.shape, [seed_zyx], device=data.device)
    return floodfill_threshold(img, seeds, v - dev_min, v + dev_max, strct, checks)


def region_grow_confidence(
    data: torch.Tensor,
    seed_zyx: Tuple[int, int, int],
    mult: float = 2.5,
    iters: int = 3,
    use_ww_wl: bool = False,
    ww: float = 255.0,
    wl: float = 127.5,
    strct: Optional[np.ndarray] = None,
    checks: Optional[list] = None,
) -> torch.Tensor:
    """'Confidence' method (reference styles.py:3225-3250 do_rg_confidence):
    start from the 3x3x3 neighbourhood of the seed; ``iters`` times take
    [mean - mult*s, mean + mult*s] over the grown region (s the standard
    deviation, float32 sums over the whole volume) and grow again."""
    img = (get_lut_value_255(data, ww, wl) if use_ww_wl else data).to(torch.float32)
    z, y, x = (int(c) for c in seed_zyx)
    region = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    region[max(z - 1, 0):z + 2, max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = True
    seeds = seeds_to_mask(data.shape, [seed_zyx], device=data.device)
    zero = torch.zeros((), dtype=torch.float32, device=data.device)
    m = torch.tensor(mult, dtype=torch.float32, device=data.device)

    out = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    for _ in range(iters):
        cnt = region.sum().to(torch.float32)
        mean = torch.where(region, img, zero).sum() / cnt
        std = torch.sqrt(torch.where(region, (img - mean) ** 2, zero).sum() / cnt)
        out = out | floodfill_threshold(img, seeds, mean - std * m, mean + std * m,
                                        strct, checks)
        region = region | out
    return out


def apply_fill(mask: torch.Tensor, reached: torch.Tensor, fill_value: int) -> torch.Tensor:
    """mask with ``fill_value`` where reached (the reference writes the fill
    in place)."""
    return torch.where(reached, torch.tensor(fill_value, dtype=mask.dtype,
                                             device=mask.device), mask)

"""Threshold masks (port of invesalius3_tpu/ops/threshold.py).

Voxels inside [tmin, tmax] become 255 and the others 0, while the manual
editor's codes 1, 2, 253 and 254 survive a re-threshold (reference
slice_.py:1722-1765).  Comparisons promote as in JAX: an integer image
against a float bound compares in float32.
"""

from __future__ import annotations

import torch

from invesalius3_tpu_torch import constants as const


def _inside(image: torch.Tensor, tmin, tmax) -> torch.Tensor:
    return (image >= tmin) & (image <= tmax)


def _u8(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.uint8, device=like.device)


def threshold_mask(image: torch.Tensor, mask: torch.Tensor,
                   tmin: float, tmax: float) -> torch.Tensor:
    """Re-threshold ``image`` into ``mask``, keeping the editor codes."""
    m = torch.where(_inside(image, tmin, tmax),
                    _u8(const.MASK_THRESHOLD_IN, image), _u8(0, image))
    keep = (mask == 1) | (mask == 2) | (mask == 253) | (mask == 254)
    return torch.where(keep, mask.to(torch.uint8), m)


def threshold_new_mask(image: torch.Tensor, tmin: float, tmax: float) -> torch.Tensor:
    """A fresh threshold mask with no editor history: 255 in range, else 0."""
    return torch.where(_inside(image, tmin, tmax),
                       _u8(const.MASK_THRESHOLD_IN, image), _u8(0, image))


def mask_visible(mask: torch.Tensor) -> torch.Tensor:
    """Visibility of mask voxels: value >= 127 (codes 253/254/255 are on,
    0/1/2 off)."""
    return mask >= const.MASK_VISIBLE_MIN


def apply_threshold_probability(probability: torch.Tensor,
                                threshold: float) -> torch.Tensor:
    """Binarize a probability map into a 0/255 uint8 mask."""
    return torch.where(probability >= threshold, _u8(255, probability),
                       _u8(0, probability))

"""Connected-component labelling, region counting, the largest component
and automatic hole filling (port of invesalius3_tpu/ops/connected.py).

Labels follow the JAX package: every voxel of a component carries the
largest linear index in the component plus 1 (int32, 0 = background).  The
JAX package reaches that by relaxing each voxel's label to its
neighbourhood maximum, with segmented max-scans along the axes, until
nothing changes.  The port computes the same fixpoint by label
equivalence (hook and pointer jumping), which needs far fewer passes over
the volume:

- start from ``lab[v] = v + 1`` on the mask;
- each round, take every voxel's neighbourhood maximum ``best[v]``; where it
  exceeds ``lab[v]``, raise both ``lab[v]`` and the label's representative
  ``lab[lab[v] - 1]`` to it (a scatter of maxima);
- then follow pointers, ``lab[v] = lab[lab[v] - 1]``, until they stop.

Throughout, ``lab[v] - 1`` is a voxel of ``v``'s component and labels only
grow, so a round with no voxel below its neighbourhood maximum leaves each
component one label, which is its largest ``v + 1``: the JAX package's
label array, bit for bit, whatever order the scatters ran in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.ops import floodfill
from invesalius3_tpu_torch.ops.morphology import _offsets, shift_slices, structure_3d


def _jump(flat: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """Follow ``flat[v] - 1`` pointers on ``on`` until they stop."""
    while True:
        nxt = flat.index_select(0, (flat - 1).clamp_min_(0))
        nxt.masked_fill_(~on, 0)
        if torch.equal(nxt, flat):
            return flat
        flat = nxt


def label(mask: torch.Tensor, connectivity: int = 6,
          rounds: Optional[list] = None) -> torch.Tensor:
    """Connected-component labels (int32, 0 = background).

    Labels are *not* compacted to 1..n (they are a representative linear
    index + 1); use ``relabel_sequential``/``count_regions`` for
    scipy-style consecutive labels.  ``rounds``, if given, receives the
    number of hook rounds (one host read each)."""
    on = mask.to(torch.bool).contiguous()
    shape = on.shape
    n = on.numel()
    if n >= 2**31 - 1:
        raise ValueError(f"{n} voxels do not fit int32 labels")
    offs = [o for o in _offsets(structure_3d(connectivity)) if o != (0, 0, 0)]
    pairs = [s for s in (shift_slices(shape, o) for o in offs) if s is not None]
    flat = torch.arange(1, n + 1, dtype=torch.int32, device=on.device)
    on_flat = on.view(-1)
    flat.masked_fill_(~on_flat, 0)
    n_rounds = 0
    while True:
        n_rounds += 1
        lab = flat.view(shape)
        best = lab.clone()
        for dst, src in pairs:
            view = best[dst]
            torch.maximum(view, lab[src], out=view)
        best.masked_fill_(~on, 0)
        best = best.view(-1)
        idx = torch.nonzero(best > flat).squeeze(1)
        if idx.numel() == 0:
            break
        hi = best.index_select(0, idx)
        rep = flat.index_select(0, idx).long() - 1
        flat.scatter_reduce_(0, torch.cat([idx, rep]), torch.cat([hi, hi]), "amax")
        del best, hi, rep, idx
        flat = _jump(flat, on_flat)
    if rounds is not None:
        rounds.append(n_rounds)
    return flat.view(shape)


def relabel_sequential(labels: torch.Tensor) -> Tuple[np.ndarray, int]:
    """Compaction to consecutive labels 1..n in the order of the label
    values, 0 kept (scipy.ndimage.label's convention), computed on the
    labels' device.  Returns (uint32 labels on the host, n)."""
    uniq, inv = torch.unique(labels, sorted=True, return_inverse=True)
    nonzero = uniq != 0
    # rank among the nonzero values, 1-based; 0 stays 0
    rank = torch.cumsum(nonzero.to(torch.int64), 0) * nonzero
    out = rank.to(torch.int32).index_select(0, inv.reshape(-1)).reshape(labels.shape)
    return out.cpu().numpy().view(np.uint32), int(nonzero.sum())


def count_regions(mask: torch.Tensor, connectivity: int = 6,
                  rounds: Optional[list] = None) -> Tuple[np.ndarray, int]:
    """Label and count connected regions (reference count_regions.rs via
    invesalius_rs/__init__.py:108-111)."""
    return relabel_sequential(label(mask, connectivity, rounds))


def _size_table(flat: torch.Tensor) -> torch.Tensor:
    """Voxel count per label value, an (n + 1)-entry int32 table."""
    sizes = torch.zeros(flat.numel() + 1, dtype=torch.int32, device=flat.device)
    ones = torch.ones(1, dtype=torch.int32, device=flat.device).expand(flat.numel())
    return sizes.index_add_(0, flat, ones)


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Voxel count of each voxel's component (same shape as labels, int32,
    0 on the background)."""
    flat = labels.reshape(-1)
    per_voxel = _size_table(flat).index_select(0, flat)
    return per_voxel.masked_fill_(flat <= 0, 0).reshape(labels.shape)


def largest_component(mask: torch.Tensor, connectivity: int = 6,
                      rounds: Optional[list] = None) -> torch.Tensor:
    """Boolean mask of the largest connected component, the lowest label on
    a tie (reference imagedata_utils.py:717 / surface keep-largest)."""
    lab = label(mask, connectivity, rounds)
    sizes = _size_table(lab.reshape(-1))
    sizes[0] = 0
    best = torch.argmax(sizes)
    return (lab == best) & (best > 0)


def fill_holes_automatically(mask: torch.Tensor, max_size: int,
                             connectivity: int = 6,
                             rounds: Optional[list] = None) -> torch.Tensor:
    """Fill background components of at most ``max_size`` voxels with 254.

    Reference semantics (mask.py:519-537 + floodfill.rs:51-94): label the
    inverted visible mask (~(mask > 127)), and set the voxels whose
    background component has 1..max_size voxels to 254.  Components that
    touch the border are filled too, as in the reference."""
    imask = ~(mask > 127)
    lab = label(imask, connectivity, rounds)
    flat = lab.reshape(-1)
    per_voxel = _size_table(flat).index_select(0, flat).reshape(mask.shape)
    fill = imask & (per_voxel > 0) & (per_voxel <= max_size)
    return torch.where(fill, torch.tensor(254, dtype=mask.dtype, device=mask.device),
                       mask)


def select_part(mask: torch.Tensor, seed_zyx: Tuple[int, int, int],
                connectivity: int = 6, checks: Optional[list] = None) -> torch.Tensor:
    """Connected part of the visible mask containing the seed (reference
    styles.py SelectMaskParts: floodfill with t0=253, t1=255)."""
    seeds = floodfill.seeds_to_mask(mask.shape, [seed_zyx], device=mask.device)
    return floodfill.floodfill_threshold(mask, seeds, 253, 255, structure_3d(connectivity),
                                         checks)

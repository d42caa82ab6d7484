"""Marker-based watershed (port of invesalius3_tpu/ops/watershed.py).

The image-foresting transform with the max-arc path cost, solved as a
fixpoint of bidirectional relaxation sweeps along each axis.  (cost, hop
distance) pack into one int32 rank = cost * 2^15 + min(dist, 2^15 - 1), so
the lexicographic compare is one integer compare.  The sweeps run through
``ops.kernels.watershed_sweep`` (the CUDA kernel on a card); everything
else is plain tensor code.  Labels are bit-identical to the JAX package's,
and the multigrid refine loop runs the same number of rounds per level.

The port updates ``rank`` and ``lab`` in place where the JAX package
donated their buffers (``_refine_round``'s ``donate_argnums``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from invesalius3_tpu_torch.ops.kernels import (DIST_BITS, DIST_MAX, INF_RANK,
                                               relax_rank, watershed_sweep)
from invesalius3_tpu_torch.ops.morphology import (morphological_gradient,
                                                  pad_const, shift_nd)
from invesalius3_tpu_torch.ops.windowing import get_lut_value
from invesalius3_tpu_torch.utils import logging as ilog

Sweep = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                 Tuple[torch.Tensor, torch.Tensor]]


# the 26 neighbour offsets, relaxed one by one for 18/26-connectivity
_OFFSETS_26 = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
               for c in (-1, 0, 1) if (a, b, c) != (0, 0, 0)]
# marker dtypes whose every value fits int16
_NARROW_LABELS = (torch.bool, torch.uint8, torch.int8, torch.int16)


def _neighbor_relax(rank, lab, f, offsets):
    for off in offsets:
        cand = relax_rank(shift_nd(rank, off, fill=INF_RANK), f)
        nl = shift_nd(lab, off, fill=0)
        take = cand < rank
        rank = torch.where(take, cand, rank)
        lab = torch.where(take, nl, lab)
    return rank, lab


def _one_round_padded(rank, lab, f, connectivity: int, sweep: Sweep):
    """Six directional sweeps (three bidirectional ones) and the diagonal
    relax for 18/26-connectivity, in place on ``rank`` and ``lab``; returns
    them.  The sharded watershed runs this on ghost-padded Z-slabs
    (``parallel/sharded_ops.py``): the ghost planes take part as sweep
    carries and relax parents, and the caller drops what the round wrote
    into them."""
    for axis in range(3):
        sweep(rank, lab, f, axis)
    if connectivity != 6:
        # diagonal arcs skip the intermediate voxel's f, so the axis sweeps
        # do not cover them (invesalius3_tpu/ops/watershed.py:145)
        r, l = _neighbor_relax(rank, lab, f, _OFFSETS_26)
        rank.copy_(r)
        lab.copy_(l)
    return rank, lab


def _one_round(rank, lab, f, lab0, frozen, connectivity: int, sweep: Sweep):
    """``_one_round_padded``, then the frozen voxels restored.  ``rank`` and
    ``lab`` are updated in place; returns them."""
    _one_round_padded(rank, lab, f, connectivity, sweep)
    rank.masked_fill_(frozen, 0)
    lab.copy_(torch.where(frozen, lab0, lab))
    return rank, lab


def watershed_ift(image: torch.Tensor, markers: torch.Tensor,
                  connectivity: int = 6, sweep: Optional[Sweep] = None
                  ) -> torch.Tensor:
    """Watershed via the image-foresting transform, iterated to the full
    (rank and label) fixpoint.  ``markers`` > 0 are seeds, < 0 frozen
    barriers.  Returns int16 labels (int32 if ``markers`` is int32)."""
    sweep = sweep or watershed_sweep
    f = torch.clamp(image.to(torch.int32), 0, 2**16 - 2).contiguous()
    lab_dtype = torch.int32 if markers.dtype == torch.int32 else torch.int16
    lab0 = markers.to(lab_dtype).contiguous()
    frozen = lab0 != 0
    rank = torch.where(frozen, 0, torch.full_like(f, INF_RANK))
    lab = lab0.clone()
    while True:
        pr, pl = rank.clone(), lab.clone()
        _one_round(rank, lab, f, lab0, frozen, connectivity, sweep)
        if not bool(torch.any(lab != pl) | torch.any(rank != pr)):
            return lab


def watershed(
    image: torch.Tensor,
    markers: torch.Tensor,
    algorithm: str = "Watershed",
    mg_size: Tuple[int, int, int] = (3, 3, 3),
    use_ww_wl: bool = False,
    wl: float = 127.5,
    ww: float = 255.0,
    connectivity: int = 6,
    multigrid_levels: Optional[int] = None,
    sweep: Optional[Sweep] = None,
    rounds: Optional[list] = None,
) -> torch.Tensor:
    """The watershed tool (reference watershed_process.py:19-61).

    "Watershed" floods the morphological gradient of the (optionally
    WW/WL-mapped) image; any other ``algorithm`` floods the image itself.
    ``multigrid_levels`` None picks 2 for volumes of at least 192 voxels a
    side, else 0 (the plain fixpoint).  ``sweep`` replaces the axis sweep
    (``ops.kernels.watershed_sweep_ref`` runs the plain version on a card);
    ``rounds``, if given, receives ``(level shape, rounds)`` per multigrid
    refine, coarse to fine.  Traced (``utils.logging.span``), it is the
    span ``watershed``.
    """
    with ilog.span("watershed", shape=image.shape):
        if use_ww_wl:
            img = get_lut_value(image, ww, wl).to(torch.int32)
        else:
            # in the input dtype first, as the JAX package does (int16 may wrap)
            img = (image - torch.min(image)).to(torch.int32)
        if algorithm == "Watershed":
            img = morphological_gradient(img, mg_size)
        if multigrid_levels is None:
            multigrid_levels = 2 if min(image.shape) >= 192 else 0
        if multigrid_levels > 0:
            return watershed_ift_multigrid(img, markers, connectivity,
                                           multigrid_levels, sweep, rounds)
        return watershed_ift(img, markers, connectivity, sweep)


def _refine_round(rank, lab, f, lab0, frozen, connectivity: int,
                  inner_rounds: int, sweep: Sweep) -> torch.Tensor:
    """``inner_rounds`` rounds on ``rank``/``lab`` in place (the JAX package
    donates both buffers); returns a device flag: did any label change."""
    changed = torch.zeros((), dtype=torch.bool, device=lab.device)
    for _ in range(inner_rounds):
        prev = lab.clone()
        _one_round(rank, lab, f, lab0, frozen, connectivity, sweep)
        changed |= torch.any(lab != prev)
    return changed


def _watershed_refine(f, lab0, rank_init, lab_init, connectivity: int,
                      sweep: Sweep, rounds: Optional[list],
                      max_rounds: int = 1000, quiet_rounds: int = 2,
                      inner_rounds: int = 2):
    """Relaxation from a valid upper bound until ``quiet_rounds``
    consecutive rounds change no label.  The host reads batch i's flag only
    after batch i + 1 is queued (one extra batch after quiescence), exactly
    the JAX package's loop, so the round counts agree.  Traced, a level is
    the span ``watershed.level`` and each flag read the span
    ``watershed.flag_read``, counted as ``watershed.flag_reads``."""
    frozen = lab0 != 0
    rank = torch.where(frozen, 0, rank_init).contiguous()
    lab = torch.where(frozen, lab0, lab_init).contiguous()
    quiet = 0
    quiet_batches = max(1, -(-quiet_rounds // inner_rounds))
    n_rounds = 0
    pending = None
    with ilog.span("watershed.level", shape=f.shape) as level:
        for _ in range(0, max_rounds, inner_rounds):
            changed = _refine_round(rank, lab, f, lab0, frozen, connectivity,
                                    inner_rounds, sweep)
            n_rounds += inner_rounds
            prev, pending = pending, changed
            if prev is None:
                continue
            with ilog.span("watershed.flag_read"):
                moved = bool(prev)
            ilog.count("watershed.flag_reads")
            if moved:
                quiet = 0
            else:
                quiet += 1
                if quiet >= quiet_batches:
                    break
        level.set(rounds=n_rounds)
    if rounds is not None:
        rounds.append((tuple(int(s) for s in f.shape), n_rounds))
    return rank, lab


def _pool2(x: torch.Tensor, fill: int) -> torch.Tensor:
    """Max over 2x2x2 cells, stride 2; odd sides pad at the high end with
    ``fill`` (``reduce_window`` padding "SAME")."""
    pads = [(0, s % 2) for s in x.shape]
    x = pad_const(x, pads, fill)
    Z, Y, X = x.shape
    return x.reshape(Z // 2, 2, Y // 2, 2, X // 2, 2).amax(dim=(1, 3, 5))


def _up2(a: torch.Tensor, shape) -> torch.Tensor:
    Z, Y, X = a.shape
    up = a[:, None, :, None, :, None].expand(Z, 2, Y, 2, X, 2)
    up = up.reshape(2 * Z, 2 * Y, 2 * X)
    return up[: shape[0], : shape[1], : shape[2]]


def watershed_ift_multigrid(image: torch.Tensor, markers: torch.Tensor,
                            connectivity: int = 6, levels: int = 2,
                            sweep: Optional[Sweep] = None,
                            rounds: Optional[list] = None) -> torch.Tensor:
    """Coarse to fine: solve on max-pooled f, upsample the rank as a valid
    upper bound (dist saturated, seed cells bounded by their pooled f),
    then refine.  A pure accelerator: the fine labels are the fixpoint's."""
    sweep = sweep or watershed_sweep
    f = torch.clamp(image.to(torch.int32), 0, 2**16 - 2).contiguous()
    out_dtype = torch.int32 if markers.dtype == torch.int32 else torch.int16
    # labels go through the refine in the markers' width: int16 where every
    # marker (and so every pooled label and the pool's -2^15 fill) fits it,
    # which moves a sixth fewer bytes per sweep than the JAX package's int32
    lab_dtype = torch.int16 if markers.dtype in _NARROW_LABELS else torch.int32
    lab0 = markers.to(lab_dtype).contiguous()

    def solve(f_lvl, lab_lvl, level):
        if level == 0 or min(f_lvl.shape) <= 32:
            rank_init = torch.full_like(f_lvl, INF_RANK)
            return _watershed_refine(f_lvl, lab_lvl, rank_init, lab_lvl,
                                     connectivity, sweep, rounds)
        f_c = _pool2(f_lvl, -(2**31))
        lab_c = _pool2(lab_lvl, -(2**15))
        rank_c, lab_sol_c = solve(f_c, lab_c, level - 1)
        cost_up = _up2(torch.maximum(rank_c >> DIST_BITS, f_c), f_lvl.shape)
        rank_init = torch.where(cost_up >= (INF_RANK >> DIST_BITS), INF_RANK,
                                cost_up * (1 << DIST_BITS) + DIST_MAX)
        lab_init = _up2(lab_sol_c, f_lvl.shape)
        return _watershed_refine(f_lvl, lab_lvl, rank_init, lab_init,
                                 connectivity, sweep, rounds)

    _, lab = solve(f, lab0, levels)
    return lab.to(out_dtype)

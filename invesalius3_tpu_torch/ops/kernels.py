"""The watershed sweep: the hand-written CUDA kernel and its plain version.

``watershed_sweep`` is the port of the TPU kernels ``watershed_sweep_z`` and
``watershed_sweep_y`` (invesalius3_tpu/ops/pallas_kernels.py:259,289), and of
the X sweep that reused the Y kernel on swapped axes
(invesalius3_tpu/ops/watershed.py:256).  One bidirectional minimax sweep
along ``axis`` updates the packed rank and the labels in place.  A CUDA
tensor goes through ``csrc/watershed_sweep.cu`` (the streaming kernel along
z and y, the shared-memory tiled kernel along x); only a CPU tensor takes
the plain version, ``watershed_sweep_ref``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

DIST_BITS = 15
DIST_MAX = (1 << DIST_BITS) - 1
INF_RANK = 2**31 - 1

# kernel launches per sweep axis; incremented only where the CUDA kernel is
# launched (callers reset the counts to measure one run)
LAUNCHES = {0: 0, 1: 0, 2: 0}


def reset_launches() -> None:
    for axis in LAUNCHES:
        LAUNCHES[axis] = 0


def relax_rank(parent_rank: torch.Tensor, f_here: torch.Tensor) -> torch.Tensor:
    """Child candidate rank from a parent rank: cost = max(parent_cost, f),
    dist = parent_dist + 1 (saturating); parents at INF stay INF."""
    cost = torch.maximum(parent_rank >> DIST_BITS, f_here)
    dist = torch.clamp((parent_rank & DIST_MAX) + 1, max=DIST_MAX)
    cand = cost * (1 << DIST_BITS) + dist
    return torch.where(parent_rank == INF_RANK, INF_RANK, cand)


def watershed_sweep_ref(rank: torch.Tensor, lab: torch.Tensor,
                        f: torch.Tensor, axis: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch sweep: a forward then a backward pass along ``axis``,
    each step relaxing one slice from its already-updated neighbour (the
    counterpart of two ``_sweep_axis`` passes).  In place; returns
    (rank, lab)."""
    r = rank.movedim(axis, 0)
    l = lab.movedim(axis, 0)
    v = f.movedim(axis, 0)
    n = r.shape[0]

    def step(i: int, j: int) -> None:
        cand = relax_rank(r[j], v[i])
        take = cand < r[i]
        r[i] = torch.where(take, cand, r[i])
        l[i] = torch.where(take, l[j], l[i])

    for i in range(1, n):
        step(i, i - 1)
    for i in range(n - 2, -1, -1):
        step(i, i + 1)
    return rank, lab


def _check(rank: torch.Tensor, lab: torch.Tensor, f: torch.Tensor,
           axis: int) -> None:
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    if rank.dim() != 3 or rank.shape != lab.shape or rank.shape != f.shape:
        raise ValueError("rank, lab and f must be 3-D tensors of one shape, "
                         f"got {tuple(rank.shape)}, {tuple(lab.shape)}, "
                         f"{tuple(f.shape)}")
    if rank.dtype != torch.int32 or f.dtype != torch.int32:
        raise TypeError(f"rank and f must be int32, got {rank.dtype}, {f.dtype}")
    if lab.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"lab must be int16 or int32, got {lab.dtype}")
    if not (rank.device == lab.device == f.device):
        raise ValueError("rank, lab and f must be on one device")


def watershed_sweep(rank: torch.Tensor, lab: torch.Tensor, f: torch.Tensor,
                    axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional minimax sweep along ``axis``, in place; returns
    (rank, lab).  CUDA tensors launch the kernel on the current stream
    (nothing is launched when the axis is shorter than 2: the sweep leaves
    such a volume as it is); CPU tensors take ``watershed_sweep_ref``."""
    _check(rank, lab, f, axis)
    if rank.device.type == "cpu":
        return watershed_sweep_ref(rank, lab, f, axis)
    if rank.device.type != "cuda":
        raise ValueError(f"unsupported device {rank.device}")
    if not (rank.is_contiguous() and lab.is_contiguous() and f.is_contiguous()):
        raise ValueError("the CUDA sweep needs C-contiguous tensors")
    if rank.shape[axis] < 2 or rank.numel() == 0:
        return rank, lab
    from invesalius3_tpu_torch import _build

    lib = _build.watershed_sweep_lib()
    Z, Y, X = rank.shape
    with torch.cuda.device(rank.device):
        stream = torch.cuda.current_stream(rank.device).cuda_stream
        err = lib.ws_sweep(rank.data_ptr(), lab.data_ptr(), f.data_ptr(),
                           Z, Y, X, axis, lab.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"ws_sweep launch failed (axis {axis}, shape "
                           f"{(Z, Y, X)}, {lab.dtype}): error {err}")
    LAUNCHES[axis] += 1
    return rank, lab


# the shapes on which the CUDA kernel is held against the plain version on
# the card (tests/test_torch_cuda.py, chip_smoke.py): x = 130 takes int16
# labels as 4-byte pairs, x = 131 stages them; (3, 5, 2500) and (2100, 3, 5)
# have rays many chunks longer than the X sweep's two-chunk ring; (1, 1, 9),
# (2, 2, 2) and (1, 2, 1) have rays of length 1 and 2; the last two are
# the sharded watershed's ghost-padded slabs at 512^2 (one real plane and
# two ghosts, and 512^3 over 8 shards)
SWEEP_CHECK_SHAPES = [(64, 64, 64), (11, 21, 130), (11, 21, 131), (3, 5, 2500),
                      (2100, 3, 5), (1, 1, 9), (2, 2, 2), (1, 2, 1), (3, 512, 512),
                      (66, 512, 512)]


def sweep_case(shape, lab_dtype, seed: int):
    """A random sweep state (numpy rank, lab, f) for holding the kernel
    against its plain version: f in [0, 1000), two seeds at rank 0, and
    finite upper-bound ranks with random labels on a tenth of the voxels
    (what a multigrid refine starts from); INF elsewhere."""
    r = np.random.default_rng(seed)
    f = r.integers(0, 1000, shape).astype(np.int32)
    lab = np.zeros(shape, lab_dtype)
    rank = np.full(shape, INF_RANK, np.int32)
    upper = r.random(shape) < 0.1
    rank[upper] = r.integers(1000 << DIST_BITS, 1100 << DIST_BITS, int(upper.sum()))
    lab[upper] = r.integers(-3, 7, int(upper.sum()))
    for i, idx in enumerate([(2 % shape[0], 1 % shape[1], 5 % shape[2]),
                             tuple((s - k) % s for s, k in zip(shape, (2, 1, 3)))]):
        rank[idx] = 0
        lab[idx] = i + 1
    return rank, lab, f

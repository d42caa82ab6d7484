"""Plain reference of the watershed tool at the configuration's settings:
the 3^3 morphological gradient, then the image-foresting transform with
the max-arc path cost, solved coarse to fine over max-pooled levels by
bidirectional relaxation
sweeps along z, y and x until labels stop changing.

It follows the published formulation, not any kernel: each sweep walks
one plane at a time, each refine loop runs rounds in pairs and stops one
pair after a pair that changed no label.  (cost, hop distance) pack into
one int32 rank, cost * 2^15 + min(dist, 2^15 - 1), so ties on cost go to
the nearer seed.  Imports torch only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

DIST_BITS = 15
DIST_MAX = (1 << DIST_BITS) - 1
INF = 2**31 - 1
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _box(x: torch.Tensor, fill: int, op) -> torch.Tensor:
    """``op`` over each voxel's 3^3 box, ``fill`` outside the volume."""
    for axis in range(3):
        n = x.shape[axis]
        pad = [0, 0] * 3
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 1
        p = torch.nn.functional.pad(x, pad, value=fill)
        x = op(op(p.narrow(axis, 0, n), p.narrow(axis, 1, n)), p.narrow(axis, 2, n))
    return x


def gradient(image: torch.Tensor) -> torch.Tensor:
    """The morphological gradient (3^3 dilation minus erosion) of the image
    shifted to a zero minimum, as int32."""
    img = image.to(torch.int32)
    img = img - img.min()
    return _box(img, I32_MIN, torch.maximum) - _box(img, I32_MAX, torch.minimum)


def _relax(parent: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    cost = torch.maximum(parent >> DIST_BITS, f)
    dist = torch.clamp((parent & DIST_MAX) + 1, max=DIST_MAX)
    return torch.where(parent == INF, INF, cost * (1 << DIST_BITS) + dist)


def sweep(rank: torch.Tensor, lab: torch.Tensor, f: torch.Tensor, axis: int) -> None:
    """One forward and one backward pass along ``axis``, each plane relaxed
    from its already-updated neighbour; in place."""
    r = rank.movedim(axis, 0).contiguous()
    lb = lab.movedim(axis, 0).contiguous()
    v = f.movedim(axis, 0).contiguous()
    n = r.shape[0]
    order = [(i, i - 1) for i in range(1, n)] + [(i, i + 1) for i in range(n - 2, -1, -1)]
    for i, j in order:
        cand = _relax(r[j], v[i])
        take = cand < r[i]
        r[i] = torch.where(take, cand, r[i])
        lb[i] = torch.where(take, lb[j], lb[i])
    rank.copy_(r.movedim(0, axis))
    lab.copy_(lb.movedim(0, axis))


def _pair(rank, lab, f, lab0, frozen, changed, pair: int) -> None:
    """``pair`` rounds (three sweeps, then the seeds restored) in place;
    ``changed`` (a device bool) becomes: did any label change."""
    changed.zero_()
    before = torch.empty_like(lab)
    for _ in range(pair):
        before.copy_(lab)
        for axis in range(3):
            sweep(rank, lab, f, axis)
        rank.masked_fill_(frozen, 0)
        lab.copy_(torch.where(frozen, lab0, lab))
        changed.logical_or_(torch.any(lab != before))


def refine(f, lab0, rank_init, lab_init, max_rounds: int = 1000, pair: int = 2):
    """Rounds from a valid upper bound, in pairs, until one pair after a
    pair that changed no label.  Returns (rank, labels, rounds run).

    On a card the pairs after the first replay a CUDA graph of the same
    operations: a sweep is thousands of small launches, and the graph
    takes the host's time per launch out of the reference's run."""
    frozen = lab0 != 0
    rank = torch.where(frozen, 0, rank_init).contiguous()
    lab = torch.where(frozen, lab0, lab_init).contiguous()
    changed = torch.zeros((), dtype=torch.bool, device=f.device)
    args = (rank, lab, f, lab0, frozen, changed, pair)
    run_pair = lambda: _pair(*args)  # noqa: E731
    rounds, last, graph = 0, None, None
    for _ in range(0, max_rounds, pair):
        run_pair()
        rounds += pair
        now = bool(changed)
        if last is not None and not last:
            break
        last = now
        if graph is None and f.is_cuda:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                _pair(*args)
            run_pair = graph.replay
    return rank, lab, rounds


def _pool(x: torch.Tensor, fill: int) -> torch.Tensor:
    pads = [s % 2 for s in x.shape]
    if any(pads):
        x = torch.nn.functional.pad(x, (0, pads[2], 0, pads[1], 0, pads[0]), value=fill)
    z, y, w = x.shape
    return x.reshape(z // 2, 2, y // 2, 2, w // 2, 2).amax(dim=(1, 3, 5))


def _up(a: torch.Tensor, shape) -> torch.Tensor:
    up = a.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)
    return up[: shape[0], : shape[1], : shape[2]]


def watershed(image: torch.Tensor, markers: torch.Tensor, levels: int,
              finest_rounds: Optional[int] = None
              ) -> Tuple[torch.Tensor, List[Tuple[Tuple[int, int, int], int]]]:
    """(int32 labels, [(level shape, rounds)] coarse to fine) of the
    watershed of ``image`` from ``markers`` (> 0 seeds), solved first on
    ``levels`` max-pooled levels (a level of side 32 or less is solved
    from scratch).  ``finest_rounds``
    stops the finest level's loop after that many rounds (the control: a
    refine cut short of its fixpoint)."""
    f = torch.clamp(gradient(image), 0, 2**16 - 2).contiguous()
    lab0 = markers.to(torch.int32)
    log: List[Tuple[Tuple[int, int, int], int]] = []

    def solve(f_l, lab_l, level, finest):
        cap = finest_rounds if (finest and finest_rounds is not None) else 1000
        if level == 0 or min(f_l.shape) <= 32:
            rank, lab, n = refine(f_l, lab_l, torch.full_like(f_l, INF), lab_l, cap)
        else:
            f_c, lab_c = _pool(f_l, I32_MIN), _pool(lab_l, -(2**15))
            rank_c, lab_sol = solve(f_c, lab_c, level - 1, False)
            cost = _up(torch.maximum(rank_c >> DIST_BITS, f_c), f_l.shape)
            rank0 = torch.where(cost >= (INF >> DIST_BITS), INF, cost * (1 << DIST_BITS) + DIST_MAX)
            rank, lab, n = refine(f_l, lab_l, rank0, _up(lab_sol, f_l.shape), cap)
        log.append((tuple(int(s) for s in f_l.shape), n))
        return rank, lab

    _, lab = solve(f, lab0, levels, True)
    return lab, log

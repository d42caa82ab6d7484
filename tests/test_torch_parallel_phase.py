"""chip_smoke.py's phases [17] and [18] rehearsed on the CPU at small sizes: the
small cases on two CPU meshes, the sharded watershed through the given and
the plain sweep, and the sharded flow against the single-device path with
the phase's own checks (labels that differ are cost ties, the surface of
the same mask, the smoothed vertices, the face set, the STL bytes)."""

import importlib
import sys

import numpy as np
import pytest
import torch

from invesalius3_tpu_torch import pipeline
from invesalius3_tpu_torch.ops import watershed

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def chip_smoke():
    mod = importlib.import_module("chip_smoke")
    yield mod
    sys.modules.pop("chip_smoke", None)


@pytest.fixture(scope="module")
def phase_17(chip_smoke, tmp_path_factory):
    return chip_smoke.sharded_phase(CPU, tmp_path_factory.mktemp("p17"), n=32, small=32,
                                    ws_n=32, times_4={"h2d": 0.0}, share_limit=0.1)


def test_chip_smoke_phase_17_on_the_cpu(phase_17, chip_smoke):
    out = phase_17
    assert out["launches"] == {0: 0, 1: 0, 2: 0}  # no kernel on the CPU
    assert len(out["halo_bytes"]) == len(out["rounds"])
    assert out["check"]["labels"]["untied"] == 0
    assert out["check"]["max_err_mm"] < chip_smoke.SMOOTH_TOL
    assert out["cuts"][0] == 0 and out["cuts"][-1] == 32


def test_chip_smoke_phase_18_on_the_cpu(phase_17, chip_smoke, tmp_path):
    """Phase [18]'s two ranks over gloo at 32^3 on the CPU: every rank's
    labels, rounds, halo bytes, cuts, checks and the STL equal phase
    [17]'s one-process run (the phase asserts it)."""
    out = chip_smoke.cross_process_phase(CPU, tmp_path, phase_17, n=32)
    assert out["launches"] == {0: 0, 1: 0, 2: 0}  # no kernel on the CPU
    ranks = out["gloo"]
    assert [g["rank"] for g in ranks] == [0, 1] and ranks[0]["backend"] == "gloo"
    assert not ranks[0]["staged"]  # host tensors need no staging
    assert all(w > 0 for w in ranks[0]["wire_bytes"]) and ranks[0]["surface_wire_bytes"] > 0
    assert [bool(g["stl"]) for g in ranks] == [True, False]


def test_label_agreement_finds_untied_voxels(chip_smoke):
    """A voxel whose label is not a cheapest one is reported untied."""
    ct, markers = pipeline.make_ct(24), pipeline.bench_markers(24)
    ct_t, m_t = torch.from_numpy(ct), torch.from_numpy(markers)
    labels = watershed.watershed(ct_t, m_t)
    same = chip_smoke.label_agreement(labels, labels, ct_t, m_t)
    assert same == {"differ": 0, "share": 0.0, "untied": 0}
    wrong = labels.clone()
    wrong[0, 0, 0] = 1 if int(labels[0, 0, 0]) != 1 else 3  # a seed's own corner
    bad = chip_smoke.label_agreement(wrong, labels, ct_t, m_t)
    assert bad["differ"] == 1 and bad["untied"] == 1


def test_cost_maps_are_minimax_costs(chip_smoke):
    """The sweeps' fixpoint is the minimax path cost: a brute-force
    Dijkstra on a small volume gives the same costs."""
    import heapq

    r = np.random.default_rng(2)
    f = r.integers(0, 50, (5, 6, 7)).astype(np.int32)
    markers = np.zeros(f.shape, np.int16)
    markers[1, 2, 3] = 1
    costs = chip_smoke.cost_maps(torch.from_numpy(f), torch.from_numpy(markers), [1])[0].numpy()
    best = np.full(f.shape, np.iinfo(np.int64).max)
    heap = [(0, (1, 2, 3))]
    best[1, 2, 3] = 0
    while heap:
        c, (z, y, x) = heapq.heappop(heap)
        if c > best[z, y, x]:
            continue
        for dz, dy, dx in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)):
            q = (z + dz, y + dy, x + dx)
            if all(0 <= a < s for a, s in zip(q, f.shape)):
                nc = max(c, int(f[q]))
                if nc < best[q]:
                    best[q] = nc
                    heapq.heappush(heap, (nc, q))
    np.testing.assert_array_equal(costs, best)

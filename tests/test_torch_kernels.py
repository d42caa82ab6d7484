"""The port's watershed sweep against the JAX package's scan formulation.

On the CPU the sweep wrapper takes its plain version; the CUDA kernel is
held against that plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.ops import watershed as ws_jax
from invesalius3_tpu_torch.ops import kernels

torch.set_num_threads(1)

INF = 2**31 - 1
# the last three: an odd x (131), and rays of length 1 and 2 along each axis
SHAPES = [(12, 20, 130), (11, 21, 130), (5, 3, 7), (4, 2, 131), (1, 3, 2), (2, 1, 5)]


def _scan_sweep_pair(rank, lab, f, axis):
    """fwd+bwd _sweep_axis passes with merge (the JAX scan reference)."""
    for reverse in (False, True):
        r1, l1 = ws_jax._sweep_axis(rank, lab, f, axis, reverse)
        take = r1 < rank
        rank = jnp.where(take, r1, rank)
        lab = jnp.where(take, l1, lab)
    return np.asarray(rank), np.asarray(lab)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lab_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_ref_matches_jax_scan(axis, lab_dtype, shape):
    rank, lab, f = kernels.sweep_case(shape, lab_dtype, seed=axis)
    want_r, want_l = _scan_sweep_pair(jnp.asarray(rank), jnp.asarray(lab),
                                      jnp.asarray(f), axis)
    tr, tl = torch.from_numpy(rank.copy()), torch.from_numpy(lab.copy())
    got_r, got_l = kernels.watershed_sweep_ref(tr, tl, torch.from_numpy(f), axis)
    assert got_r is tr and got_l is tl  # in place
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got_l.numpy(), want_l)


def _wrapper_takes_the_plain_version(shape, lab_dtype, axis):
    rank, lab, f = kernels.sweep_case(shape, lab_dtype, seed=7)
    want = kernels.watershed_sweep_ref(torch.from_numpy(rank.copy()),
                                       torch.from_numpy(lab.copy()),
                                       torch.from_numpy(f), axis)
    before = dict(kernels.LAUNCHES)
    got = kernels.watershed_sweep(torch.from_numpy(rank.copy()),
                                  torch.from_numpy(lab.copy()),
                                  torch.from_numpy(f), axis)
    assert kernels.LAUNCHES == before  # no kernel launched on the CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_wrapper_on_cpu_takes_the_plain_version(axis):
    _wrapper_takes_the_plain_version((6, 9, 17), np.int32, axis)


@pytest.mark.parametrize("shape", [(4, 2, 131), (1, 3, 2)])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_wrapper_on_cpu_int16_edge_shapes(axis, shape):
    _wrapper_takes_the_plain_version(shape, np.int16, axis)


@pytest.mark.parametrize("bad", ["axis", "rank_dtype", "lab_dtype", "shape"])
def test_sweep_wrapper_rejects_bad_arguments(bad):
    rank = torch.full((4, 5, 6), INF, dtype=torch.int32)
    lab = torch.zeros((4, 5, 6), dtype=torch.int32)
    f = torch.zeros((4, 5, 6), dtype=torch.int32)
    axis = 0
    if bad == "axis":
        axis = 3
    elif bad == "rank_dtype":
        rank = rank.to(torch.int64)
    elif bad == "lab_dtype":
        lab = lab.to(torch.uint8)
    else:
        f = f[:, :4]
    with pytest.raises((ValueError, TypeError)):
        kernels.watershed_sweep(rank, lab, f, axis)

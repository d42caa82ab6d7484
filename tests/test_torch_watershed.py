"""The port's watershed and its prerequisites against the JAX package, on
the same numpy inputs: gradient and window/level exact, labels bit-exact,
and the multigrid refine rounds per level equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.ops import morphology as morph_jax
from invesalius3_tpu.ops import watershed as ws_jax
from invesalius3_tpu.ops import windowing as win_jax
from invesalius3_tpu_torch import pipeline
from invesalius3_tpu_torch.ops import kernels, morphology, watershed, windowing

torch.set_num_threads(1)


@pytest.mark.parametrize("size", [(3, 3, 3), (2, 3, 4), (1, 1, 5)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_morphological_gradient_exact(size, dtype):
    r = np.random.default_rng(sum(size))
    x = r.integers(-3000, 3000, (9, 14, 11)).astype(dtype)
    want = np.asarray(morph_jax.morphological_gradient(jnp.asarray(x), size))
    got = morphology.morphological_gradient(torch.from_numpy(x), size)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("offset", [(1, 0, 0), (0, -2, 0), (1, -1, 3)])
def test_shift_nd_exact(offset):
    x = np.random.default_rng(5).integers(0, 99, (6, 7, 8)).astype(np.int32)
    want = np.asarray(morph_jax.shift_nd(jnp.asarray(x), offset, fill=-7))
    got = morphology.shift_nd(torch.from_numpy(x), offset, fill=-7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ww,wl", [(255.0, 127.5), (400.0, 40.0), (1.5, 0.0)])
def test_get_lut_value_exact(ww, wl):
    x = np.random.default_rng(1).integers(-1024, 3000, (7, 9, 13)).astype(np.int16)
    want = np.asarray(win_jax.get_lut_value(jnp.asarray(x), ww, wl))
    got = windowing.get_lut_value(torch.from_numpy(x), ww, wl)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _phantom(n):
    return pipeline.make_ct(n), pipeline.bench_markers(n)


@pytest.mark.parametrize("levels", [0, 2])
def test_watershed_labels_and_rounds_match_jax(levels):
    """make_ct phantom, bench markers: labels bitwise equal; with the
    multigrid, the same refine rounds at every level."""
    ct, markers = _phantom(40)
    ws_jax.LAST_REFINE_ROUNDS.clear()
    want = np.asarray(ws_jax.watershed(jnp.asarray(ct), jnp.asarray(markers),
                                       multigrid_levels=levels))
    want_rounds = list(ws_jax.LAST_REFINE_ROUNDS)
    rounds = []
    got = watershed.watershed(torch.from_numpy(ct), torch.from_numpy(markers),
                              multigrid_levels=levels, rounds=rounds)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert rounds == want_rounds
    if levels:
        assert [s for s, _ in rounds] == [(20, 20, 20), (40, 40, 40)]
    assert set(np.unique(want)) == {1, 2, 3}


def test_watershed_odd_shape_multigrid_ift_and_barriers():
    """Odd sides (the coarse max-pool pads at the high end), int32 markers
    with a barrier, flooding the image itself ("Watershed (IFT)")."""
    r = np.random.default_rng(11)
    img = r.integers(0, 400, (35, 37, 34)).astype(np.int16)
    markers = np.zeros(img.shape, np.int32)
    markers[3, 4, 5] = 1
    markers[30, 30, 30] = 2
    markers[17, 2:30, 10] = -1
    ws_jax.LAST_REFINE_ROUNDS.clear()
    want = np.asarray(ws_jax.watershed(jnp.asarray(img), jnp.asarray(markers),
                                       algorithm="Watershed (IFT)",
                                       multigrid_levels=2))
    rounds = []
    got = watershed.watershed(torch.from_numpy(img), torch.from_numpy(markers),
                              algorithm="Watershed (IFT)", multigrid_levels=2,
                              rounds=rounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert rounds == list(ws_jax.LAST_REFINE_ROUNDS)


@pytest.mark.parametrize("connectivity", [18, 26])
def test_watershed_ift_diagonal_connectivity(connectivity):
    r = np.random.default_rng(connectivity)
    img = r.integers(0, 50, (9, 10, 11)).astype(np.int32)
    markers = np.zeros(img.shape, np.int16)
    markers[1, 1, 1] = 1
    markers[7, 8, 9] = 2
    want = np.asarray(ws_jax.watershed_ift(jnp.asarray(img), jnp.asarray(markers),
                                           connectivity=connectivity))
    got = watershed.watershed_ift(torch.from_numpy(img),
                                  torch.from_numpy(markers),
                                  connectivity=connectivity)
    np.testing.assert_array_equal(got.numpy(), want)


def test_watershed_ww_wl_branch():
    ct, markers = _phantom(24)
    want = np.asarray(ws_jax.watershed(jnp.asarray(ct), jnp.asarray(markers),
                                       use_ww_wl=True, wl=300.0, ww=1500.0))
    got = watershed.watershed(torch.from_numpy(ct), torch.from_numpy(markers),
                              use_ww_wl=True, wl=300.0, ww=1500.0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("marker_dtype", [np.int16, np.int32])
def test_multigrid_carries_labels_in_the_markers_dtype(marker_dtype):
    """The refine loop carries int16 labels for int16 markers (the JAX
    package carries int32) and int32 for int32 markers; labels and refine
    rounds per level equal the JAX package's on an odd shape."""
    ct = pipeline.make_ct(38)[:, 1:, 3:]                    # (38, 37, 35)
    markers = np.zeros(ct.shape, marker_dtype)
    markers[19, 18, 23] = 1
    markers[19, 18, 17] = 2
    markers[2, 2, 2] = 3
    markers[30, 5, 7] = -1
    ws_jax.LAST_REFINE_ROUNDS.clear()
    want = np.asarray(ws_jax.watershed(jnp.asarray(ct), jnp.asarray(markers),
                                       multigrid_levels=2))
    seen = set()

    def sweep(rank, lab, f, axis):
        seen.add(lab.dtype)
        return kernels.watershed_sweep(rank, lab, f, axis)

    rounds = []
    got = watershed.watershed(torch.from_numpy(ct), torch.from_numpy(markers),
                              multigrid_levels=2, sweep=sweep, rounds=rounds)
    assert seen == {getattr(torch, np.dtype(marker_dtype).name)}
    assert got.dtype == seen.pop()
    np.testing.assert_array_equal(got.numpy(), want)
    assert rounds == list(ws_jax.LAST_REFINE_ROUNDS)
    # the coarse level (min side <= 32) solves from scratch; odd sides pool
    assert [s for s, _ in rounds] == [(19, 19, 18), (38, 37, 35)]

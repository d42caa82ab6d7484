"""The port's Voronoi labeling (``ops/voronoi.py``) against the JAX
package on the same seeded sites: owners bit for bit, distances within a
relative 1e-6 (they are equal in fact: every squared distance is an exact
float32 integer), duplicate and out-of-range sites included; both
``floodfill_voronoi`` distances and ``jump_flooding_normalized``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.ops import voronoi as voronoi_jax
from invesalius3_tpu_torch.ops import voronoi

torch.set_num_threads(1)


def _sites(shape, n, seed, extra=()):
    rng = np.random.default_rng(seed)
    s = np.stack([rng.integers(0, d, n) for d in shape], axis=1).astype(np.int32)
    return np.concatenate([s, np.asarray(extra, np.int32).reshape(-1, 3)]) if extra else s


CASES = {
    # the JAX package's own exactness case (tests/test_editor_ops.py)
    "16^3, 5 sites": ((16, 16, 16),
                      np.random.default_rng(4).integers(0, 16, (5, 3)).astype(np.int32)),
    "20x24x18, 12 sites": ((20, 24, 18), _sites((20, 24, 18), 12, 1)),
    "32^3, 40 sites": ((32, 32, 32), _sites((32, 32, 32), 40, 2)),
    # a duplicate (the larger id wins its voxel) and rows outside the volume
    "duplicates and out-of-range": ((17, 19, 23), _sites(
        (17, 19, 23), 6, 3, extra=[(5, 5, 5), (5, 5, 5), (-1, 2, 3), (3, 19, 0),
                                   (16, 18, 22), (100, 0, 0)])),
    "one site": ((9, 13, 11), np.array([[4, 6, 5]], np.int32)),
    "all out of range": ((8, 8, 8), np.array([[-1, 0, 0], [0, 8, 0]], np.int32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jump_flooding_matches_jax(case):
    shape, sites = CASES[case]
    owners, dist = voronoi.jump_flooding(shape, sites, device="cpu")
    want_o, want_d = voronoi_jax.jump_flooding(jnp.zeros(shape, jnp.uint8), jnp.asarray(sites))
    assert owners.dtype == torch.int32 and dist.dtype == torch.float32
    assert tuple(owners.shape) == shape
    np.testing.assert_array_equal(owners.numpy(), np.asarray(want_o))
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_d), rtol=1e-6, atol=0)


def test_jump_flooding_accepts_an_array_for_its_shape():
    shape, sites = CASES["16^3, 5 sites"]
    a, _ = voronoi.jump_flooding(np.zeros(shape, np.uint8), sites, device="cpu")
    b, _ = voronoi.jump_flooding(shape, torch.from_numpy(sites), device="cpu")
    assert torch.equal(a, b)


def test_jump_flooding_is_exact_on_decided_voxels():
    """The JAX test's oracle (its case): JFA equals the exact Voronoi
    partition on every voxel whose two nearest sites are at different
    distances; each distance is the one to the owner's site."""
    shape, sites = CASES["16^3, 5 sites"]
    owners, dist = voronoi.jump_flooding(shape, sites, device="cpu")
    owners = owners.numpy()
    zz, yy, xx = np.mgrid[:16, :16, :16]
    d2 = np.stack([(zz - s[0]) ** 2 + (yy - s[1]) ** 2 + (xx - s[2]) ** 2 for s in sites])
    order = np.sort(d2, axis=0)
    decided = order[0] != order[1]
    np.testing.assert_array_equal(owners[decided], (np.argmin(d2, axis=0) + 1)[decided])
    own_d2 = np.take_along_axis(d2, owners[None] - 1, axis=0)[0]
    np.testing.assert_array_equal(dist.numpy(), np.sqrt(own_d2).astype(np.float32))


def test_jump_flooding_slabs_change_nothing(monkeypatch):
    shape, sites = CASES["20x24x18, 12 sites"]
    whole = voronoi.jump_flooding(shape, sites, device="cpu")
    monkeypatch.setattr(voronoi, "_SLAB_VOXELS", 24 * 18 * 3)  # slabs of 3 rows
    sliced = voronoi.jump_flooding(shape, sites, device="cpu")
    assert torch.equal(whole[0], sliced[0]) and torch.equal(whole[1], sliced[1])


@pytest.mark.parametrize("case", ["32^3, 40 sites", "duplicates and out-of-range"])
def test_square_roots_in_every_round_change_nothing(case, monkeypatch):
    """The rounds compare squared distances below 2^22 and float32 roots
    above (volumes past 1182 a side); both give the same owners."""
    shape, sites = CASES[case]
    squares = voronoi.jump_flooding(shape, sites, device="cpu")
    monkeypatch.setattr(voronoi, "_SQUARES_BELOW", 0)
    roots = voronoi.jump_flooding(shape, sites, device="cpu")
    assert torch.equal(squares[0], roots[0]) and torch.equal(squares[1], roots[1])


@pytest.mark.parametrize("case", ["20x24x18, 12 sites", "duplicates and out-of-range"])
def test_jump_flooding_normalized_matches_jax(case):
    shape, sites = CASES[case]
    owners, dist = voronoi.jump_flooding_normalized(shape, sites, device="cpu")
    want_o, want_d = voronoi_jax.jump_flooding_normalized(jnp.zeros(shape, jnp.uint8),
                                                          jnp.asarray(sites))
    np.testing.assert_array_equal(owners, want_o)
    assert dist.dtype == np.float32 and dist.max() == 1.0
    np.testing.assert_allclose(dist, want_d, rtol=1e-6, atol=0)


@pytest.mark.parametrize("distance_fn", [0, 1])
@pytest.mark.parametrize("case", ["16^3, 5 sites", "duplicates and out-of-range"])
def test_floodfill_voronoi_matches_jax(case, distance_fn):
    shape, sites = CASES[case]
    owners, dist = voronoi.floodfill_voronoi(shape, sites, distance_fn, device="cpu")
    want_o, want_d = voronoi_jax.floodfill_voronoi(shape, sites, distance_fn)
    np.testing.assert_array_equal(owners, want_o)
    assert dist.dtype == want_d.dtype == np.float32
    np.testing.assert_allclose(dist, want_d, rtol=1e-6, atol=0)

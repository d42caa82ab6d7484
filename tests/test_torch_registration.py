"""The port's registration math (``ops/registration.py``) against the JAX
package on the same seeded points: the float64 host functions within
1e-12, ``apply_affine`` within 1e-5, and ICP with the same matched targets
at every iteration, its matrix within 1e-5 and its RMS error within 1e-5
mm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.ops import registration as registration_jax
from invesalius3_tpu.ops import transforms as transforms_jax
from invesalius3_tpu_torch.ops import registration

torch.set_num_threads(1)

SEEDS = [0, 1, 2]


def _rigid(seed, scale=0.3, shift=10.0):
    rng = np.random.default_rng(seed)
    m = transforms_jax.euler_matrix(*rng.uniform(-scale, scale, 3))
    m[:3, 3] = rng.uniform(-shift, shift, 3)
    return m


@pytest.mark.parametrize("seed", SEEDS)
def test_base_creation(seed):
    fids = np.random.default_rng(seed).normal(size=(3, 3)) * 40
    m, q = registration.base_creation(fids)
    want_m, want_q = registration_jax.base_creation(fids)
    np.testing.assert_allclose(m, want_m, rtol=0, atol=1e-12)
    np.testing.assert_allclose(q, want_q, rtol=0, atol=1e-12)
    np.testing.assert_allclose(m.T @ m, np.eye(3), atol=1e-9)


def test_base_creation_with_p3_above_p1():
    """p3 - p1 perpendicular to p2 - p1: q is p1 and g1 falls back to p2 - q."""
    fids = np.array([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0], [0.0, 7.0, 0.0]])
    m, q = registration.base_creation(fids)
    want_m, want_q = registration_jax.base_creation(fids)
    np.testing.assert_allclose(m, want_m, rtol=0, atol=1e-12)
    np.testing.assert_allclose(q, want_q, rtol=0, atol=1e-12)


@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_estimate_rigid_transform_and_fre(seed, reflect):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(5, 3)) * 50
    dst = (np.c_[src, np.ones(5)] @ _rigid(seed).T)[:, :3] + rng.normal(0, 0.5, (5, 3))
    if reflect:  # a mirrored target: the SVD's sign rule keeps a rotation
        dst[:, 0] *= -1
    m = registration.estimate_rigid_transform(src, dst)
    want = registration_jax.estimate_rigid_transform(src, dst)
    np.testing.assert_allclose(m, want, rtol=0, atol=1e-12)
    assert np.linalg.det(m[:3, :3]) > 0
    fre = registration.calculate_fre(src, dst, m)
    assert isinstance(fre, float)
    np.testing.assert_allclose(fre, registration_jax.calculate_fre(src, dst, want),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_object_registration(seed):
    rng = np.random.default_rng(seed)
    fids = rng.normal(size=(4, 6)) * 30
    orients = rng.uniform(-90, 90, (4, 3))
    coord_raw = np.c_[rng.normal(size=(3, 3)) * 50, rng.uniform(-180, 180, (3, 3))]
    got = registration.object_registration(fids, orients, coord_raw, np.eye(4))
    want = registration_jax.object_registration(fids, orients, coord_raw, np.eye(4))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(7, 3), (2, 5, 3)])
def test_apply_affine(shape):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=shape).astype(np.float32) * 40
    m = _rigid(3)
    m[3] = [1e-3, -2e-3, 5e-4, 1.0]  # a projective row: the divide matters
    got = registration.apply_affine(m, torch.from_numpy(pts))
    want = np.asarray(registration_jax.apply_affine(jnp.asarray(m, jnp.float32),
                                                    jnp.asarray(pts)))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_icp_matches(source, target, max_iterations=50, tolerance=1e-5):
    """The JAX package's ``icp`` loop step by step, recording each
    iteration's matched target indices (its nearest-neighbour search as it
    stands there)."""

    @jax.jit
    def nearest(src_pts, tgt_pts):
        d2 = (jnp.sum(src_pts ** 2, axis=1)[:, None] - 2.0 * src_pts @ tgt_pts.T
              + jnp.sum(tgt_pts ** 2, axis=1)[None, :])
        idx = jnp.argmin(d2, axis=1)
        return idx, tgt_pts[idx], jnp.sqrt(jnp.maximum(jnp.min(d2, axis=1), 0.0))

    src = jnp.asarray(source, jnp.float32)
    tgt = jnp.asarray(target, jnp.float32)
    m_total = np.eye(4)
    cur = np.asarray(registration_jax.apply_affine(jnp.asarray(m_total, jnp.float32), src))
    prev_err, history = np.inf, []
    for _ in range(max_iterations):
        idx, matched, dists = nearest(jnp.asarray(cur), tgt)
        history.append(np.asarray(idx))
        err = float(jnp.sqrt(jnp.mean(dists ** 2)))
        m_total = registration_jax.estimate_rigid_transform(cur, np.asarray(matched)) @ m_total
        cur = np.asarray(registration_jax.apply_affine(jnp.asarray(m_total, jnp.float32), src))
        if abs(prev_err - err) < tolerance:
            break
        prev_err = err
    return m_total, prev_err, history


@pytest.mark.parametrize("seed", SEEDS)
def test_icp_matches_jax_at_every_iteration(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    # a cloud near the origin: the expanded distance |s|^2 - 2 s.t + |t|^2
    # cancels less there, so the RMS error's float32 noise stays far below
    # the stopping tolerance and both loops stop at the same iteration
    target = rng.normal(size=(600, 3)).astype(np.float32) * 4
    pick = rng.choice(600, 150, replace=False)
    m_true = _rigid(seed + 10, scale=0.08, shift=0.3)
    source = ((np.c_[target[pick], np.ones(150)] @ np.linalg.inv(m_true).T)[:, :3]
              + rng.normal(0, 0.02, (150, 3)))
    want_m, want_err, want_hist = _jax_icp_matches(source, target)
    m_jax, err_jax = registration_jax.icp(source, target)
    np.testing.assert_array_equal(want_m, m_jax)  # the replica is the JAX loop
    assert want_err == err_jax

    hist = []
    m, err = registration.icp(source, target, device="cpu", history=hist)
    assert len(hist) == len(want_hist) > 2
    for k, (got, want) in enumerate(zip(hist, want_hist)):
        np.testing.assert_array_equal(got, want, err_msg=f"iteration {k}")
    np.testing.assert_allclose(m, want_m, rtol=0, atol=1e-5)
    # the RMS error of a 0.03 mm fit carries the expanded form's float32
    # cancellation (|s|^2 near 50, an ulp of 4e-6): within 1e-5 mm
    np.testing.assert_allclose(err, want_err, rtol=0, atol=1e-5)
    np.testing.assert_allclose(m, m_true, rtol=0, atol=0.02)

    # targets taken a chunk at a time: the same matches
    monkeypatch.setattr(registration, "_ICP_TARGET_CHUNK", 150 * 64)
    hist2 = []
    m2, _ = registration.icp(source, target, device="cpu", history=hist2)
    assert all(np.array_equal(a, b) for a, b in zip(hist, hist2))
    np.testing.assert_array_equal(m, m2)


def test_icp_first_target_wins_a_tie():
    target = np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    source = np.zeros((1, 3), np.float32)
    hist = []
    registration.icp(source, target, max_iterations=1, device="cpu", history=hist)
    assert hist[0].tolist() == [0]


def test_icp_converges():
    """The JAX package's ICP test on the port."""
    rng = np.random.default_rng(0)
    rng.normal(size=(4, 3))  # the JAX test module draws these first
    pts = rng.normal(size=(200, 3)) * 30
    m_true = transforms_jax.euler_matrix(0.05, 0.1, -0.08)
    m_true[:3, 3] = [2.0, -1.0, 1.5]
    moved = (np.c_[pts, np.ones(len(pts))] @ m_true.T)[:, :3]
    m_est, _ = registration.icp(pts, moved, max_iterations=60, device="cpu")
    got = (np.c_[pts, np.ones(len(pts))] @ m_est.T)[:, :3]
    assert np.abs(got - moved).max() < 0.2

"""The port's tractography (``navigation/tractography.py``) against the JAX
package on the same seeded fields.

``sh_basis`` agrees within 1e-5 for lmax 0-8; deterministic tracking gives
paths within 1e-5 voxel and equal validity.  The probabilistic tracker
cannot draw JAX's threefry stream, so the JAX draws are rebuilt on the CPU
from the same key, in the order the JAX tracker splits it, and handed to
the port (``TrackDraws``): then every step makes the same choice (paths
within 1e-5 voxel, which no other candidate comes near) and validity is
equal.  The port's own draws (a ``torch.Generator``) are held to the JAX
tests' statistical bounds.
"""

import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.navigation import tractography as tract_jax
from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.navigation import tractography as tract

torch.set_num_threads(1)


def _fib_dirs(n):
    i = np.arange(n)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(1.0 - z * z)
    return np.stack([z, r * np.sin(phi), r * np.cos(phi)], axis=-1)


def _z_fod(lmax=4, sharp=8.0):
    """SH coefficients of an FOD peaked along +/-z (the JAX tests' helper)."""
    dirs = _fib_dirs(4096)
    f = np.exp(sharp * (dirs[:, 0] ** 2 - 1.0))
    B = np.asarray(tract_jax.sh_basis(jnp.asarray(dirs, jnp.float32), lmax))
    return (B.T @ f) * (4 * np.pi / 4096)


def _fod_volume(shape, lmax, seed=0, noise=0.05):
    coef = _z_fod(lmax)
    rng = np.random.default_rng(seed)
    return (coef + noise * rng.normal(size=shape + (len(coef),))).astype(np.float32)


@pytest.mark.parametrize("lmax", [0, 2, 4, 6, 8])
def test_sh_basis(lmax):
    rng = np.random.default_rng(lmax)
    dirs = np.concatenate([_fib_dirs(500), [[1, 0, 0], [-1, 0, 0], [0, 0, 1]],
                           rng.normal(size=(50, 3))])
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    got = tract.sh_basis(torch.from_numpy(dirs), lmax)
    want = np.asarray(tract_jax.sh_basis(jnp.asarray(dirs), lmax))
    assert tuple(got.shape) == (len(dirs), tract.n_sh_coefficients(lmax))
    assert tract.n_sh_coefficients(lmax) == tract_jax.n_sh_coefficients(lmax)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_sh_basis_orthonormal():
    """The JAX test: columns orthonormal over the sphere, Y_00 constant."""
    dirs = torch.from_numpy(_fib_dirs(8192).astype(np.float32))
    B = tract.sh_basis(dirs, 4).numpy().astype(np.float64)
    gram = B.T @ B * (4 * np.pi / 8192)
    np.testing.assert_allclose(gram, np.eye(15), atol=2e-2)
    np.testing.assert_allclose(B[:, 0], 1.0 / (2 * np.sqrt(np.pi)), rtol=1e-5)


def _direction_field(shape, seed):
    """Unit directions near +z with a seeded wobble, (z, y, x) components."""
    rng = np.random.default_rng(seed)
    d = np.zeros(shape + (3,))
    d[..., 0] = 1.0
    d += 0.4 * rng.normal(size=d.shape)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_track_streamlines_matches_jax(seed):
    shape = (28, 14, 16)
    field = _direction_field(shape, seed)
    mask = np.ones(shape, bool)
    mask[22:] = False
    mask[:, :2] = False
    rng = np.random.default_rng(seed + 5)
    seeds = np.c_[rng.uniform(3, 8, 20), rng.uniform(4, 10, 20), rng.uniform(4, 12, 20)]
    seeds = seeds.astype(np.float32)
    paths, valid = tract.track_streamlines(field, mask, seeds, 0.5, 40, device="cpu")
    want_p, want_v = tract_jax.track_streamlines(jnp.asarray(field), jnp.asarray(mask),
                                                 jnp.asarray(seeds), 0.5, 40)
    assert tuple(paths.shape) == (41, 20, 3) and paths.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(paths.numpy(), np.asarray(want_p), rtol=0, atol=1e-5)
    assert not valid[-1].all() and valid[0].all()  # some reached the mask's edge


def test_track_streamlines_straight_and_stopped():
    """The JAX test: a uniform +x field goes straight; the mask stops it."""
    field = np.zeros((16, 16, 32, 3), np.float32)
    field[..., 2] = 1.0
    mask = np.ones((16, 16, 32), bool)
    seeds = np.tile(np.array([[8.0, 8.0, 4.0]], np.float32), (5, 1))
    paths, _ = tract.track_streamlines(field, mask, seeds, 1.0, 10, device="cpu")
    np.testing.assert_allclose(paths[-1, 0].numpy(), [8.0, 8.0, 14.0], atol=1e-4)
    mask[:, :, 8:] = False
    paths, _ = tract.track_streamlines(field, mask, seeds, 1.0, 10, device="cpu")
    assert paths[-1, 0, 2] <= 8.0


def _jax_draws(key, n_seeds, n_steps, k):
    """The JAX tracker's draws from ``key``, in its order: split off the
    init key, a Gumbel over the 64 sphere directions, split the rest into
    n_steps keys; per step (kc, ks) = split, (u, phi) from split(kc), then
    the Gumbel from ks."""
    kinit, key = jax.random.split(key)
    g0 = jax.random.gumbel(kinit, (n_seeds, 64))
    u, phi, g = [], [], []
    for sk in jax.random.split(key, n_steps):
        kc, ks = jax.random.split(sk)
        k1, k2 = jax.random.split(kc)
        u.append(jax.random.uniform(k1, (n_seeds, k)))
        phi.append(jax.random.uniform(k2, (n_seeds, k), minval=0.0, maxval=2.0 * jnp.pi))
        g.append(jax.random.gumbel(ks, (n_seeds, k)))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return tract.TrackDraws(gumbel0=t(g0), u=t(jnp.stack(u)), phi=t(jnp.stack(phi)),
                            gumbel=t(jnp.stack(g)))


@pytest.mark.parametrize("lmax,n_steps,key", [(4, 16, 0), (8, 12, 1), (2, 8, 2)])
def test_probabilistic_with_the_jax_draws(lmax, n_steps, key):
    shape = (30, 18, 18)
    fod = _fod_volume(shape, lmax, seed=key)
    mask = np.ones(shape, bool)
    mask[:, :, 15:] = False
    rng = np.random.default_rng(key)
    seeds = np.c_[rng.uniform(8, 20, 24), rng.uniform(5, 13, 24),
                  rng.uniform(5, 13, 24)].astype(np.float32)
    k = 16
    jkey = jax.random.PRNGKey(key)
    want_p, want_v = tract_jax.track_streamlines_probabilistic(
        jnp.asarray(fod), jnp.asarray(mask), jnp.asarray(seeds), jkey, step_size=0.5,
        n_steps=n_steps, max_angle=0.4, min_fod_amp=0.05, k_candidates=k, lmax=lmax)
    draws = _jax_draws(jkey, 24, n_steps, k)
    paths, valid = tract.track_streamlines_probabilistic(
        fod, mask, seeds, step_size=0.5, n_steps=n_steps, max_angle=0.4, min_fod_amp=0.05,
        k_candidates=k, lmax=lmax, draws=draws, device="cpu")
    assert tuple(paths.shape) == (n_steps + 1, 24, 3)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(paths.numpy(), np.asarray(want_p), rtol=0, atol=1e-5)
    assert bool(valid[-1].any()) and float((paths[-1] - paths[0]).abs().max()) > 1.0


def test_probabilistic_follows_the_fod():
    """The JAX test's bounds with the port's own draws: streamlines advance
    along z with bounded lateral spread; a zero FOD kills them all."""
    shape = (64, 24, 24)
    coef = _z_fod()
    fod = np.broadcast_to(coef, shape + (len(coef),)).astype(np.float32)
    mask = np.ones(shape, bool)
    seeds = np.tile(np.array([[8.0, 12.0, 12.0]], np.float32), (32, 1))
    gen = torch.Generator().manual_seed(0)
    paths, valid = tract.track_streamlines_probabilistic(
        fod, mask, seeds, gen, step_size=0.5, n_steps=60, max_angle=0.3, min_fod_amp=0.1,
        device="cpu")
    paths, valid = paths.numpy(), valid.numpy()
    assert valid[0].all() and valid[-1].mean() > 0.8
    a = valid[-1]
    dz = np.abs(paths[-1, :, 0] - paths[0, :, 0])
    lateral = np.linalg.norm(paths[-1, :, 1:] - paths[0, :, 1:], axis=1)
    assert (dz[a] > 20).all() and (lateral[a] < dz[a] * 0.6).all()
    _, valid0 = tract.track_streamlines_probabilistic(
        np.zeros_like(fod), mask, seeds, gen, n_steps=8, device="cpu")
    assert not valid0[1:].any()


def test_generator_draws_are_reproducible():
    shape = (20, 12, 12)
    fod = _fod_volume(shape, 4)
    mask = np.ones(shape, bool)
    seeds = np.full((6, 3), 6.0, np.float32)
    run = lambda s: tract.track_streamlines_probabilistic(  # noqa: E731
        fod, mask, seeds, torch.Generator().manual_seed(s), n_steps=10, device="cpu")[0]
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))


def test_compute_tracts_thread_deterministic_matches_jax():
    shape = (20, 12, 12)
    field = _direction_field(shape, 3)
    mask = np.ones(shape, bool)
    kw = dict(direction_field=field, stop_mask=mask, n_tracts_total=8, n_steps=12)
    th = tract.ComputeTractsThread(queue.Queue(), bus=events.Publisher(), device="cpu", **kw)
    want = tract_jax.ComputeTractsThread(queue.Queue(), **kw).compute_once(
        np.array([6.0, 6.0, 6.0]))
    paths, valid = th.compute_once(np.array([6.0, 6.0, 6.0]))
    assert isinstance(paths, np.ndarray) and paths.shape == (13, 8, 3)
    np.testing.assert_array_equal(valid, want[1])
    np.testing.assert_allclose(paths, want[0], rtol=0, atol=1e-5)


def test_compute_tracts_thread_probabilistic_mode():
    """The JAX test on the port: an lmax 4 FOD picks its lmax from the
    coefficient count; the seeded generator makes two threads agree."""
    shape = (32, 16, 16)
    coef = _z_fod()
    fod = np.broadcast_to(coef, shape + (len(coef),)).astype(np.float32)
    make = lambda: tract.ComputeTractsThread(  # noqa: E731
        queue.Queue(), stop_mask=np.ones(shape, bool), fod_sh=fod, n_tracts_total=8,
        n_steps=16, seed=7, device="cpu", bus=events.Publisher())
    paths, valid = make().compute_once(np.array([4.0, 8.0, 8.0]))
    assert paths.shape == (17, 8, 3) and valid[0].all()
    np.testing.assert_array_equal(paths, make().compute_once(np.array([4.0, 8.0, 8.0]))[0])


def test_compute_tracts_thread_publishes_and_stops():
    shape = (12, 10, 10)
    field = np.zeros(shape + (3,), np.float32)
    field[..., 0] = 1.0
    bus = events.Publisher()
    got = []
    bus.subscribe(lambda **kw: got.append(kw), "navigation.tracts")
    q = queue.Queue()
    th = tract.ComputeTractsThread(q, direction_field=field, stop_mask=np.ones(shape, bool),
                                   n_tracts_total=4, n_steps=5, bus=bus, device="cpu",
                                   world_to_vox=lambda p: np.clip(np.asarray(p)[::-1], 1, 8))
    th.start()
    try:
        q.put({"probe_pose_img": np.array([5.0, 5.0, 5.0, 0, 0, 0]), "timestamp": 1.5})
        for _ in range(100):
            if got:
                break
            th.join(timeout=0.05)
    finally:
        th.stop()
        th.join(timeout=5.0)
    assert not th.is_alive()
    assert got and got[0]["paths"].shape == (6, 4, 3) and got[0]["timestamp"] == 1.5
    with pytest.raises(ValueError):
        tract.ComputeTractsThread(q, stop_mask=np.ones(shape, bool), device="cpu")
    with pytest.raises(ValueError):
        tract.ComputeTractsThread(q, direction_field=field, device="cpu")

"""The port's marching tetrahedra, context-aware smoothing and STL writer
against the JAX package, on the same inputs.

Each port stage gets the JAX stage's exact input through
``convert.from_jax_mesh``, which drops the JAX mesh's bucket padding and
its orphan vertex (ids shift down by one).  Marching is exact; the
smoothing's staircase flags, one-ring table, degrees and weights are exact;
the smoothed vertices agree within 1e-4 mm, because the one-ring sums run
in another order in float32; the STL is byte-identical on the same
vertices."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.io import mesh_io as mesh_io_jax
from invesalius3_tpu.ops import marching as marching_jax
from invesalius3_tpu.ops import mesh as mesh_jax
from invesalius3_tpu_torch import convert
from invesalius3_tpu_torch.io import mesh_io
from invesalius3_tpu_torch.ops import marching, mesh

torch.set_num_threads(1)


def _sphere_mask(n, r):
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float64)
    c = (n - 1) / 2.0
    d = np.sqrt((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2)
    return np.where(d <= r, 255, 0).astype(np.uint8)


def _blobs_mask(n, seed):
    """Two overlapping noisy blobs, one touching the border: handles,
    saddles and many marching cases."""
    r = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float64)
    d1 = np.sqrt((zz - 0.4 * n) ** 2 + (yy - 0.45 * n) ** 2 + (xx - 0.5 * n) ** 2)
    d2 = np.sqrt((zz - 0.7 * n) ** 2 + (yy - 0.6 * n) ** 2 + (xx - 0.1 * n) ** 2)
    inside = (d1 < 0.3 * n + r.normal(0, 0.7, d1.shape)) | (d2 < 0.25 * n)
    return np.where(inside, 255, 0).astype(np.uint8)


MASKS = {
    "sphere": lambda: _sphere_mask(20, 7.0),
    "blobs": lambda: _blobs_mask(22, 3),
}


def _shift(jm):
    return 0 if bool(np.asarray(jm.sorted_valid)[0]) else 1


@pytest.mark.parametrize("spacing", [(0.5, 0.5, 0.5), (0.7, 0.9, 1.1)])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_mask_to_surface_matches_jax(name, spacing):
    mask = MASKS[name]()
    jm = marching_jax.mask_to_surface_device(jnp.asarray(mask), spacing=spacing)
    dm = marching.mask_to_surface_device(torch.from_numpy(mask), spacing=spacing)
    s = _shift(jm)
    assert dm.n_tris == jm.n_tris and dm.n_verts == jm.n_verts - s
    np.testing.assert_array_equal(
        convert.to_numpy(dm.faces3t), np.asarray(jm.faces3t)[:, :jm.n_tris] - s)
    np.testing.assert_array_equal(
        convert.to_numpy(dm.verts3v), np.asarray(jm.verts3v)[:, s:jm.n_verts])
    assert dm.vol_shape == tuple(jm.vol_shape)
    # the dedup structure is the JAX structure minus padding and orphan
    ref = convert.from_jax_mesh(jm, device="cpu")
    for field in ("inverse", "order", "group_of_sorted"):
        np.testing.assert_array_equal(convert.to_numpy(getattr(dm, field)),
                                      convert.to_numpy(getattr(ref, field)))
    assert mask.max() == 255 and dm.n_tris > 100


def test_mesh_to_host_fp16_matches_jax():
    mask = _sphere_mask(16, 6.0)
    spacing = (0.7, 0.9, 1.1)
    jm = marching_jax.mask_to_surface_device(jnp.asarray(mask), spacing=spacing)
    s = _shift(jm)
    wv, wf = marching_jax.mesh_to_host(jm, fp16=True)
    v, f = marching.mesh_to_host(convert.from_jax_mesh(jm, device="cpu"))
    np.testing.assert_array_equal(v, wv[s:])
    np.testing.assert_array_equal(f, wf - s)


def _jax_weights(jm, t, tmax, bmin):
    """The JAX package's grid-propagated smoothing weights (its
    ca_smoothing_device up to the Taubin call)."""
    v = jm.verts3v
    normals = mesh_jax._face_normals_3t(v, jm.faces3t)
    flagged = mesh_jax._staircase_core_3t(
        normals, jm.faces3t, jnp.zeros((v.shape[1],), jnp.uint8),
        jnp.float32(t), jnp.asarray([0.0, 0.0, 1.0], jnp.float32))
    sx, sy, sz = jm.spacing
    ox, oy, oz = jm.origin_shift
    vox3v = jnp.stack([(v[2] - oz) / sz, (v[1] - oy) / sy, (v[0] - ox) / sx])
    steps = min(16, int(np.ceil(tmax / min(jm.spacing))))
    grid = mesh_jax._rasterize_seeds(vox3v, flagged, jm.vol_shape)
    grid = mesh_jax._chamfer(grid, (sz, sy, sx), steps)
    w = mesh_jax._grid_weights(grid, vox3v, jnp.float32(tmax), jnp.float32(bmin))
    return np.asarray(flagged), np.asarray(grid), np.asarray(w)


@pytest.mark.parametrize("name", sorted(MASKS))
def test_ca_smoothing_stages_match_jax(name):
    t, tmax, bmin = 0.7, 3.0, 0.5
    jm = marching_jax.mask_to_surface_device(
        jnp.asarray(MASKS[name]()), spacing=(0.5, 0.5, 0.5))
    s, nv = _shift(jm), jm.n_verts
    dm = convert.from_jax_mesh(jm, device="cpu")
    want_flag, want_grid, want_w = _jax_weights(jm, t, tmax, bmin)

    normals = mesh.face_normals_3t(dm.verts3v, dm.faces3t)
    flagged = mesh.staircase_flags(normals, dm.faces3t, dm.n_verts, t)
    np.testing.assert_array_equal(convert.to_numpy(flagged), want_flag[s:nv])
    assert 0 < int(flagged.sum()) < dm.n_verts

    neigh, deg = mesh.adjacency_from_device_mesh(dm)
    want_neigh, want_deg = (np.asarray(a) for a in
                            mesh_jax.adjacency_from_device_mesh(jm))
    np.testing.assert_array_equal(convert.to_numpy(deg), want_deg[s:nv])
    assert neigh.shape[0] == want_neigh.shape[0]
    want_neigh = want_neigh[:, s:nv]
    valid = np.arange(neigh.shape[0])[:, None] < convert.to_numpy(deg)[None, :]
    np.testing.assert_array_equal(convert.to_numpy(neigh)[valid], want_neigh[valid] - s)
    assert (convert.to_numpy(neigh)[~valid] == dm.n_verts).all()

    v = dm.verts3v
    sx, sy, sz = dm.spacing
    ox, oy, oz = dm.origin_shift
    vox3v = torch.stack([(v[2] - oz) / sz, (v[1] - oy) / sy, (v[0] - ox) / sx])
    grid = mesh._rasterize_seeds(vox3v, flagged, dm.vol_shape)
    grid = mesh._chamfer(grid, (sz, sy, sx), 6)
    np.testing.assert_array_equal(convert.to_numpy(grid), want_grid)
    w = mesh._grid_weights(grid, vox3v, torch.tensor(tmax), torch.tensor(bmin))
    np.testing.assert_array_equal(convert.to_numpy(w), want_w[s:nv])


@pytest.mark.parametrize("name", sorted(MASKS))
def test_ca_smoothing_device_matches_jax(name):
    jm = marching_jax.mask_to_surface_device(
        jnp.asarray(MASKS[name]()), spacing=(0.5, 0.5, 0.5))
    s = _shift(jm)
    want = np.asarray(mesh_jax.ca_smoothing_device(jm, 0.7, 3.0, 0.5, 10))
    got = mesh.ca_smoothing_device(convert.from_jax_mesh(jm, device="cpu"), 0.7, 3.0, 0.5, 10)
    want = want[:, s:jm.n_verts]
    np.testing.assert_allclose(convert.to_numpy(got), want, rtol=0, atol=1e-4)
    moved = np.abs(want - np.asarray(jm.verts3v)[:, s:jm.n_verts]).max()
    assert moved > 0.05  # the comparison is of vertices that really moved


def test_adjacency_degree_bound_raises(monkeypatch):
    dm = marching.mask_to_surface_device(torch.from_numpy(_sphere_mask(16, 6.0)))
    monkeypatch.setattr(mesh, "MAX_DEG", 4)
    with pytest.raises(ValueError, match="max_deg"):
        mesh.adjacency_from_device_mesh(dm)


@pytest.mark.parametrize("name", sorted(MASKS))
def test_write_stl_bytes_match_jax(tmp_path, name):
    """The port's writer on JAX's smoothed vertices writes the JAX writer's
    bytes."""
    jm = marching_jax.mask_to_surface_device(
        jnp.asarray(MASKS[name]()), spacing=(0.5, 0.5, 1.0))
    s = _shift(jm)
    out3v = mesh_jax.ca_smoothing_device(jm, 0.7, 3.0, 0.5, 3)
    want_path = tmp_path / "jax.stl"
    mesh_io_jax.write_stl_from_device(want_path,
                                      dataclasses.replace(jm, verts3v=out3v))
    dm = convert.from_jax_mesh(jm, device="cpu")
    dm = dataclasses.replace(dm, verts3v=convert.to_device(
        np.asarray(out3v)[:, s:jm.n_verts], device="cpu"))
    got_path = tmp_path / "port.stl"
    mesh_io.write_stl_from_device(got_path, dm)
    got = got_path.read_bytes()
    assert len(got) == 84 + 50 * dm.n_tris
    assert got == want_path.read_bytes()

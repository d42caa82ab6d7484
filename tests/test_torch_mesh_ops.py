"""The port's mesh post-processing (``ops/mesh.py``) and its QEM decimator
against the JAX package, on the same host meshes.

Meshes are marching surfaces of small masks made from a numpy seed.
Tolerances: normals 1e-6; volume and area relative 1e-5 (float32 sums in
another order); smoothed vertices 1e-4 mm (one-ring sums in another order);
BFS weights 1e-6 (XLA fuses a multiply-add the port rounds twice).
Adjacency tables, staircase flags, boundary loops, filled holes,
components and the decimator's output are exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu import native as native_jax
from invesalius3_tpu.ops import marching as marching_jax
from invesalius3_tpu.ops import mesh as mesh_jax
from invesalius3_tpu_torch import convert, native
from invesalius3_tpu_torch.ops import marching, mesh

torch.set_num_threads(1)


def _ball(shape, centre, r):
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]].astype(np.float64)
    return np.sqrt((zz - centre[0]) ** 2 + (yy - centre[1]) ** 2
                   + (xx - centre[2]) ** 2) <= r


def _masks():
    rng = np.random.default_rng(7)
    noisy = _ball((20, 20, 20), (9.5, 9.5, 9.5), 6.5) | (rng.random((20, 20, 20)) > 0.995)
    two = _ball((22, 18, 26), (8, 8, 7), 5.5) | _ball((22, 18, 26), (12, 9, 19), 4.0)
    cube = np.zeros((16, 16, 16), bool)
    cube[3:12, 4:13, 2:11] = True
    return {"noisy_ball": noisy, "two_blobs": two, "cube": cube}


NAMES = sorted(_masks())


@functools.lru_cache(maxsize=None)
def _mesh(name):
    """(verts (V, 3) float32, faces (F, 3) int32) of the mask's surface."""
    m = np.where(_masks()[name], 255, 0).astype(np.uint8)
    dm = marching.mask_to_surface_device(torch.from_numpy(m), spacing=(0.5, 0.6, 0.7))
    return (np.ascontiguousarray(convert.to_numpy(dm.verts3v).T),
            np.ascontiguousarray(convert.to_numpy(dm.faces3t).T))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", NAMES)
def test_normals_and_mass_properties(name):
    v, f = _mesh(name)
    np.testing.assert_allclose(
        convert.to_numpy(mesh.face_normals(_t(v), _t(f))),
        np.asarray(mesh_jax.face_normals(jnp.asarray(v), jnp.asarray(f))),
        rtol=0, atol=1e-6)
    vol, area = mesh.mass_properties(_t(v), _t(f))
    want_vol, want_area = mesh_jax.mass_properties(jnp.asarray(v), jnp.asarray(f))
    assert vol.dtype == torch.float32 and vol.shape == ()
    np.testing.assert_allclose(float(vol), float(want_vol), rtol=1e-5)
    np.testing.assert_allclose(float(area), float(want_area), rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_vertex_adjacency_host_and_device(name):
    v, f = _mesh(name)
    table, deg = mesh.vertex_adjacency(f, len(v))
    want_table, want_deg = mesh_jax.vertex_adjacency(f, len(v))
    np.testing.assert_array_equal(table, want_table)
    np.testing.assert_array_equal(deg, want_deg)
    table, deg = mesh.vertex_adjacency_fast(f, len(v), device="cpu")
    want_table, want_deg = (np.asarray(a) for a in mesh_jax.vertex_adjacency_fast(f, len(v)))
    assert table.shape == want_table.shape and table.shape[1] % 8 == 0
    np.testing.assert_array_equal(convert.to_numpy(table), want_table)
    np.testing.assert_array_equal(convert.to_numpy(deg), want_deg)


@pytest.mark.parametrize("name", NAMES)
def test_taubin_and_laplacian_smooth(name):
    v, f = _mesh(name)
    table, deg = mesh_jax.vertex_adjacency(f, len(v))
    w = np.random.default_rng(3).uniform(0.5, 1.0, len(v)).astype(np.float32)
    want = np.asarray(mesh_jax.taubin_smooth(v, table, deg, w, 0.5, -0.53, 6))
    got = mesh.taubin_smooth(_t(v), _t(table), _t(deg), _t(w), 0.5, -0.53, 6)
    np.testing.assert_allclose(convert.to_numpy(got), want, rtol=0, atol=1e-4)
    assert np.abs(want - v).max() > 0.01

    want = mesh_jax.laplacian_smooth(v, f, 7, 0.4)
    got = mesh.laplacian_smooth(v, f, 7, 0.4, device="cpu")
    assert got.dtype == np.float32 and got.shape == v.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("orientation", [(0.0, 0.0, 1.0), (0.0, 0.6, 0.8)])
@pytest.mark.parametrize("name", NAMES)
def test_find_staircase_artifacts(name, orientation):
    v, f = _mesh(name)
    normals = np.asarray(mesh_jax.face_normals(jnp.asarray(v), jnp.asarray(f)))
    for t in (0.0, 0.7):
        want = mesh_jax.find_staircase_artifacts(v, f, normals, t, orientation)
        got = mesh.find_staircase_artifacts(v, f, normals, t, orientation, device="cpu")
        np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(v)


@pytest.mark.parametrize("max_iters", [2, 24])
@pytest.mark.parametrize("name", NAMES)
def test_propagate_weights(name, max_iters):
    v, f = _mesh(name)
    table, deg = mesh_jax.vertex_adjacency(f, len(v))
    normals = np.asarray(mesh_jax.face_normals(jnp.asarray(v), jnp.asarray(f)))
    seeds = mesh_jax.find_staircase_artifacts(v, f, normals, 0.7)
    want = mesh_jax.propagate_weights(v, table, deg, seeds, 3.0, 0.5, max_iters)
    got = mesh.propagate_weights(v, table, deg, seeds, 3.0, 0.5, max_iters,
                                 device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got == 1.0).sum() == seeds.sum() and (got < 1.0).any()


@pytest.mark.parametrize("name", NAMES)
def test_ca_smoothing_host(name):
    v, f = _mesh(name)
    want = mesh_jax.ca_smoothing(v, f, 0.7, 3.0, 0.5, 10, 12)
    got = mesh.ca_smoothing(v, f, 0.7, 3.0, 0.5, 10, 12, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(want - v).max() > 0.05


@pytest.mark.parametrize("name", NAMES)
def test_ca_smoothing_device_mesh_propagation(name):
    m = np.where(_masks()[name], 255, 0).astype(np.uint8)
    jm = marching_jax.mask_to_surface_device(jnp.asarray(m), spacing=(0.5, 0.5, 0.5))
    s = 0 if bool(np.asarray(jm.sorted_valid)[0]) else 1
    want = np.asarray(mesh_jax.ca_smoothing_device(
        jm, 0.7, 3.0, 0.5, 10, propagate="mesh"))[:, s:jm.n_verts]
    got = mesh.ca_smoothing_device(convert.from_jax_mesh(jm, device="cpu"),
                                   0.7, 3.0, 0.5, 10, propagate="mesh")
    np.testing.assert_allclose(convert.to_numpy(got), want, rtol=0, atol=1e-4)
    grid = mesh.ca_smoothing_device(convert.from_jax_mesh(jm, device="cpu"),
                                    0.7, 3.0, 0.5, 10, propagate="grid")
    assert not torch.equal(grid, got)  # the option reaches the propagation


def _open_mesh(name):
    """The mesh with a few faces removed: holes of several sizes."""
    v, f = _mesh(name)
    drop = np.zeros(len(f), bool)
    drop[[0, 1, len(f) // 3, len(f) // 2, len(f) // 2 + 1, len(f) // 2 + 2]] = True
    return v, f[~drop]


@pytest.mark.parametrize("hole_size", [300.0, 0.3])
@pytest.mark.parametrize("name", NAMES)
def test_boundary_loops_and_fill_holes(name, hole_size):
    v, f = _open_mesh(name)
    loops = mesh.boundary_loops(f, len(v))
    assert loops == mesh_jax.boundary_loops(f, len(v)) and loops
    got = mesh.fill_holes(v, f, hole_size)
    want = mesh_jax.fill_holes(v, f, hole_size)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert mesh.boundary_loops(got[1], len(got[0])) == mesh_jax.boundary_loops(
        want[1], len(want[0]))


@pytest.mark.parametrize("name", NAMES)
def test_components(name):
    v, f = _mesh(name)
    np.testing.assert_array_equal(mesh.mesh_components(f, len(v)),
                                  mesh_jax.mesh_components(f, len(v)))
    for got, want in [(mesh.keep_largest_component(v, f),
                       mesh_jax.keep_largest_component(v, f)),
                      (mesh.select_components_by_seeds(v, f, [0, len(v) - 1]),
                       mesh_jax.select_components_by_seeds(v, f, [0, len(v) - 1]))]:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    parts, want_parts = mesh.split_components(v, f), mesh_jax.split_components(v, f)
    assert len(parts) == len(want_parts) >= (1 if name == "cube" else 2)
    for (pv, pf), (wv, wf) in zip(parts, want_parts):
        np.testing.assert_array_equal(pv, wv)
        np.testing.assert_array_equal(pf, wf)
    pts = v[[0, len(v) // 2, len(v) - 1]] + 0.01
    np.testing.assert_array_equal(mesh.nearest_vertex(v, pts),
                                  mesh_jax.nearest_vertex(v, pts))


@pytest.mark.parametrize("reduction", [0.1, 0.4, 0.9])
@pytest.mark.parametrize("name", NAMES)
def test_decimate_qem_bit_exact(name, reduction):
    v, f = _mesh(name)
    got = native.decimate_qem(v, f, reduction)
    want = native_jax.decimate_qem(v, f, reduction)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[1]) < len(f)


def test_decimate_qem_rejects_out_of_range_faces():
    v, f = _mesh("cube")
    with pytest.raises(ValueError, match="out of range"):
        native.decimate_qem(v[:-1], f, 0.5)

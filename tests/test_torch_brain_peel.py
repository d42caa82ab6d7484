"""The port's brain peel (``ops/brain_peel.py``), its remesh stages
(``ops/mesh.py``) and the host marching variants against the JAX package,
on the same seeded numpy inputs.

The remesh stages, the host marching variants and every peel's vertices
and faces agree bit for bit (but the winding of zero-area triangles at an
exact iso value, and Taubin on a table wider than 16 rows, within 1e-5
mm: ``test_marching_cubes_host_variant``, ``test_taubin_in_xla_order``).  The peels are compared with the JAX ``Brain``
run on the port's orphan-free surface: ``mask_to_surface`` inside the JAX
brain peel is replaced (pytest ``monkeypatch``) by a wrapper that drops the
JAX mesh's unused padding vertex and shifts the face ids.  The JAX peel
itself keeps that orphan (``test_jax_peel_keeps_its_orphan``).  Intensities
agree within a relative 1e-6: the JAX sampler runs eagerly, each float32
op rounded on its own, while the port's ``trilinear`` fuses its blends as
XLA's compiled code does.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.ops import brain_peel as brain_peel_jax
from invesalius3_tpu.ops import marching as marching_jax
from invesalius3_tpu.ops import mesh as mesh_jax
from invesalius3_tpu_torch.ops import brain_peel, marching, mesh

torch.set_num_threads(1)

SPACING = (1.0, 0.9, 1.1)


def _gyrus(n: int = 30):
    """(image int16, mask uint8): a sphere with angular ridges (thin
    gyri-like features) and an intensity falling off with the radius."""
    c = (n - 1) / 2.0
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(float)
    r = np.sqrt((zz - c) ** 2 + ((yy - c) / 0.9) ** 2 + (xx - c) ** 2)
    theta = np.arctan2(yy - c, xx - c)
    mask = np.where(r < 0.33 * n + 1.5 * np.sin(4 * theta), 255, 0).astype(np.uint8)
    rng = np.random.default_rng(5)
    img = (1200 - r * 40 + rng.normal(0, 5, r.shape)).astype(np.int16)
    return img, mask


@functools.lru_cache(maxsize=None)
def _surface(name: str):
    """A host mesh: the port's surface of a seeded mask."""
    rng = np.random.default_rng(11)
    if name == "gyrus":
        mask = _gyrus(26)[1]
    else:
        mask = np.where(rng.random((14, 16, 12)) > 0.55, 255, 0).astype(np.uint8)
        mask[:, :, :2] = 0
    return marching.mask_to_surface(mask, SPACING, device="cpu")


def _drop_orphan(verts, faces):
    used = np.zeros(len(verts), bool)
    used[np.asarray(faces).ravel()] = True
    if used.all():
        return verts, faces
    assert not used[0] and used[1:].all()
    return verts[1:], faces - 1


SURFACES = ["gyrus", "speckle"]


@pytest.mark.parametrize("name", SURFACES)
def test_vertex_normals_bit_exact(name):
    v, f = _surface(name)
    got = mesh.vertex_normals(v, f)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, mesh_jax.vertex_normals(v, f))


@pytest.mark.parametrize("n_clusters", [50, 400, 3000])
@pytest.mark.parametrize("name", SURFACES)
def test_cluster_remesh_bit_exact(name, n_clusters):
    v, f = _surface(name)
    got_v, got_f = mesh.cluster_remesh(v, f, n_clusters)
    want_v, want_f = mesh_jax.cluster_remesh(v, f, n_clusters)
    assert got_v.dtype == np.float32 and got_f.dtype == np.int32
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("name", SURFACES)
def test_subdivide_linear_bit_exact(name, passes):
    v, f = mesh.cluster_remesh(*_surface(name), 300)
    got_v, got_f = mesh.subdivide_linear(v, f, passes)
    want_v, want_f = mesh_jax.subdivide_linear(v, f, passes)
    assert len(got_f) == 4 ** passes * len(f)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)


@pytest.mark.parametrize("distance", [-1.0, 0.35])
@pytest.mark.parametrize("name", SURFACES)
def test_warp_along_normals_bit_exact(name, distance):
    v, f = _surface(name)
    got = mesh.warp_along_normals(v, f, distance)
    np.testing.assert_array_equal(got, mesh_jax.warp_along_normals(v, f, distance))
    assert np.abs(got - v).max() > 0.1


@pytest.mark.parametrize("name", SURFACES)
def test_taubin_in_xla_order(name):
    """Bit-exact while the one-ring table has at most 16 rows (the gyrus,
    as every peel); the speckle's non-manifold clusters need 24, which XLA
    sums in another order: within 1e-5 mm there."""
    v, f = mesh.cluster_remesh(*_surface(name), 400)
    neigh, deg = mesh_jax.vertex_adjacency_fast(f, len(v))
    want = np.asarray(mesh_jax.taubin_smooth(
        jnp.asarray(v), jnp.asarray(neigh), jnp.asarray(deg),
        jnp.ones(len(v), jnp.float32), 0.5, -0.53, 5))
    got = brain_peel.taubin_xla_order(v, f, 5, torch.device("cpu"))
    assert got.dtype == np.float32 and np.abs(got - v).max() > 0.01
    if np.asarray(neigh).shape[1] <= 16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_mask_to_surface_host_variant():
    img, mask = _gyrus(24)
    got_v, got_f = marching.mask_to_surface(mask, SPACING, device="cpu")
    want_v, want_f = _drop_orphan(*marching_jax.mask_to_surface(mask, SPACING))
    assert got_v.dtype == np.float32 and got_f.dtype == np.int32
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)


@pytest.mark.parametrize("iso", [127.5, 900.0])
def test_marching_cubes_host_variant(iso):
    img, mask = _gyrus(22)
    field = mask if iso == 127.5 else img.astype(np.float32)
    got_v, got_f = marching.marching_cubes(field, iso, SPACING, device="cpu")
    want_v, want_f = _drop_orphan(*marching_jax.marching_cubes(field, iso, SPACING))
    assert len(got_f) > 100
    np.testing.assert_array_equal(got_v, want_v)
    # voxels exactly at the iso value make zero-area triangles (two corners
    # on one point); their winding rests on the sign of a zero normal, so
    # they are compared as vertex sets
    p = got_v.astype(np.float64)[got_f]
    flat = np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=1) == 0
    np.testing.assert_array_equal(got_f[~flat], want_f[~flat])
    np.testing.assert_array_equal(np.sort(got_f[flat], axis=1), np.sort(want_f[flat], axis=1))


def test_mesh_to_host_keeps_float32_when_asked():
    img, _ = _gyrus(20)
    dm = marching.marching_cubes_device(torch.from_numpy(img.astype(np.float32)), 913.3,
                                        SPACING)
    full, faces = marching.mesh_to_host(dm, fp16=False)
    half, faces16 = marching.mesh_to_host(dm)
    np.testing.assert_array_equal(full, dm.verts3v.t().numpy())
    np.testing.assert_array_equal(half, full.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(faces, faces16)
    assert not np.array_equal(half, full)


# ---------------------------------------------------------------------------
# Brain against the JAX Brain on the port's surface
# ---------------------------------------------------------------------------

PEEL_ARGS = dict(n_peels=3, peel_depth_mm=1.5, smooth_iters=3)


@pytest.mark.parametrize("mode", ["remesh", "volume", "none"])
def test_brain_matches_jax(mode, monkeypatch):
    img, mask = _gyrus()
    got = brain_peel.Brain(img, mask, SPACING, regularize=mode, device="cpu", **PEEL_ARGS)
    orig = brain_peel_jax.marching.mask_to_surface
    monkeypatch.setattr(brain_peel_jax.marching, "mask_to_surface",
                        lambda m, spacing=(1.0, 1.0, 1.0), **kw: _drop_orphan(
                            *orig(m, spacing, **kw)))
    want = brain_peel_jax.Brain(img, mask, SPACING, regularize=mode, **PEEL_ARGS)
    assert got.regularize == want.regularize == mode
    assert len(got.peels) == len(want.peels) == 3
    for k, (p, q) in enumerate(zip(got.peels, want.peels)):
        # the volume-space peels come from the JAX marching mesh, whose
        # padding orphan (vertex 0) Taubin leaves alone
        q_verts, q_faces = ((q["verts"], q["faces"]) if mode == "remesh"
                            else _drop_orphan(q["verts"], q["faces"]))
        shift = len(q["verts"]) - len(q_verts)
        assert p["verts"].dtype == np.float32 and p["faces"].dtype == np.int32
        np.testing.assert_array_equal(p["verts"], q_verts, err_msg=f"peel {k}")
        np.testing.assert_array_equal(p["faces"], q_faces, err_msg=f"peel {k}")
        np.testing.assert_allclose(p["intensity"], q["intensity"][shift:], rtol=1e-6,
                                   atol=1e-3, err_msg=f"peel {k}")
        assert p["depth_mm"] == q["depth_mm"] == k * 1.5
    assert set(got.times) >= {"marching", "smooth", "intensity"}
    assert got.get_peel(7) is got.peels[-1]


def test_brain_bool_regularize_maps_to_modes():
    img, mask = _gyrus(16)
    assert brain_peel.Brain(img, mask, n_peels=1, smooth_iters=0, regularize=True,
                            device="cpu").regularize == "volume"
    assert brain_peel.Brain(img, mask, n_peels=1, smooth_iters=0, regularize=False,
                            device="cpu").regularize == "none"


def test_empty_mask_has_no_peels():
    img, mask = _gyrus(12)
    for mode in ("remesh", "volume", "none"):
        b = brain_peel.Brain(img, np.zeros_like(mask), regularize=mode, device="cpu")
        assert b.peels == []


def test_jax_peel_keeps_its_orphan():
    """The departure the port makes: on a sphere, every unpatched JAX peel
    carries one vertex no face uses, at world (-sx, -sy, -sz), the minimum
    of the peel's vertices (it anchors the JAX cluster grid); the port's
    peels have none."""
    zz, yy, xx = np.mgrid[:24, :24, :24].astype(float)
    r = np.sqrt((zz - 11.5) ** 2 + (yy - 11.5) ** 2 + (xx - 11.5) ** 2)
    mask = np.where(r < 8.5, 255, 0).astype(np.uint8)
    img = (1000 - r * 50).astype(np.int16)
    args = dict(n_peels=2, peel_depth_mm=1.5, smooth_iters=2)
    jb = brain_peel_jax.Brain(img, mask, SPACING, **args)
    pb = brain_peel.Brain(img, mask, SPACING, device="cpu", **args)
    assert len(jb.peels) == len(pb.peels) == 2
    for q, p in zip(jb.peels, pb.peels):
        used = np.zeros(len(q["verts"]), bool)
        used[q["faces"].ravel()] = True
        assert (~used).sum() == 1
        orphan = q["verts"][~used][0]
        np.testing.assert_allclose(orphan, [-s for s in SPACING], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(q["verts"].min(axis=0), orphan)
        used = np.zeros(len(p["verts"]), bool)
        used[p["faces"].ravel()] = True
        assert used.all()
        assert (p["verts"].min(axis=0) > 0).all()


def test_peels_are_near_manifold_and_shrink():
    """The JAX package's remesh-quality test on the port's peels (its
    phantom, size and bounds): near-manifold peels with intensities inside
    the image's range, areas falling inward, and less normal roughness than
    the raw erosion peels."""
    n = 48
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(float)
    c = n / 2.0
    r = np.sqrt((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2)
    theta = np.arctan2(yy - c, xx - c)
    mask = np.where(r < 16 + 2.5 * np.sin(4 * theta), 255, 0).astype(np.uint8)
    img = (1200 - r * 40).astype(np.int16)

    def area(v, f):
        v = v.astype(np.float64)
        return 0.5 * np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]),
                                    axis=1).sum()

    def roughness(v, f):
        v64 = v.astype(np.float64)
        fn = np.cross(v64[f[:, 1]] - v64[f[:, 0]], v64[f[:, 2]] - v64[f[:, 0]])
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
        vn = mesh.vertex_normals(v, f)
        return float(1.0 - np.sum(vn[f].transpose(1, 0, 2) * fn[None], axis=2).mean())

    brain = brain_peel.Brain(img, mask, n_peels=3, peel_depth_mm=1.5, device="cpu")
    raw = brain_peel.Brain(img, mask, n_peels=3, peel_depth_mm=1.5, smooth_iters=0,
                           regularize=False, device="cpu")
    assert len(brain.peels) == 3
    areas = []
    for peel in brain.peels:
        v, f = peel["verts"], peel["faces"]
        e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        _, cnt = np.unique(e[:, 0].astype(np.int64) * len(v) + e[:, 1], return_counts=True)
        assert (cnt == 2).mean() > 0.99
        assert peel["intensity"].shape == (len(v),)
        assert img.min() - 1 <= peel["intensity"].min() <= peel["intensity"].max() <= img.max() + 1
        areas.append(area(v, f))
    assert areas[0] > areas[1] > areas[2]
    assert roughness(brain.peels[1]["verts"], brain.peels[1]["faces"]) < 0.5 * roughness(
        raw.peels[1]["verts"], raw.peels[1]["faces"])

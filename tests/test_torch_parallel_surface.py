"""The port's Z-sharded surface extraction and its STL writers against the
JAX package's on the 8-device CPU mesh, on the same seeded numpy masks.

The JAX sharded mesh keeps one padding orphan vertex at id 0 (no face uses
it); the port's has none, as everywhere in the port.  After dropping it
(and shifting the JAX face ids down by one): the Z cuts, the triangle
histogram and the per-shard vertex and triangle counts are equal, the
faces are equal in order, and the vertices agree within 1e-5 (the JAX
host transform rounds twice, the port once, as its single-device
marching does; the port's sharded vertices equal its single-device
``mask_to_surface``'s bit for bit).  The writers' bytes equal ``write_stl``
of the assembled mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.io import mesh_io as mesh_io_jax
from invesalius3_tpu.ops import marching as marching_jax
from invesalius3_tpu.parallel import sharded_ops as sharded_jax
from invesalius3_tpu.parallel.mesh_utils import make_mesh as make_mesh_jax
from invesalius3_tpu_torch.io import mesh_io
from invesalius3_tpu_torch.ops import marching, mesh
from invesalius3_tpu_torch.parallel import sharded_ops
from invesalius3_tpu_torch.parallel.mesh_utils import make_mesh, shard_volume

torch.set_num_threads(1)
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")
SPACING = (0.5, 0.7, 1.1)


@pytest.fixture(scope="module")
def zmesh_jax():
    return make_mesh_jax(8, ("z",))


@pytest.fixture(scope="module")
def zmesh():
    return make_mesh(8, device="cpu")


def drop_orphan(v, f):
    """A JAX mesh without its padding orphan (id 0, used by no face)."""
    used = np.zeros(len(v), bool)
    used[np.asarray(f).ravel()] = True
    if len(v) and not used[0]:
        return np.asarray(v)[1:], np.asarray(f) - 1, True
    return np.asarray(v), np.asarray(f), False


def face_set(f):
    return {tuple(sorted(t)) for t in np.asarray(f).tolist()}


def masks():
    out = {}
    zz, yy, xx = np.mgrid[:16, :20, :20].astype(np.float64)
    d = np.sqrt((zz - 7.5) ** 2 + (yy - 9.5) ** 2 + (xx - 9.5) ** 2)
    out["sphere"] = np.where(d <= 6.5, 255, 0).astype(np.uint8)
    n = 32
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float64)
    d = np.sqrt((zz - 25) ** 2 + (yy - 15.5) ** 2 + (xx - 15.5) ** 2)
    m = np.where(d <= 5.0, 255, 0).astype(np.uint8)
    m[2:4, 4:10, 4:10] = 255  # surface near the top and a blob at the bottom
    out["asymmetric"] = m
    box = np.zeros((16, 18, 18), np.uint8)
    box[4:12, 5:14, 3:15] = 255
    out["box"] = box
    edge = (np.random.default_rng(7).random((24, 10, 12)) > 0.55).astype(np.uint8) * 255
    out["noise-to-the-border"] = edge
    return out


# (mask, balance)
CASES = [("sphere", False), ("asymmetric", False), ("asymmetric", True), ("box", False),
         ("box", True), ("noise-to-the-border", True)]


@pytest.fixture(scope="module")
def runs(zmesh, zmesh_jax):
    out = {}
    for name, balance in CASES:
        m = masks()[name]
        want = sharded_jax.sharded_mask_to_surface(zmesh_jax, jnp.asarray(m), spacing=SPACING,
                                                   balance=balance, return_stats=True)
        got = sharded_ops.sharded_mask_to_surface(zmesh, m, spacing=SPACING, balance=balance,
                                                  return_stats=True)
        out[(name, balance)] = (want, got)
    return out


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-{'bal' if b else 'uni'}" for n, b in CASES])
def test_surface_equals_jax(runs, case):
    (jv, jf, js), (v, f, st) = runs[case]
    jv, jf, had_orphan = drop_orphan(jv, jf)
    assert st["cuts"] == js["cuts"]
    assert st["tri_hist"] == js["tri_hist"]
    checks, jchecks = np.asarray(st["checks"]), np.asarray(js["checks"])
    jchecks[0, 0] -= had_orphan  # shard 0 held the orphan slot
    np.testing.assert_array_equal(checks[:, 0:4], jchecks[:, 0:4])
    assert v.dtype == np.float32 and f.dtype == np.int32
    assert v.shape == jv.shape and f.shape == jf.shape
    np.testing.assert_allclose(v, jv, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(f, jf)


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-{'bal' if b else 'uni'}" for n, b in CASES])
def test_surface_equals_single_device(runs, case):
    _, (v, f, st) = runs[case]
    want_v, want_f = marching.mask_to_surface(masks()[case[0]], spacing=SPACING, device="cpu")
    np.testing.assert_array_equal(v, want_v)
    assert face_set(f) == face_set(want_f) and len(f) == len(want_f)
    # every shard keeps exactly its rows' triangles
    cuts, hist = st["cuts"], np.asarray(st["tri_hist"])
    per = [hist[cuts[s]:cuts[s + 1]].sum() for s in range(8)]
    per[-1] += hist[-1]
    assert [c[1] for c in st["checks"]] == per


def test_balanced_cuts_even_out_the_triangles(runs):
    _, (_, _, st) = runs[("asymmetric", True)]
    lens = np.diff(st["cuts"])
    assert (lens >= 1).all() and lens.sum() == 32 and len(set(lens.tolist())) > 1
    hist = np.asarray(st["tri_hist"])
    uni = [hist[s * 4:(s + 1) * 4].sum() for s in range(8)]
    uni[-1] += hist[32]
    assert max(c[1] for c in st["checks"]) <= max(uni)


def test_surface_is_watertight(runs):
    _, (v, f, _) = runs[("box", True)]
    from collections import Counter

    cnt = Counter()
    for a, b, c in f.tolist():
        for e in ((a, b), (b, c), (c, a)):
            cnt[tuple(sorted(e))] += 1
    assert set(cnt.values()) == {2}
    vol, _ = mesh.mass_properties(torch.from_numpy(v), torch.from_numpy(f))
    want = 8 * 9 * 12 * SPACING[0] * SPACING[1] * SPACING[2]
    assert abs(float(vol) - want) / want < 0.12


def test_count_pass_histograms(zmesh):
    m = masks()["asymmetric"]
    _, _, st = sharded_ops.sharded_mask_to_surface(zmesh, m, return_stats=True)
    field = torch.from_numpy(np.pad(m >= 127, 1))
    tri = marching.triangles_of(marching.cell_corners(field)).sum(dim=(1, 2)).numpy()
    np.testing.assert_array_equal(st["tri_hist"], tri)
    assert sum(st["tri_hist"]) == int(marching.count_triangles(field.to(torch.uint8), 0.5))
    assert set(st) == {"checks", "cuts", "tri_hist", "times"}


def test_parts_stay_on_their_shards(zmesh):
    m = masks()["asymmetric"]
    vsh, fsh, checks, meta = sharded_ops.sharded_mask_to_surface(
        zmesh, shard_volume(m, zmesh), spacing=SPACING, balance=True, return_parts=True)
    assert len(vsh) == len(fsh) == 8 and checks.shape == (8, 5)
    assert [v.shape[1] for v in vsh] == checks[:, 0].tolist()
    assert [x.shape[1] for x in fsh] == checks[:, 1].tolist()
    assert all(x.dtype == torch.int32 for x in fsh)
    assert meta["cuts"][0] == 0 and meta["cuts"][-1] == 32 and not meta["smoothed"]
    assert set(meta["times"]) == {"marching", "smoothing"}


def test_uneven_z_and_huge_volumes_refused(zmesh):
    with pytest.raises(ValueError, match="evenly"):
        sharded_ops.sharded_mask_to_surface(zmesh, np.zeros((12, 4, 4), np.uint8))


@pytest.mark.parametrize("smooth", [None, {"t": 0.7, "tmax": 3.0, "bmin": 0.5, "n_iters": 4}],
                         ids=["raw", "smoothed"])
def test_write_stl_sharded_byte_identical(zmesh, tmp_path, smooth):
    n = 32
    zz, yy, xx = np.mgrid[:n, :n, :n]
    r = np.sqrt((zz - 16) ** 2 + (yy - 16) ** 2 + (xx - 16) ** 2)
    m = ((r < 11) & (r > 6)).astype(np.uint8) * 255
    v, f = sharded_ops.sharded_mask_to_surface(zmesh, m, spacing=SPACING, smooth=smooth,
                                               balance=True)
    vsh, fsh, checks, _ = sharded_ops.sharded_mask_to_surface(
        zmesh, m, spacing=SPACING, smooth=smooth, balance=True, return_parts=True)
    assert int(checks[:, 0].sum()) == len(v) and int(checks[:, 1].sum()) == len(f)
    mesh_io.write_stl(tmp_path / "ref.stl", v, f)
    mesh_io.write_stl_sharded(tmp_path / "pipe.stl", vsh, fsh)
    data = (tmp_path / "pipe.stl").read_bytes()
    assert data == (tmp_path / "ref.stl").read_bytes()
    assert len(data) == 84 + 50 * len(f)


def _device_mesh():
    zz, yy, xx = np.mgrid[:20, :22, :18]
    r = np.sqrt((zz - 10) ** 2 + (yy - 11) ** 2 + (xx - 9) ** 2)
    m = ((r < 8) & (r > 3)).astype(np.uint8) * 255
    return m, marching.mask_to_surface_device(torch.from_numpy(m), spacing=SPACING)


@pytest.mark.parametrize("chunk", [64, 1000, 1 << 20])
def test_write_stl_from_device_with_a_face_stream(tmp_path, chunk):
    """Face chunks streamed on a thread give the bytes of the one-copy path
    (``write_stl`` of the float16-rounded host mesh) and of the JAX
    package's ``write_stl_from_device`` on the same mask."""
    m, dm = _device_mesh()
    stream = mesh_io.DeviceFaceStream(dm, chunk=chunk)
    assert stream.chunk == min(chunk, dm.n_tris)
    mesh_io.write_stl_from_device(tmp_path / "stream.stl", dm, face_stream=stream)
    mesh_io.write_stl_from_device(tmp_path / "default.stl", dm)
    mesh_io.write_stl(tmp_path / "ref.stl", *marching.mesh_to_host(dm))
    jdm = marching_jax.mask_to_surface_device(jnp.asarray(m), spacing=SPACING)
    mesh_io_jax.write_stl_from_device(str(tmp_path / "jax.stl"), jdm)
    data = (tmp_path / "stream.stl").read_bytes()
    assert data == (tmp_path / "default.stl").read_bytes()
    assert data == (tmp_path / "ref.stl").read_bytes()
    assert data == (tmp_path / "jax.stl").read_bytes()


def test_chunk_max_equals_jax():
    m, dm = _device_mesh()
    jdm = marching_jax.mask_to_surface_device(jnp.asarray(m), spacing=SPACING)
    for ch in (64, 1000, dm.n_tris):
        k = -(-dm.n_tris // ch)
        got = mesh_io.chunk_max(dm.faces3t, ch).numpy()
        want = np.asarray(mesh_io_jax.jnp_chunk_max(jdm.faces3t[:, :dm.n_tris], k, ch))
        # the JAX ids count the orphan vertex
        np.testing.assert_array_equal(got, want - 1)
        f = dm.faces3t.numpy()
        assert got.tolist() == [int(f[:, i:i + ch].max()) for i in range(0, dm.n_tris, ch)]


def test_face_stream_surfaces_a_failure(tmp_path):
    """An error on the stream's thread is raised on the consumer's, and a
    face id past the vertices stops the writer."""
    _, dm = _device_mesh()
    bad = marching.DeviceMesh(**{**dm.__dict__, "faces3t": dm.faces3t[:, :, None]})
    with pytest.raises(RuntimeError):
        list(mesh_io.DeviceFaceStream(bad, chunk=100))
    far = marching.DeviceMesh(**{**dm.__dict__, "faces3t": dm.faces3t + dm.n_verts})
    with pytest.raises(RuntimeError, match="out of range"):
        mesh_io.write_stl_from_device(tmp_path / "far.stl", far)

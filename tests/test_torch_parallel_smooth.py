"""The port's fused Z-sharded ca-smoothing and the sharded headline flow,
against the JAX package's sharded smoothing on the 8-device CPU mesh and
the port's own single-device ``ca_smoothing_device``, on the same masks:
the same face set, and the smoothed vertices within 1e-4 mm of both on
every vertex a face uses; ``pipeline.run(shards=...)`` against the JAX
package's sharded watershed and the single-device surface of its mask.

The port rasterises staircase vertices into the chamfer grid at the voxel
its single-device smoother takes (the world coordinate mapped back); the
JAX sharded smoother rounds the lattice coordinate instead.  At spacings
such as (0.6, 0.8, 1.25) mm the two pick different voxels for some
half-voxel vertices, and the JAX sharded output then differs from the JAX
single-device one by about 0.02 mm.  There the port is held to the JAX
single-device smoothing, which it matches."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.ops import marching as marching_jax
from invesalius3_tpu.ops import mesh as mesh_jax
from invesalius3_tpu.parallel import sharded_ops as sharded_jax
from invesalius3_tpu.parallel.mesh_utils import make_mesh as make_mesh_jax
from invesalius3_tpu_torch import pipeline
from invesalius3_tpu_torch.io import mesh_io
from invesalius3_tpu_torch.ops import marching, mesh
from invesalius3_tpu_torch.parallel import sharded_ops
from invesalius3_tpu_torch.parallel.mesh_utils import Sharded, make_mesh

torch.set_num_threads(1)
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")
SMOOTH = {"t": 0.7, "tmax": 3.0, "bmin": 0.5, "n_iters": 10}
TOL = 1e-4  # mm, the JAX tests' tolerance for smoothed vertices


def shell(n=64, cut=40):
    """A spherical shell whose surface lies below ``cut``: over 8 uniform
    shards the top ones are empty."""
    zz, yy, xx = np.mgrid[:n, :n, :n]
    r = np.sqrt((zz - 32) ** 2 + (yy - 32) ** 2 + (xx - 32) ** 2)
    m = ((r < 22) & (r > 14)).astype(np.uint8) * 255
    m[cut:] = 0
    return m


def drop_orphan(v, f):
    used = np.zeros(len(v), bool)
    used[np.asarray(f).ravel()] = True
    if len(v) and not used[0]:
        return np.asarray(v)[1:], np.asarray(f) - 1
    return np.asarray(v), np.asarray(f)


def face_set(f):
    return {tuple(sorted(t)) for t in np.asarray(f).tolist()}


def used_of(v, f):
    used = np.zeros(len(v), bool)
    used[np.asarray(f).ravel()] = True
    return used


def single_device(m, spacing, smooth):
    dm = marching.mask_to_surface_device(torch.from_numpy(m), spacing=spacing)
    out = mesh.ca_smoothing_device(dm, **smooth)
    return out.t().numpy(), dm.faces3t.t().numpy()


def jax_single_device(m, spacing, smooth):
    dm = marching_jax.mask_to_surface_device(jnp.asarray(m), spacing=spacing)
    out3v = mesh_jax.ca_smoothing_device(dm, smooth["t"], smooth["tmax"], smooth["bmin"],
                                         smooth["n_iters"])
    return drop_orphan(*marching_jax.mesh_to_host(dataclasses.replace(dm, verts3v=out3v),
                                                  fp16=False))


# (name, mask, spacing, balance, smoothing parameters)
CASES = [
    ("shell-uniform", shell(), (0.5, 0.5, 0.5), False, SMOOTH),
    ("shell-balanced", shell(), (0.5, 0.5, 0.5), True, SMOOTH),
    ("anisotropic-balanced", shell(48, 30)[:, 4:44, 2:46], (0.6, 0.8, 1.25), True,
     {"t": 0.5, "tmax": 2.5, "bmin": 0.3, "n_iters": 6}),
]


@pytest.fixture(scope="module")
def runs():
    zmesh, zmesh_jax = make_mesh(8, device="cpu"), make_mesh_jax(8, ("z",))
    out = {}
    for name, m, spacing, balance, smooth in CASES:
        jv, jf, js = sharded_jax.sharded_mask_to_surface(
            zmesh_jax, m, spacing=spacing, smooth=smooth, balance=balance, return_stats=True)
        v, f, st = sharded_ops.sharded_mask_to_surface(
            zmesh, m, spacing=spacing, smooth=smooth, balance=balance, return_stats=True)
        single_jax = (jax_single_device(m, spacing, smooth)
                      if name == "anisotropic-balanced" else None)
        raw = marching.mask_to_surface(m, spacing=spacing, device="cpu")[0]
        out[name] = ((jv, jf, js), (v, f, st), single_device(m, spacing, smooth),
                     single_jax, raw)
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_smoothed_equals_jax(runs, name):
    (jv, jf, js), (v, f, st), _, single_jax, _ = runs[name]
    jv, jf = drop_orphan(jv, jf)
    assert st["cuts"] == js["cuts"]
    assert v.shape == jv.shape and f.shape == jf.shape
    np.testing.assert_array_equal(f, jf)
    used = used_of(v, f)
    if single_jax is None:
        assert np.abs(v - jv).max(axis=1)[used].max() < TOL
    else:  # the JAX sharded smoother's voxel rule (above)
        sv, sf = single_jax
        assert face_set(sf) == face_set(f)
        assert np.abs(v - sv).max(axis=1)[used].max() < TOL
        assert np.abs(jv - sv).max(axis=1)[used].max() > 0.01


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_smoothed_equals_single_device(runs, name):
    _, (v, f, _), (sv, sf), _, raw = runs[name]
    assert v.shape == sv.shape and f.shape == sf.shape
    assert face_set(f) == face_set(sf)
    assert np.abs(v - sv).max(axis=1)[used_of(v, f)].max() < TOL
    assert np.abs(v - raw).max() > 0.05  # the smoothing moved the surface


def test_balanced_cuts_even_out_the_triangles(runs):
    _, (_, _, st), _, _, _ = runs["shell-balanced"]
    _, (_, _, uni), _, _, _ = runs["shell-uniform"]
    assert len(set(np.diff(st["cuts"]).tolist())) > 1
    assert [c[1] for c in uni["checks"]][6:] == [0, 0]  # empty top shards
    assert max(c[1] for c in st["checks"]) < max(c[1] for c in uni["checks"])
    assert sum(c[1] for c in st["checks"]) == sum(c[1] for c in uni["checks"])


def test_pipeline_sharded_against_single_device(tmp_path):
    """``pipeline.run(..., shards=make_mesh(8, device="cpu"))`` at 64^3: the
    labels and rounds equal the JAX package's sharded watershed with
    bench.py's settings, the surface of that mask has the single-device
    surface's counts and faces, the smoothed vertices agree within 1e-4 mm,
    and the STL is ``write_stl`` of the assembled parts."""
    ct, markers = pipeline.make_ct(64), pipeline.bench_markers(64)
    rounds = []
    res = pipeline.run(ct, markers, tmp_path / "sharded.stl", device="cpu",
                       shards=make_mesh(8, device="cpu"), rounds=rounds)
    assert isinstance(res.labels, Sharded) and res.mesh is None
    assert rounds == res.watershed_stats["rounds"] and len(rounds) == 1
    assert set(res.times) == {"h2d", "watershed", "mask", "marching", "smoothing", "stl"}
    want, want_rounds = sharded_jax.sharded_watershed(
        make_mesh_jax(8, ("z",)), stop="label", quiet_rounds=2)(
        ct, markers, algorithm="Watershed", debug_rounds=True)
    got = res.labels.gather().numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert rounds == np.asarray(want_rounds)[0].tolist()
    assert set(np.unique(got)) == {1, 2, 3}

    mask = np.where(got == 1, 255, 0).astype(np.uint8)
    sv, sf = single_device(mask, pipeline.SPACING, pipeline.CA_PARAMS)
    vsh, fsh, checks, meta = res.parts
    v = np.concatenate([sharded_ops.shard_world_verts(x) for x in vsh])
    f = np.concatenate([sharded_ops.shard_wound_faces(x) for x in fsh])
    assert v.shape == sv.shape and f.shape == sf.shape
    assert face_set(f) == face_set(sf)
    assert np.abs(v - sv).max(axis=1)[used_of(v, f)].max() < TOL
    assert res.cuts == meta["cuts"] and meta["smoothed"]
    assert checks[:, 1].sum() == len(f)
    mesh_io.write_stl(tmp_path / "ref.stl", v, f)
    assert (tmp_path / "sharded.stl").read_bytes() == (tmp_path / "ref.stl").read_bytes()


def test_pipeline_sharded_needs_an_even_split(tmp_path):
    ct, markers = pipeline.make_ct(16), pipeline.bench_markers(16)
    with pytest.raises(ValueError, match="evenly"):
        pipeline.run(ct[:12], markers[:12], tmp_path / "x.stl", device="cpu",
                     shards=make_mesh(8, device="cpu"))


def test_single_device_smoothing_equals_jax_at_anisotropic_spacing():
    """The port's single-device grid smoothing at (0.5, 0.7, 1.1) mm, where a
    vertex's voxel rests on how a half-voxel coordinate rounds, against the
    JAX package's on the same shell: within 1e-4 mm on used vertices."""
    zz, yy, xx = np.mgrid[:32, :32, :32]
    r = np.sqrt((zz - 16) ** 2 + (yy - 16) ** 2 + (xx - 16) ** 2)
    m = ((r < 11) & (r > 6)).astype(np.uint8) * 255
    smooth = {"t": 0.7, "tmax": 3.0, "bmin": 0.5, "n_iters": 4}
    v, f = single_device(m, (0.5, 0.7, 1.1), smooth)
    jv, jf = jax_single_device(m, (0.5, 0.7, 1.1), smooth)
    np.testing.assert_array_equal(f, jf)
    assert np.abs(v - jv).max(axis=1)[used_of(v, f)].max() < TOL

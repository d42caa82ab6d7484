"""The port's shard list across processes: 4 gloo processes on the CPU hold
the 8 shards of ``distributed.global_mesh(shape=(8,), device="cpu")``, 2
each, and run the port only (``chip_smoke.process_cases`` at 64^3 on
``make_ct``, seed 0, at a (0.5, 0.7, 1.1) mm spacing).  Their results
are held to the one-process shard list's (a fifth process running the
same cases on ``make_mesh(8)``), exactly: the bone mask's dilation, the
floodfill from a skull seed across every shard, the active-cell count,
the watershed's labels, ranks, rounds and halo bytes at both stopping
rules, the balanced surface's cuts, checks, histogram, vertices and faces
raw and smoothed, and ``pipeline.run(shards=...)``'s STL bytes.  They are
held to the JAX 8-device CPU mesh at the tolerances of
tests/test_torch_parallel_{watershed,surface,smooth}.py: labels, ranks,
rounds, cuts and faces exactly, vertices within 1e-5, smoothed vertices
within 1e-4 mm.  At this anisotropic spacing the smoothed vertices are
held, as in tests/test_torch_parallel_smooth.py, to the JAX single-device
smoothing: the JAX sharded smoother rounds lattice coordinates to voxels
and stands about 0.02 mm off both.  A rank that raises ends every rank
with a non-zero exit within the time limit."""

import dataclasses

import concurrent.futures
import importlib
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from invesalius3_tpu.ops import marching as marching_jax
from invesalius3_tpu.ops import mesh as mesh_jax
from invesalius3_tpu.ops.morphology import structure_3d as structure_3d_jax
from invesalius3_tpu.parallel import sharded_ops as sharded_jax
from invesalius3_tpu.parallel.mesh_utils import make_mesh as make_mesh_jax
from invesalius3_tpu.parallel.mesh_utils import shard_volume as shard_volume_jax
from invesalius3_tpu_torch import pipeline

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")
N = 64
RANKS = 4
TIMEOUT = 240.0  # seconds for a whole group; its collectives time out sooner
TOL_V, TOL_SMOOTH = 1e-5, 1e-4
SPACING = (0.5, 0.7, 1.1)


@pytest.fixture(scope="module")
def chip_smoke():
    mod = importlib.import_module("chip_smoke")
    yield mod
    sys.modules.pop("chip_smoke", None)


def _jax_cases() -> dict:
    """The JAX 8-device mesh on the same inputs (the surfaces on the label-1
    mask of its own labels, which the port's must equal)."""
    mesh = make_mesh_jax(8, ("z",))
    ct, markers = pipeline.make_ct(N), pipeline.bench_markers(N)
    bone = ct >= 226
    out = {"dilation": np.asarray(sharded_jax.sharded_binary_dilation(
        mesh, structure_3d_jax(26))(shard_volume_jax(jnp.asarray(bone), mesh)))}
    seeds = np.zeros(ct.shape, bool)
    seeds[N // 2, N // 2, N // 2 + int(0.39 * N)] = True
    out["floodfill"] = np.asarray(sharded_jax.sharded_floodfill_threshold(
        mesh, structure_3d_jax(6))(shard_volume_jax(jnp.asarray(ct), mesh),
                                   shard_volume_jax(jnp.asarray(seeds), mesh),
                                   jnp.int16(226), jnp.int16(3071)))
    out["active cells"] = np.asarray(sharded_jax.sharded_active_cell_count(mesh)(
        shard_volume_jax(jnp.asarray(bone), mesh)))
    for stop, quiet in (("label", 2), ("rank", 1)):
        run = sharded_jax.sharded_watershed(mesh, levels=2, stop=stop, quiet_rounds=quiet)
        lab, rounds = run(ct, markers, debug_rounds=True)
        rank = np.asarray(run(ct, markers, debug_rank=True)[1]) if stop == "rank" else None
        out[f"watershed {stop}"] = {"labels": np.asarray(lab), "rank": rank,
                                    "rounds": np.asarray(rounds)[0].tolist()}
    mask = np.where(out["watershed label"]["labels"] == 1, 255, 0).astype(np.uint8)
    for smooth in (None, pipeline.CA_PARAMS):
        v, f, st = sharded_jax.sharded_mask_to_surface(
            mesh, mask, spacing=SPACING, smooth=smooth, balance=True, return_stats=True)
        out["surface " + ("smoothed" if smooth else "raw")] = (np.asarray(v), np.asarray(f), st)
    dm = marching_jax.mask_to_surface_device(jnp.asarray(mask), spacing=SPACING)
    p = pipeline.CA_PARAMS
    out3v = mesh_jax.ca_smoothing_device(dm, p["t"], p["tmax"], p["bmin"], p["n_iters"])
    out["smoothed single device"] = drop_orphan(*marching_jax.mesh_to_host(
        dataclasses.replace(dm, verts3v=out3v), fp16=False))[:2]
    return out


@pytest.fixture(scope="module")
def runs(chip_smoke, tmp_path_factory):
    """(every rank's results, the one-process results, the JAX results):
    the 4 ranks and the one-process run as child processes, the JAX mesh
    here meanwhile."""
    tmp = tmp_path_factory.mktemp("procs")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        group = pool.submit(chip_smoke.spawn_ranks, "cases", RANKS, tmp / "group", N, "cpu", 8,
                            timeout=TIMEOUT)
        alone = pool.submit(chip_smoke.spawn_ranks, "cases", 1, tmp / "one", N, "cpu", 8,
                            timeout=TIMEOUT)
        want = _jax_cases()
        for what, fut in (("group", group), ("one process", alone)):
            for r, (rc, _, err, _) in enumerate(fut.result()):
                assert rc == 0, f"{what} rank {r} exited {rc}:\n{err[-4000:]}"
    got = [pickle.loads((tmp / "group" / f"rank{r}.pkl").read_bytes()) for r in range(RANKS)]
    one = pickle.loads((tmp / "one" / "rank0.pkl").read_bytes())
    return got, one, want


def drop_orphan(v, f):
    """A JAX mesh without its padding orphan (id 0, used by no face)."""
    used = np.zeros(len(v), bool)
    used[np.asarray(f).ravel()] = True
    if len(v) and not used[0]:
        return np.asarray(v)[1:], np.asarray(f) - 1, True
    return np.asarray(v), np.asarray(f), False


@pytest.mark.parametrize("case", ["dilation", "floodfill", "active cells"])
def test_halo_ops_equal_one_process_and_jax(runs, case):
    got, one, want = runs
    for g in got:
        np.testing.assert_array_equal(g[case], one[case])
    np.testing.assert_array_equal(one[case], want[case])


def test_floodfill_crosses_every_shard(runs):
    got, _, _ = runs
    reached = got[0]["floodfill"]
    planes = np.flatnonzero(reached.any(axis=(1, 2)))
    assert set(planes // (N // 8)) == set(range(8))


@pytest.mark.parametrize("stop", ["label", "rank"])
def test_watershed_equals_one_process_and_jax(runs, stop):
    got, one, want = runs
    key = f"watershed {stop}"
    ref = one[key]
    for g in got:
        for field in ("labels", "rank"):
            if ref[field] is None:
                assert g[key][field] is None
            else:
                np.testing.assert_array_equal(g[key][field], ref[field])
        assert g[key]["rounds"] == ref["rounds"]
        assert g[key]["halo_bytes"] == ref["halo_bytes"]
        assert g[key]["launches"] == ref["launches"]  # 0 on the CPU: plain sweeps
        assert g[key]["wire_bytes"] == got[0][key]["wire_bytes"]
    np.testing.assert_array_equal(ref["labels"], want[key]["labels"])
    assert ref["rounds"] == want[key]["rounds"] and len(ref["rounds"]) == 2
    if stop == "rank":
        np.testing.assert_array_equal(ref["rank"], want[key]["rank"])
    assert set(np.unique(ref["labels"])) == {1, 2, 3}


def test_wire_bytes_count_the_rank_boundaries(runs):
    """Three of the seven shard boundaries cross between ranks: their
    planes are the wire's share of the halo bytes, 3/7 of them."""
    got, one, _ = runs
    for stop in ("label", "rank"):
        st = got[0][f"watershed {stop}"]
        assert [7 * w for w in st["wire_bytes"]] == [3 * h for h in st["halo_bytes"]]
        assert one[f"watershed {stop}"]["wire_bytes"] == [0, 0]


@pytest.mark.parametrize("kind", ["raw", "smoothed"])
def test_surface_equals_one_process(runs, kind):
    got, one, _ = runs
    ref = one[f"surface {kind}"]
    for g in got:
        s = g[f"surface {kind}"]
        assert s["cuts"] == ref["cuts"] and s["checks"] == ref["checks"]
        assert s["tri_hist"] == ref["tri_hist"]
        assert s["verts"].dtype == np.float32 and s["faces"].dtype == np.int32
        np.testing.assert_array_equal(s["verts"], ref["verts"])
        np.testing.assert_array_equal(s["faces"], ref["faces"])
    lens = np.diff(ref["cuts"])
    assert (lens >= 1).all() and len(set(lens.tolist())) > 1  # balanced, not uniform


@pytest.mark.parametrize("kind", ["raw", "smoothed"])
def test_surface_equals_jax(runs, kind):
    _, one, want = runs
    ref = one[f"surface {kind}"]
    jv, jf, js = want[f"surface {kind}"]
    jv, jf, had_orphan = drop_orphan(jv, jf)
    assert ref["cuts"] == js["cuts"] and ref["tri_hist"] == js["tri_hist"]
    checks, jchecks = np.asarray(ref["checks"]), np.asarray(js["checks"])
    jchecks[0, 0] -= had_orphan  # shard 0 held the orphan slot
    np.testing.assert_array_equal(checks[:, 0:4], jchecks[:, 0:4])
    assert ref["verts"].shape == jv.shape
    np.testing.assert_array_equal(ref["faces"], jf)
    if kind == "raw":
        np.testing.assert_allclose(ref["verts"], jv, atol=TOL_V, rtol=0)
        return
    sv, sf = want["smoothed single device"]
    used = np.zeros(len(sv), bool)
    used[sf.ravel()] = True
    assert sv.shape == ref["verts"].shape
    assert {tuple(sorted(t)) for t in sf.tolist()} == {tuple(sorted(t)) for t in
                                                       ref["faces"].tolist()}
    assert np.abs(ref["verts"] - sv).max(axis=1)[used].max() < TOL_SMOOTH
    assert np.abs(jv - sv).max(axis=1)[used].max() > 0.01  # the JAX sharded voxel rule


def test_pipeline_stl_bytes_equal_one_process(runs):
    got, one, _ = runs
    ref = one["flow"]
    assert ref["stl"] and len(ref["stl"]) > 84
    assert got[0]["flow"]["stl"] == ref["stl"]  # rank 0 writes
    for g in got[1:]:
        assert g["flow"]["stl"] is None
    for g in got:
        assert g["flow"]["cuts"] == ref["cuts"] and g["flow"]["rounds"] == ref["rounds"]
        assert g["flow"]["halo_bytes"] == ref["halo_bytes"]
        np.testing.assert_array_equal(g["flow"]["labels"], ref["labels"])


def test_a_failing_rank_ends_every_rank(chip_smoke, tmp_path):
    """Rank 2's sweep raises in the watershed's second round; the others wait
    on its planes or on the round's flag and exit non-zero when its
    connections close, well inside the collectives' timeout."""
    runs = chip_smoke.spawn_ranks("fail", RANKS, tmp_path, 32, "cpu", 8, timeout=TIMEOUT,
                                  fail_rank=2, kill_on_failure=False)
    for r, (rc, _, err, seconds) in enumerate(runs):
        assert rc not in (0, None), f"rank {r} exited {rc}"
        assert seconds is not None and seconds < chip_smoke.PROC_TIMEOUT_S, (r, seconds)
    assert "rank 2 fails on purpose" in runs[2][2]

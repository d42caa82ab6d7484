"""The port's Z-sharded watershed against the JAX package's on the
8-device CPU mesh, on the same seeded numpy inputs: labels bit-exact, the
rounds per multigrid level (``debug_rounds``) equal, and the ranks equal
at ``stop="rank"``; both algorithms, levels 0 and 2, both stopping rules,
6- and 26-connectivity, barriers, empty shards and an int16 image whose
shift by its minimum wraps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation

from invesalius3_tpu.ops import watershed as ws_jax
from invesalius3_tpu.parallel import sharded_ops as sharded_jax
from invesalius3_tpu.parallel.mesh_utils import make_mesh as make_mesh_jax
from invesalius3_tpu_torch.ops import kernels, watershed
from invesalius3_tpu_torch.parallel import sharded_ops
from invesalius3_tpu_torch.parallel.mesh_utils import make_mesh, shard_volume

torch.set_num_threads(1)
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")


@pytest.fixture(scope="module")
def zmesh_jax():
    return make_mesh_jax(8, ("z",))


@pytest.fixture(scope="module")
def zmesh():
    return make_mesh(8, device="cpu")


def ws_volume(n=64, seed=3):
    """Two basins separated by a bright ridge over a noise floor (the JAX
    package's test volume)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float32)
    ridge = np.exp(-((xx - n / 2) ** 2) / 8.0) * 900
    bowl = ((zz - n / 2) ** 2 + (yy - n / 2) ** 2) / n
    vol = (ridge + bowl + rng.integers(0, 5, (n, n, n))).astype(np.int16)
    markers = np.zeros((n, n, n), np.int16)
    markers[n // 2, n // 2, n // 6] = 1
    markers[n // 2, n // 2, 5 * n // 6] = 2
    return vol, markers


def _wrapping(n=32):
    """An int16 image spanning more than 2^15: its shift by the minimum
    wraps in int16, in both packages."""
    vol, markers = ws_volume(n, seed=11)
    vol = vol.astype(np.int32) * 40 - 20000
    vol[0, 0, :4] = [-30000, 30000, -29000, 29500]
    return np.clip(vol, -32768, 32767).astype(np.int16), markers


# (n, levels, stop, algorithm, connectivity, mg_size, volume)
CASES = {
    "grad-l2-rank": (64, 2, "rank", "Watershed", 6, (3, 3, 3), None),
    "ift-l2-label": (64, 2, "label", "Watershed (IFT)", 6, (3, 3, 3), None),
    "ift-l0-rank": (32, 0, "rank", "Watershed (IFT)", 6, (3, 3, 3), None),
    "grad-l0-label": (32, 0, "label", "Watershed", 6, (1, 3, 3), None),
    "grad-l0-rank-26": (32, 0, "rank", "Watershed", 26, (3, 3, 3), None),
    "ift-l0-rank-wrap": (32, 0, "rank", "Watershed (IFT)", 6, (3, 3, 3), "wrap"),
}


@pytest.fixture(scope="module")
def runs(zmesh, zmesh_jax):
    """Each case through both packages: (JAX labels, JAX rounds, JAX ranks
    or None, port labels, port rounds, port ranks or None, port stats)."""
    out = {}
    for name, (n, levels, stop, alg, conn, mg, kind) in CASES.items():
        vol, markers = _wrapping(n) if kind == "wrap" else ws_volume(n)
        q = 2 if stop == "label" else 1
        run_jax = sharded_jax.sharded_watershed(zmesh_jax, connectivity=conn,
                                                levels=levels, stop=stop, quiet_rounds=q)
        run = sharded_ops.sharded_watershed(zmesh, connectivity=conn, levels=levels,
                                            stop=stop, quiet_rounds=q)
        want, want_rounds = run_jax(vol, markers, algorithm=alg, mg_size=mg,
                                    debug_rounds=True)
        stats = {}
        want_rank = got_rank = None
        if stop == "rank":
            want_rank = np.asarray(run_jax(vol, markers, algorithm=alg, mg_size=mg,
                                           debug_rank=True)[1])
            got, got_rank = run(vol, markers, algorithm=alg, mg_size=mg,
                                debug_rank=True, stats=stats)
            got_rank, got_rounds = got_rank.gather().numpy(), stats["rounds"]
        else:
            got, got_rounds = run(vol, markers, algorithm=alg, mg_size=mg,
                                  debug_rounds=True, stats=stats)
        out[name] = (np.asarray(want), np.asarray(want_rounds)[0].tolist(), want_rank,
                     got.gather().numpy(), got_rounds, got_rank, stats, (vol, markers))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_labels_equal_jax(runs, name):
    want, _, _, got, _, _, _, _ = runs[name]
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {1, 2}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rounds_per_level_equal_jax(runs, name):
    levels = CASES[name][1]
    _, want_rounds, _, _, got_rounds, _, stats, _ = runs[name]
    assert got_rounds == want_rounds
    assert stats["rounds"] == got_rounds and stats["levels"] == levels
    assert len(stats["halo_bytes"]) == len(got_rounds)
    # at 64^3 over 8 shards a level-2 solve stops coarsening at 4 local
    # planes: two refines, coarse and fine
    assert len(got_rounds) == (1 if levels == 0 else 2)


@pytest.mark.parametrize("name", [k for k in sorted(CASES) if CASES[k][2] == "rank"])
def test_ranks_equal_jax_at_the_rank_fixpoint(runs, name):
    _, _, want_rank, _, _, got_rank, _, _ = runs[name]
    np.testing.assert_array_equal(got_rank, want_rank)


@pytest.mark.parametrize("name", ["grad-l2-rank", "ift-l0-rank"])
def test_sharded_labels_agree_with_single_device_off_the_divide(runs, name):
    """The JAX test's criterion against the single-device watershed of both
    packages: equal off the divide line, under 1% of voxels differing."""
    n, levels, _, alg = CASES[name][:4]
    _, _, _, got, _, _, _, (vol, markers) = runs[name]
    single = watershed.watershed(torch.from_numpy(vol), torch.from_numpy(markers),
                                 algorithm=alg).numpy()
    single_jax = np.asarray(ws_jax.watershed(jnp.asarray(vol), jnp.asarray(markers),
                                             algorithm=alg))
    np.testing.assert_array_equal(single, single_jax)
    mism = got != single
    divide = binary_dilation(single == 1) & binary_dilation(single == 2)
    assert (mism & ~divide).sum() == 0
    assert mism.mean() < 0.01


def test_label_stop_takes_fewer_rounds(runs):
    want_rank = runs["grad-l2-rank"][3]
    _, markers = ws_volume(64)
    vol = ws_volume(64)[0]
    got, r_lab = sharded_ops.sharded_watershed(make_mesh(8, device="cpu"), levels=2,
                                               stop="label", quiet_rounds=2)(
        vol, markers, algorithm="Watershed", debug_rounds=True)
    got = got.gather().numpy()
    mism = got != want_rank
    divide = binary_dilation(want_rank == 1) & binary_dilation(want_rank == 2)
    assert (mism & ~divide).sum() == 0
    assert sum(r_lab) <= sum(runs["grad-l2-rank"][4])


def test_barriers_and_empty_shards(zmesh, zmesh_jax):
    """Both seeds in shard 0, a barrier wall of -1 through every shard."""
    vol, markers = ws_volume(64, seed=9)
    markers[:] = 0
    markers[4, 32, 10] = 1
    markers[5, 32, 54] = 2
    markers[:, :, 31] = -1
    want = np.asarray(sharded_jax.sharded_watershed(zmesh_jax, levels=0)(
        vol, markers, algorithm="Watershed (IFT)"))
    single = watershed.watershed(torch.from_numpy(vol), torch.from_numpy(markers),
                                 algorithm="Watershed (IFT)").numpy()
    got = sharded_ops.sharded_watershed(zmesh, levels=0)(
        shard_volume(vol, zmesh), shard_volume(markers, zmesh),
        algorithm="Watershed (IFT)").gather().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)
    assert set(np.unique(got)) == {-1, 1, 2}


def test_the_given_sweep_runs_on_every_shard_and_axis(runs):
    """``sweep`` replaces the axis sweep on each ghost-padded slab; on the
    CPU no kernel launches, so the launch counts stay 0."""
    vol, markers = ws_volume(32)
    calls = {}

    def sweep(rank, lab, f, axis):
        calls[(tuple(rank.shape), axis)] = calls.get((tuple(rank.shape), axis), 0) + 1
        return kernels.watershed_sweep_ref(rank, lab, f, axis)

    stats = {}
    got = sharded_ops.sharded_watershed(make_mesh(8, device="cpu"), levels=0,
                                        stop="rank")(
        vol, markers, algorithm="Watershed (IFT)", sweep=sweep, stats=stats)
    np.testing.assert_array_equal(got.gather().numpy(), runs["ift-l0-rank"][3])
    n_rounds = stats["rounds"][0]
    # each shard's slab: 4 planes and 2 ghosts
    assert calls == {((6, 32, 32), a): 8 * n_rounds for a in range(3)}
    assert stats["launches"] == [[0, 0, 0]] * 8
    # f's ghosts once, then rank and labels each round: 2 planes a cut
    plane = 32 * 32
    assert stats["halo_bytes"] == [14 * plane * 4 + n_rounds * 14 * plane * (4 + 2)]


def test_z_must_divide_over_the_shards(zmesh):
    vol, markers = ws_volume(20)
    with pytest.raises(ValueError, match="evenly"):
        sharded_ops.sharded_watershed(zmesh, levels=0)(vol, markers)
    with pytest.raises(ValueError, match="stop"):
        sharded_ops.sharded_watershed(zmesh, stop="never")

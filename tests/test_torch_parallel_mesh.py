"""The port's shard meshes, placements, process-group bootstrap and
one-plane-halo ops against the JAX package's ``parallel`` on the 8-device
CPU mesh (tests/conftest.py), on the same seeded numpy inputs: dilation,
the floodfill fixpoint and the marching counts exactly."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.ops import marching as marching_jax
from invesalius3_tpu.ops.morphology import structure_3d as structure_3d_jax
from invesalius3_tpu.parallel import distributed as distributed_jax
from invesalius3_tpu.parallel import sharded_ops as sharded_jax
from invesalius3_tpu.parallel.mesh_utils import make_mesh as make_mesh_jax
from invesalius3_tpu.parallel.mesh_utils import shard_volume as shard_volume_jax
from invesalius3_tpu_torch.ops import floodfill, marching, morphology
from invesalius3_tpu_torch.parallel import distributed, sharded_ops
from invesalius3_tpu_torch.parallel.mesh_utils import (Placement, Sharded, make_mesh,
                                                       replicated, shard_volume,
                                                       z_sharding)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")


@pytest.fixture(scope="module")
def zmesh_jax():
    return make_mesh_jax(8, ("z",))


@pytest.fixture(scope="module")
def zmesh():
    return make_mesh(8, device="cpu")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_make_mesh_on_the_cpu(zmesh):
    assert zmesh.shape == {"z": 8} and zmesh.size == 8
    assert all(d == torch.device("cpu") for d in zmesh.devices.ravel())
    m2 = make_mesh(8, ("data", "z"), shape=(2, 4), device="cpu")
    assert m2.shape == {"data": 2, "z": 4}
    with pytest.raises(ValueError, match="shape required"):
        make_mesh(8, ("data", "z"), device="cpu")


def test_make_mesh_cycles_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = make_mesh(8)
    assert [d.index for d in m.devices] == [0, 1, 2, 0, 1, 2, 0, 1]
    assert make_mesh().size == 3
    assert [d.index for d in make_mesh(4, device="cuda:1").devices] == [1, 1, 1, 1]


def test_make_mesh_needs_a_card_unless_asked(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.global_mesh()


def test_shard_volume_pads_and_places(zmesh, zmesh_jax):
    v = np.arange(13 * 8 * 8, dtype=np.int16).reshape(13, 8, 8)
    want = shard_volume_jax(jnp.asarray(v), zmesh_jax)
    sv = shard_volume(v, zmesh)
    assert sv.shape == tuple(want.shape) == (16, 8, 8)
    assert sv.sharding == z_sharding(zmesh) and sv.sharding.spec == ("z", None, None)
    assert sv.starts == [0, 2, 4, 6, 8, 10, 12, 14]
    assert all(s.shape == (2, 8, 8) for s in sv.shards)
    np.testing.assert_array_equal(sv.gather().numpy(), np.asarray(want))
    # the shards own their memory: writing one leaves the input alone
    sv.shards[0].fill_(7)
    assert v[0, 0, 0] == 0


def test_placements(zmesh):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    rep = replicated(zmesh).put(x)
    assert rep.shape == (16, 3) and len(rep.shards) == 8
    assert all(np.array_equal(s.numpy(), x) for s in rep.shards)
    with pytest.raises(ValueError, match="does not split evenly"):
        z_sharding(zmesh).put(np.zeros((12, 4, 4)))
    with pytest.raises(ValueError, match="first axis"):
        Placement(zmesh, (None, "z")).put(np.zeros((8, 8)))


def test_patch_batch_data_split():
    """A batch split over a "data" axis, shard by shard (the counterpart of
    the P("data") placement of the JAX package's segmenters' batches)."""
    m = make_mesh(8, ("data",), device="cpu")
    xs = Placement(m, ("data",)).put(torch.ones((8, 8, 8, 8, 1)))
    out = Sharded([s.mean(dim=(1, 2, 3, 4)) for s in xs.shards], xs.starts, xs.sharding)
    assert out.shape == (8,)
    np.testing.assert_allclose(out.gather().numpy(), 1.0)


def test_distributed_single_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is distributed_jax.initialize() is False
    assert not distributed.is_multiprocess_env() and not distributed_jax.is_multiprocess_env()
    assert distributed.process_info() == distributed_jax.process_info() == (0, 1)
    mesh = distributed.global_mesh(("z",), device="cpu")
    assert mesh.size == 1 and mesh.shape == {"z": 1}
    mesh2 = distributed.global_mesh(("data", "z"), device="cpu")
    assert mesh2.shape == {"data": 1, "z": 1}
    assert distributed.local_data_slice(16) == distributed_jax.local_data_slice(16) == slice(0, 16)
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert distributed.is_multiprocess_env()
    monkeypatch.setenv("WORLD_SIZE", "x")
    assert not distributed.is_multiprocess_env()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert distributed.is_multiprocess_env()


def test_global_mesh_of_local_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = distributed.global_mesh(("data", "z"))
    assert m.shape == {"data": 1, "z": 4}
    assert [d.index for d in m.devices.ravel()] == [0, 1, 2, 3]


_CHILD = textwrap.dedent("""
    import hashlib, os, sys, numpy as np, torch, torch.distributed as dist
    from invesalius3_tpu_torch.parallel import distributed as d
    from invesalius3_tpu_torch.parallel.mesh_utils import shard_volume
    rank = int(os.environ["RANK"])
    assert d.is_multiprocess_env()
    assert d.initialize(device="cpu") is True
    assert d.initialize(device="cpu") is True  # idempotent
    assert dist.get_backend() == "gloo"
    assert d.process_info() == (rank, 2), d.process_info()
    assert d.local_data_slice(8) == slice(4 * rank, 4 * rank + 4)
    try:
        d.local_data_slice(7)
        sys.exit("an uneven batch did not raise")
    except ValueError:
        pass
    mesh = d.global_mesh(device="cpu")  # one shard a process
    assert mesh.shape == {"z": 2} and mesh.ranks.tolist() == [0, 1] and mesh.rank == rank
    mesh = d.global_mesh(shape=(6,), device="cpu")  # host-major: 0, 1, 2 on rank 0
    assert mesh.ranks.tolist() == [0, 0, 0, 1, 1, 1], mesh.ranks
    assert d.global_mesh(("data", "z"), device="cpu").shape == {"data": 2, "z": 1}
    v = np.arange(13 * 4 * 5, dtype=np.int16).reshape(13, 4, 5)
    sv = shard_volume(v, mesh)
    assert sv.shape == (18, 4, 5) and sv.local == [3 * rank, 3 * rank + 1, 3 * rank + 2]
    assert all((a is None) == (s // 3 != rank) for s, a in enumerate(sv.shards))
    whole = sv.gather()
    assert torch.equal(whole[:13], torch.from_numpy(v)) and not whole[13:].any()
    flags = sv.map(lambda a: a.bool())
    assert flags.gather().dtype == torch.bool and flags.shape == (18, 4, 5)
    print("ok", rank, hashlib.sha256(whole.numpy().tobytes()).hexdigest())
    dist.barrier()
    dist.destroy_process_group()
""")


def test_distributed_two_processes_over_gloo():
    """Two processes join one gloo group from torch's launcher variables:
    process ids, data slices, the host-major mesh over both (each rank
    holds its own shards) and ``Sharded.gather()``, the same whole array
    on both ranks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), WORLD_SIZE="2", RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", _CHILD], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
    digests = set()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        word, got_rank, digest = out.split()
        assert (word, got_rank) == ("ok", str(rank))
        digests.add(digest)
    assert len(digests) == 1


@pytest.mark.parametrize("conn,shape,seed,p", [(6, (16, 16, 16), 0, 0.8),
                                               (26, (16, 12, 12), 1, 0.85),
                                               (18, (24, 10, 9), 2, 0.9)])
def test_sharded_dilation_equals_jax(zmesh, zmesh_jax, conn, shape, seed, p):
    x = np.random.default_rng(seed).random(shape) > p
    f_jax = sharded_jax.sharded_binary_dilation(zmesh_jax, structure_3d_jax(conn))
    want = np.asarray(f_jax(shard_volume_jax(jnp.asarray(x), zmesh_jax)))
    got = sharded_ops.sharded_binary_dilation(zmesh, morphology.structure_3d(conn))(
        shard_volume(x, zmesh))
    np.testing.assert_array_equal(got.gather().numpy(), want)
    np.testing.assert_array_equal(
        want, morphology.binary_dilation(torch.from_numpy(x), morphology.structure_3d(conn)).numpy())


def test_sharded_dilation_refuses_deep_elements(zmesh):
    with pytest.raises(ValueError, match="3 deep"):
        sharded_ops.sharded_binary_dilation(zmesh, np.ones((5, 1, 1), bool))


def test_sharded_floodfill_rod_crosses_every_shard(zmesh, zmesh_jax):
    vol = np.full((32, 8, 8), -1000, np.int16)
    vol[:, 4, 4] = 1500
    seeds = np.zeros(vol.shape, bool)
    seeds[0, 4, 4] = True
    f_jax = sharded_jax.sharded_floodfill_threshold(zmesh_jax, structure_3d_jax(6))
    want = np.asarray(f_jax(shard_volume_jax(jnp.asarray(vol), zmesh_jax),
                            shard_volume_jax(jnp.asarray(seeds), zmesh_jax),
                            jnp.int16(1200), jnp.int16(3000)))
    f = sharded_ops.sharded_floodfill_threshold(zmesh, morphology.structure_3d(6))
    got = f(shard_volume(vol, zmesh), shard_volume(seeds, zmesh), 1200, 3000).gather().numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, 4, 4].all() and got.sum() == 32


@pytest.mark.parametrize("conn", [6, 26])
def test_sharded_floodfill_equals_single_device(zmesh, zmesh_jax, conn):
    """A noisy volume: the sharded fixpoint is the JAX program's and the
    port's single-device ``floodfill_threshold``'s."""
    r = np.random.default_rng(conn)
    vol = r.integers(-200, 1200, (32, 14, 13)).astype(np.int16)
    seeds = np.zeros(vol.shape, bool)
    seeds[3, 7, 6] = seeds[27, 2, 2] = True
    f_jax = sharded_jax.sharded_floodfill_threshold(zmesh_jax, structure_3d_jax(conn))
    want = np.asarray(f_jax(shard_volume_jax(jnp.asarray(vol), zmesh_jax),
                            shard_volume_jax(jnp.asarray(seeds), zmesh_jax),
                            jnp.int16(100), jnp.int16(1200)))
    got = sharded_ops.sharded_floodfill_threshold(zmesh, morphology.structure_3d(conn))(
        vol, seeds, 100, 1200).gather().numpy()
    single = floodfill.floodfill_threshold(torch.from_numpy(vol), torch.from_numpy(seeds),
                                           100, 1200, morphology.structure_3d(conn))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single.numpy())
    assert 50 < got.sum() < got.size


def test_sharded_threshold_mask(zmesh):
    vol = np.random.default_rng(4).integers(-1000, 2000, (16, 6, 5)).astype(np.int16)
    got = sharded_ops.sharded_threshold_mask(zmesh)(vol, 226, 3071).gather()
    want = ((vol >= 226) & (vol <= 3071)).astype(np.uint8) * 255
    np.testing.assert_array_equal(got.numpy(), want)


def _counting_volumes():
    block = np.zeros((32, 16, 16), bool)
    block[10:20, 4:10, 4:10] = True  # a block across shard boundaries
    noise = np.random.default_rng(5).random((24, 11, 13)) > 0.6
    return {"block": block, "noise": noise}


@pytest.mark.parametrize("name", ["block", "noise"])
def test_sharded_active_cell_count(zmesh, zmesh_jax, name):
    vol = _counting_volumes()[name]
    want = np.asarray(sharded_jax.sharded_active_cell_count(zmesh_jax)(
        shard_volume_jax(jnp.asarray(vol), zmesh_jax)))
    got = sharded_ops.sharded_active_cell_count(zmesh)(shard_volume(vol, zmesh))
    np.testing.assert_array_equal(got, want)
    if name == "block":  # the last shard's trailing halo is zeros: the counts
        # agree with the whole volume's where the mask leaves the last plane
        assert got[0] == int(marching.count_active_cells(torch.from_numpy(vol).float(), 0.5))


@pytest.mark.parametrize("name", ["block", "noise"])
@pytest.mark.parametrize("iso_greater", [True, False])
def test_marching_counts_equal_jax(name, iso_greater):
    r = np.random.default_rng(6)
    field = _counting_volumes()[name].astype(np.float32) + r.random((1,)).astype(np.float32) * 0.1
    iso = 0.55
    want_a = int(marching_jax.count_active_cells(jnp.asarray(field), iso, iso_greater))
    want_a2, want_t = (int(x) for x in marching_jax.count_cells_and_triangles(
        jnp.asarray(field), iso, iso_greater))
    t = torch.from_numpy(field)
    got_a = int(marching.count_active_cells(t, iso, iso_greater))
    got_a2, got_t = (int(x) for x in marching.count_cells_and_triangles(t, iso, iso_greater))
    assert got_a == got_a2 == want_a == want_a2
    assert got_t == want_t == int(marching.count_triangles(t, iso, iso_greater))
    assert got_t == int(marching_jax.count_triangles(jnp.asarray(field), iso, iso_greater))
    if iso_greater:  # the extraction emits exactly the counted triangles
        assert got_t == marching.marching_cubes_device(t, iso).n_tris


def test_distributed_mesh_runs_sharded_op():
    mesh = distributed.global_mesh(("z",), device="cpu")
    n = mesh.size
    vol = np.zeros((8 * n, 16, 16), np.int16)
    vol[2 * n:6 * n, 4:12, 4:12] = 1000
    count = sharded_ops.sharded_active_cell_count(mesh)(shard_volume(vol > 500, mesh))
    assert int(count[0]) > 0

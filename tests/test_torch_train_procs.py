"""Data-parallel training across processes on the CPU: two gloo processes
each feed their half of a batch of 4 (``distributed.local_data_slice``) to
``train.train_step`` with the group, so the batch norms normalise with the
global batch's statistics and the gradients are summed over the ranks;
a third process trains on the whole batch alone.  The run is
``chip_smoke.train_run``: the float32 ``Unet3D(init_features=2)`` at 32^3
(``make_ct(64)``'s 2x2x2 patches windowed as the trachea segmenter does,
targets their Bone threshold), three Adam steps.

Each rank's record is held to the one process's by
``chip_smoke.compare_training`` within ``chip_smoke.DP_TOL`` (measured
worst in brackets): every step's loss 1e-5 (3.0e-6), the running
statistics after the first step 1e-5 (3.4e-7) and after the third 1e-2
(5.0e-3), the first step's gradients 1e-3 of the larger of each
parameter's norm and 1% of the whole's (3.6e-4: the batch of 2 and of 4
convolve in other orders, and the deep layers' gradients carry that
rounding at a few 1e-4 of their norm, as the port's float32 gradients do
against the JAX package's in tests/test_torch_train.py), each parameter's
change over the three steps 0.15 of its norm (0.067; Adam's steps scale
the rounding of small gradient elements up to a share of the learning
rate, see tests/test_torch_train.py).  The two ranks hold the same
values bit for bit.  A data-parallel fault stands far outside these
bounds: with each rank's own batch statistics the first step's
statistics are 0.21 off and its gradients 0.91; with the gradients not
summed over the ranks, the gradients 1.71 (mutation checks).  Each group
runs under its own time limit, and its collectives time out sooner."""

import concurrent.futures
import importlib
import pickle
import sys

import pytest
import torch

N, BATCH, STEPS, F = 32, 4, 3, 2
RANKS = 2
TIMEOUT = 240.0  # seconds for a whole group


@pytest.fixture(scope="module")
def chip_smoke():
    mod = importlib.import_module("chip_smoke")
    yield mod
    sys.modules.pop("chip_smoke", None)


@pytest.fixture(scope="module")
def runs(chip_smoke, tmp_path_factory):
    """(every rank's float32 record, the one process's), each group a set
    of child processes started side by side."""
    tmp = tmp_path_factory.mktemp("train_procs")
    job = {"f": F, "runs": {"float32": STEPS}}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        group = pool.submit(chip_smoke.spawn_ranks, "train", RANKS, tmp / "group", N, "cpu",
                            BATCH, timeout=TIMEOUT, job=job)
        alone = pool.submit(chip_smoke.spawn_ranks, "train", 1, tmp / "one", N, "cpu", BATCH,
                            timeout=TIMEOUT, job=job)
        for what, fut in (("group", group), ("one process", alone)):
            for r, (rc, _, err, _) in enumerate(fut.result()):
                assert rc == 0, f"{what} rank {r} exited {rc}:\n{err[-4000:]}"
    got = [pickle.loads((tmp / "group" / f"rank{r}.pkl").read_bytes())["float32"]
           for r in range(RANKS)]
    one = pickle.loads((tmp / "one" / "rank0.pkl").read_bytes())["float32"]
    return got, one


@pytest.mark.parametrize("rank", range(RANKS))
@pytest.mark.parametrize("what", ["loss", "stats1", "stats", "grads", "params"])
def test_rank_equals_one_process(chip_smoke, runs, what, rank):
    got, one = runs
    assert len(got[rank]["losses"]) == STEPS
    chip_smoke.compare_training(got[rank], one, {what: chip_smoke.DP_TOL[what]}, f"rank {rank}")


def test_ranks_hold_the_same_values(runs):
    """Every rank ends with the same parameters and statistics and reports
    the same losses: the all-reduced sums are one value on every rank."""
    got, _ = runs
    first = got[0]
    for rec in got[1:]:
        assert rec["losses"] == first["losses"]
        for key in ("stats1", "stats", "grads", "params"):
            assert all(torch.equal(rec[key][k], first[key][k]) for k in first[key]), key


def test_the_loss_falls(runs):
    _, one = runs
    assert all(torch.isfinite(torch.tensor(one["losses"])))
    assert one["losses"][-1] < one["losses"][0]


def test_chip_smoke_phase_19_on_the_cpu(chip_smoke, tmp_path):
    """chip_smoke.py's phase [19] at a small size on the CPU: one process
    in bfloat16 and float32, two gloo ranks in both, and the float32 step
    held against itself (the CPU standing in for the card)."""
    out = chip_smoke.training_phase(torch.device("cpu"), tmp_path, p=N, batch=RANKS, steps=2,
                                    f32_steps=1, f=F, check=(N, 1))
    assert len(out["losses"]) == 2 and out["losses"][-1] < out["losses"][0]
    assert len(out["b"]) == 2 * RANKS and out["c"]["loss"] == 0.0

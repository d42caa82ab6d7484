"""The parcellation and mandible cells at tiny sizes on the CPU: sound runs
come out correct, traced runs report their per-layer metrics; each fault
planted in the parcellation, the parcellation's fp8 control and the
mandible's, and a probability altered in the mandible's segmenter come out
not correct; the readers of the parcellation's spans read nothing without
aligned spans; the operation counts against hand counts."""

import pytest
import torch

from gpubench import counts, counts_fastsurfer, faults, faults_parcellate, run
from gpubench.reference.unet3d import grid_starts
from gpubench.tests.tiny_cells import MANDIBLE, PARCELLATE, control_checks, run_tiny

torch.set_num_threads(2)
SEED = 2**32 + 21
METRICS = {PARCELLATE: {"device_idle_share", "fastsurfer_mfu", "fs_loop_idle_share",
                        "fs_build_ms", "fs_host_result_ms", "fs_weight_mb"},
           MANDIBLE: {"device_idle_share", "unet_mfu", "seg_loop_idle_share",
                      "seg_host_result_ms"}}
FS_SPANS = ["fs_loop_idle_share", "fs_build_ms", "fs_host_result_ms", "fs_weight_mb"]


@pytest.mark.parametrize("workload", [PARCELLATE, MANDIBLE])
def test_sound_run_is_correct(workload):
    r = run_tiny(workload, SEED)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {"action_s", "setup_s"}


def traced_run(workload, monkeypatch):
    """A tiny traced run's result and the context its readers saw."""
    seen = {}
    reader = run.metric_reader

    def keep_ctx(name):
        read = reader(name)

        def wrapped(ctx):
            seen["ctx"] = ctx
            return read(ctx)
        return wrapped

    monkeypatch.setattr(run, "metric_reader", keep_ctx)
    return run_tiny(workload, SEED + 1, trace=True), seen["ctx"]


@pytest.mark.parametrize("workload", [PARCELLATE, MANDIBLE])
def test_traced_run_reports_its_metrics(workload, monkeypatch):
    r, _ = traced_run(workload, monkeypatch)
    assert r["correct"] is True, r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == METRICS[workload]
    for name in m:
        if name.endswith("_idle_share"):
            assert 0.0 <= m[name] <= m["device_idle_share"]
    if workload == PARCELLATE:
        assert m["fs_build_ms"] > 0 and m["fs_host_result_ms"] > 0
        # three networks of 64 filters and 5x5 convolutions: 2 x 79 and 51
        # classes, float32, and each norm's int64 batch count
        assert m["fs_weight_mb"] == pytest.approx(32.221804, abs=1e-6)


@pytest.mark.parametrize("ring", ["empty", "off_the_actions"])
def test_readers_read_nothing_without_aligned_spans(ring, monkeypatch):
    from invesalius3_tpu_torch.utils import logging as ilog

    _, ctx = traced_run(PARCELLATE, monkeypatch)
    if ring == "empty":
        ilog._ring.clear()
    else:
        for e in ilog._ring:
            e["start_ns"] += 10**9
            e["end_ns"] += 10**9
    for name in FS_SPANS:
        assert run.metric_reader(name)(ctx) is None


@pytest.mark.parametrize("fault", ["batch_left_out", "middle_batch_left_out",
                                   "sagittal_unmapped", "equal_weights"])
def test_parcellation_fault_is_not_correct(fault):
    with faults_parcellate.planted(fault):
        r = run_tiny(PARCELLATE, SEED)
    assert r["correct"] is False and r["failed"] >= 1, r["checks"]


def test_mandible_fault_is_not_correct():
    with faults.planted("altered_probability"):
        r = run_tiny(MANDIBLE, SEED)
    assert r["correct"] is False and r["failed"] >= 1, r["checks"]


@pytest.mark.parametrize("workload", [PARCELLATE, MANDIBLE])
@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_control_fails(workload, seed):
    checks = control_checks(workload, seed)
    assert any(v > limit for v, limit in checks.values()), checks


@pytest.mark.parametrize("k, slice_gflop, action_tflop", [(3, 34.9, 26.8), (5, 95.8, 73.5)])
def test_parcellation_flops(k, slice_gflop, action_tflop):
    """FastSurferCNN at 256^2 a slice by the hand count below (the
    79-class nets), and an action's 768 slices, at the configuration's 5x5
    convolutions and at 3x3."""
    cfg = dict(run.load_json(run.HERE / "configs" / "fastsurfer_f64.json"), kernel=k)
    f, n = 64, 256 * 256
    hand = 0
    for side, convs in ((256, [7 * f, f * f, f * f] + [f * f] * 3),  # enc1, dec1
                        (128, [f * f] * 6), (64, [f * f] * 6), (32, [f * f] * 6),  # enc/dec 2-4
                        (16, [f * f] * 3)):  # the bottleneck
        hand += sum(2 * k * k * side * side * c for c in convs)
    assert counts_fastsurfer.slice_flops(256, 256, 79, k=k) == hand + 2 * n * f * 79
    assert hand + 2 * n * f * 79 == pytest.approx(slice_gflop * 1e9, rel=1e-3)
    total = counts_fastsurfer.parcellate_flops(cfg)
    assert total == 256 * (2 * (hand + 2 * n * f * 79) + hand + 2 * n * f * 51)
    assert total / 1e12 == pytest.approx(action_tflop, abs=0.05)


def test_batch_shares_localise_a_block():
    """The flips of one batch of slices read as that batch's share, where
    the whole volume's share dilutes them."""
    from gpubench.actions.parcellate import batch_shares

    decided = torch.ones((32, 32, 32), dtype=torch.bool)
    decided[:, :, :4] = False
    flips = torch.zeros_like(decided)
    flips[:, 8:16, :16] = True  # the second batch along axis 1, its decided half
    shares = batch_shares(flips, decided, 8)
    assert shares.shape == (12,)
    assert shares[4 + 1] == pytest.approx(12 / 28)
    assert float(shares.max()) == pytest.approx(12 / 28)
    assert float((flips & decided).sum() / decided.sum()) == pytest.approx(12 / 112)


def test_mandible_flops():
    """500 patches of 96^3 over 256 x 512^2, 59.4 TFLOP an action."""
    patches = len(grid_starts(256, 96, 0.5)) * len(grid_starts(512, 96, 0.5)) ** 2
    assert patches == 500
    assert counts.unet3d_flops(96) * patches / 1e12 == pytest.approx(59.44, abs=0.01)

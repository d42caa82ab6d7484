"""The per-layer metrics that read the program's own spans and counts: a
tiny traced CPU run of the watershed and of the segmentation reports them;
the flag reads are the rounds' batches after each level's first; every
idle share lies within the device's; with the program's ring empty, or
its spans off the harness's actions, the readers read nothing."""

import pytest

from gpubench import run
from gpubench.tests.tiny import run_tiny

CELLS = {"head_ct512.watershed": ["ws_flag_reads", "ws_flag_idle_share"],
         "unet3d_f8.brain_segment": ["seg_loop_idle_share", "seg_host_result_ms"]}


def traced_run(workload, monkeypatch):
    """The result of a tiny traced run and the context its readers saw."""
    seen = {}
    reader = run.metric_reader

    def keep_ctx(name):
        read = reader(name)

        def wrapped(ctx):
            seen["ctx"] = ctx
            return read(ctx)
        return wrapped

    monkeypatch.setattr(run, "metric_reader", keep_ctx)
    return run_tiny(workload, 2**31 + 17, trace=True), seen["ctx"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_traced_run_reports_the_program_metrics(workload, monkeypatch):
    r, ctx = traced_run(workload, monkeypatch)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(CELLS[workload]) <= set(m)
    for name in CELLS[workload]:
        if name.endswith("_idle_share"):
            assert 0.0 <= m[name] <= m["device_idle_share"]
    if "ws_flag_reads" in m:
        per_action = [sum(n // 2 - 1 for _, n in rec["rounds"]) for rec in ctx["traced_records"]]
        assert m["ws_flag_reads"] == sum(per_action) / len(per_action) > 0
    if "seg_host_result_ms" in m:
        assert m["seg_host_result_ms"] > 0


@pytest.mark.parametrize("ring", ["empty", "off_the_actions"])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_readers_read_nothing_without_aligned_spans(workload, ring, monkeypatch):
    """An empty ring, or spans that fall outside the harness's action spans
    (here moved a second late), give no reading."""
    from invesalius3_tpu_torch.utils import logging as ilog

    _, ctx = traced_run(workload, monkeypatch)
    if ring == "empty":
        ilog._ring.clear()
    else:
        for e in ilog._ring:
            e["start_ns"] += 10**9
            e["end_ns"] += 10**9
    for name in CELLS[workload]:
        assert run.metric_reader(name)(ctx) is None

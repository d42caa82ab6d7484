"""The result object has the keys every run prints, the numbers compared come
last, and a traced run adds the device's busy time, its window and the
breakdown."""

from gpubench import run
from gpubench.tests.tiny import run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_untraced_line():
    r = run_tiny("head_ct512.watershed", 9)
    assert list(r) == KEYS + ["checks"]
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    e2e = {m["name"] for m in run.metrics_of(run.manifest(), "head_ct512.watershed",
                                             "end_to_end")}
    assert set(r["metrics"]) == e2e - {"action_s_p95"}  # under 20 actions there is no tail
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line():
    r = run_tiny("head_ct512.watershed", 9, trace=True)
    assert list(r) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in r["breakdown"].values())
    assert "ws_rounds" in r["metrics"] and r["metrics"]["ws_rounds"]["value"] > 0
    # on the CPU no device work is traced: no roofline share is read as 0
    assert "sweep_roofline" not in r["metrics"]

"""The port's tracing (``utils/logging.py``'s ``span`` and ``count``) inside
the watershed, the segmenter and the training step, on the CPU at tiny
sizes: with no profiler recording nothing is traced; under
``torch.profiler`` the ring holds the spans and counts of each action, on
the clock of the profiler's Chrome trace; the answers are bit-identical
with tracing on and off."""

import json
import logging
import math

import numpy as np
import pytest
import torch

from invesalius3_tpu_torch import pipeline
from invesalius3_tpu_torch.models import segment, train, unet3d
from invesalius3_tpu_torch.models.layers import init_state
from invesalius3_tpu_torch.ops import watershed
from invesalius3_tpu_torch.utils import logging as ilog

torch.set_num_threads(2)
KINETO_PERIOD_NS = 7889238 * 10**9  # Kineto's Chrome trace counts from the epoch floored to these


@pytest.fixture(autouse=True)
def empty_ring():
    ilog._ring.clear()
    yield
    ilog._ring.clear()


def _watershed(rounds=None):
    n = 40
    ct = torch.from_numpy(pipeline.make_ct(n))
    markers = torch.from_numpy(pipeline.bench_markers(n))
    return watershed.watershed(ct, markers, multigrid_levels=2, rounds=rounds)


def _segmenter():
    model = unet3d.Unet3D(init_features=2, dtype=torch.float32)
    state = init_state(model, torch.Generator().manual_seed(3))
    return segment.BrainSegmenter(variables=state, model=model, patch_size=16, device="cpu")


SEG_IMAGE = np.random.default_rng(4).integers(0, 400, (24, 20, 28)).astype(np.int16)
SEG_BATCH = 3


def _segment(seg=None):
    return (seg or _segmenter()).segment(SEG_IMAGE, 0.5, SEG_BATCH)


def _train(steps=1):
    torch.manual_seed(5)
    model = unet3d.Unet3D(init_features=2, dtype=torch.float32)
    model.load_state_dict(init_state(model, torch.Generator().manual_seed(6)))
    opt = train.adam(model.parameters())
    g = torch.Generator().manual_seed(7)
    x = torch.rand((2, 1, 16, 16, 16), generator=g)
    y = (torch.rand((2, 1, 16, 16, 16), generator=g) > 0.5).float()
    losses = [train.train_step(model, opt, x, y) for _ in range(steps)]
    return losses, [p.detach().clone() for p in model.parameters()], opt


ACTIONS = {"watershed": _watershed, "segment": _segment, "train": _train}


def _traced(fn, *a):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn(*a)
    return out, ilog.perf_report()


@pytest.mark.parametrize("action", sorted(ACTIONS))
def test_untraced_spans_do_nothing(action, monkeypatch):
    """With no profiler recording, no span enters a ``record_function``,
    reads a clock, builds a span or appends to the ring."""
    entered, clocks = [], []
    real_rf = torch.profiler.record_function

    def record_function(name, *a, **kw):
        entered.append(name)
        return real_rf(name, *a, **kw)

    class Clock:
        def time_ns(self):
            clocks.append(1)
            return 0

    def no_span(*a, **kw):
        raise AssertionError("a span was built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(ilog, "time", Clock())
    monkeypatch.setattr(ilog, "Span", no_span)
    ACTIONS[action]()
    assert not [n for n in entered if n.startswith("invesalius.")]
    assert clocks == [] and ilog.perf_report() == []


def test_traced_watershed_ring():
    """One root ``watershed``; a ``watershed.level`` for each entry of the
    ``rounds=`` list with its rounds; ``flag_read`` spans as many as the
    root's ``watershed.flag_reads`` count and as Σ(rounds / 2 - 1), all
    carrying the root's id; the labels those of an untraced run."""
    plain = _watershed()
    rounds = []
    labels, ring = _traced(_watershed, rounds)
    assert torch.equal(labels, plain)
    (root,) = [e for e in ring if e["parent"] is None]
    assert root["name"] == "watershed" and tuple(root["attrs"]["shape"]) == (40, 40, 40)
    assert all(e["root"] == root["id"] for e in ring)
    levels = [e for e in ring if e["name"] == "watershed.level"]
    assert len(rounds) == 2
    assert [(tuple(e["attrs"]["shape"]), e["attrs"]["rounds"]) for e in levels] == rounds
    assert all(e["parent"] == root["id"] for e in levels)
    reads = [e for e in ring if e["name"] == "watershed.flag_read"]
    assert len(reads) == root["counts"]["watershed.flag_reads"] == sum(n // 2 - 1
                                                                      for _, n in rounds)
    assert {e["parent"] for e in reads} == {e["id"] for e in levels}
    assert len(ring) == 1 + len(levels) + len(reads)
    for e in ring:
        assert root["start_ns"] <= e["start_ns"] <= e["end_ns"] <= root["end_ns"]


def test_traced_segmenter_ring():
    """One root ``segment``; a ``segment.batch`` for each batch of the patch
    grid, each holding its gather, model and scatter; one ``host_result``
    with the bytes returned; probabilities and mask those of an untraced
    run."""
    seg = _segmenter()
    plain_prob, plain_mask = _segment(seg)
    (prob, mask), ring = _traced(_segment, seg)
    np.testing.assert_array_equal(prob, plain_prob)
    np.testing.assert_array_equal(mask, plain_mask)
    (root,) = [e for e in ring if e["parent"] is None]
    n = len(segment.patch_grid(SEG_IMAGE.shape, 16, 0.5))
    assert root["name"] == "segment"
    assert root["attrs"] == {"shape": SEG_IMAGE.shape, "batch": SEG_BATCH, "patches": n}
    batches = [e for e in ring if e["name"] == "segment.batch"]
    assert [e["attrs"]["index"] for e in batches] == list(range(math.ceil(n / SEG_BATCH)))
    for b in batches:
        assert b["parent"] == root["id"]
        kids = [e["name"] for e in ring if e["parent"] == b["id"]]
        assert kids == ["segment.gather", "segment.model", "segment.scatter"]
    (host,) = [e for e in ring if e["name"] == "segment.host_result"]
    assert host["parent"] == root["id"] and host["attrs"]["bytes"] == prob.nbytes + mask.nbytes
    assert all(e["root"] == root["id"] for e in ring)
    assert len(ring) == 2 + 4 * len(batches)


def test_traced_train_step_ring():
    """One root ``train.step`` with the batch's rows; the loss, the
    parameters and Adam's moments those of an untraced step."""
    plain_losses, plain_params, plain_opt = _train()
    (losses, params, opt), ring = _traced(_train)
    assert [(e["name"], e["parent"], e["attrs"]) for e in ring] == [("train.step", None,
                                                                    {"rows": 2})]
    assert torch.equal(losses[0], plain_losses[0])
    for got, want in zip(params + opt.mu + opt.nu, plain_params + plain_opt.mu + plain_opt.nu):
        assert torch.equal(got, want)


def test_ring_spans_lie_on_the_chrome_trace_clock(tmp_path):
    """Each ring span, less Kineto's base, falls within 1 ms of the
    ``invesalius.*`` annotation of the same span in the exported Chrome
    trace (matched in order, name by name)."""
    with ilog.trace(tmp_path):
        _watershed()
    (path,) = tmp_path.glob("*.json")
    trace = json.loads(path.read_text())
    by_name = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith("invesalius."):
            a = float(e["ts"]) * 1000
            by_name.setdefault(e["name"][len("invesalius."):], []).append((a, a + e["dur"] * 1000))
    ring = ilog.perf_report()
    base = trace.get("baseTimeNanoseconds",
                     ring[0]["start_ns"] // KINETO_PERIOD_NS * KINETO_PERIOD_NS)
    assert {e["name"] for e in ring} == set(by_name)
    for name, events in by_name.items():
        spans = sorted((e["start_ns"] - base, e["end_ns"] - base) for e in ring
                       if e["name"] == name)
        assert len(spans) == len(events)
        for (s, t), (a, b) in zip(spans, sorted(events)):
            assert abs(s - a) < 1e6 and abs(t - b) < 1e6, (name, s - a, t - b)


def test_ring_is_bounded_and_counts_go_to_the_root():
    """The ring keeps the last ``RING_SPANS`` spans; a count adds to the
    open root's ``counts`` (from a child too), and outside any span or
    with no profiler recording it is dropped."""
    ilog.count("lost")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        ilog.count("lost")
        for _ in range(ilog.RING_SPANS + 5):
            with ilog.span("s"):
                pass
        assert len(ilog.perf_report()) == ilog.RING_SPANS
        with ilog.span("root"):
            ilog.count("n")
            with ilog.span("child"):
                ilog.count("n", 4)
    root = ilog.perf_report()[-1]
    assert root["name"] == "root" and root["counts"] == {"n": 5}
    assert "counts" not in ilog.perf_report()[-2]


def test_only_root_spans_log_perf_lines():
    ilog.setup_logging(level=logging.DEBUG, console=False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with ilog.span("outer"):
            with ilog.span("inner"):
                pass
    perf = [ln for ln in ilog.recent_log_lines() if "[PERF]" in ln]
    assert len(perf) == 1 and "[PERF] outer:" in perf[0]

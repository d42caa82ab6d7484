"""The port's FastSurferCNN and 2.5D pipeline (models/fastsurfer.py,
``SubpartSegmenter``) against the plain reference
``gpubench/reference/fastsurfer.py``, on the CPU at small sizes, with the
benchmark's seeded weights (``gpubench/gen_fastsurfer.py``) at the
published 64 filters and 5x5 convolutions (the network also at 3x3): a block and the whole network, pooling with forced
ties, the sagittal map, the pipeline's sum and labels, the mask and id
guarantee, and the parcellation's spans and counters.

Tolerances:
- float32 block and network: within 1e-5 of the largest logit's magnitude
  (the same ``F.conv2d`` calls; measured below 2e-7);
- bf16 network: 90% of the logits within 3% of it, the bound
  tests/test_torch_unet.py holds the bf16 FastSurferCNN to against the bf16
  JAX model.  Against float32 the bf16 network is chaotic where a 2x2
  window's values nearly tie: a pooling index that flips on a rounding
  moves the unpooled value to another pixel, and the 27 convolutions after
  it spread that (measured: 1.9% at the 90th percentile, 4.2% at the 99th,
  16% at the largest); the reference's fp8 control reads 7.7% at the 90th
  percentile and fails it;
- pooling, indices, unpooling, the sagittal map, ids, mask, the traced
  answers: equal;
- the float32 pipeline's sum within 1e-5 of its largest magnitude, its
  labels equal wherever the reference's top two logits differ by more than
  1e-4 of the logits' standard deviation.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpubench import gen, gen_fastsurfer, run
from gpubench.reference import fastsurfer as ref
from invesalius3_tpu_torch.models import fastsurfer, segment
from invesalius3_tpu_torch.utils import logging as ilog

torch.set_num_threads(2)
CFG = dict(run.load_json(run.HERE / "configs" / "fastsurfer_f64.json"), conform=32)
N = CFG["conform"]
SEED = 2**31 + 21


@pytest.fixture(scope="module")
def weights():
    """A 32^3 T1 phantom and the three views' weights fitted on it."""
    t1 = gen.t1_head({"n": N, "noise_sd": 25.0}, SEED, torch.device("cpu"))
    return t1, gen_fastsurfer.state(CFG, SEED, t1)


@pytest.fixture(scope="module")
def weights_k3(weights):
    """The same phantom's weights for 3x3 convolutions (the program's
    default for a random init, the JAX package's)."""
    t1, _ = weights
    return t1, gen_fastsurfer.state(dict(CFG, kernel=3), SEED, t1)


def _net(state, classes, dtype, kernel=CFG["kernel"]):
    net = fastsurfer.FastSurferCNN(num_classes=classes, filters=CFG["filters"],
                                   kernel=kernel, dtype=dtype)
    net.load_state_dict(state)
    return net


def _slices(t1, axis=0, start=12, count=4):
    return ref.thick_slices(ref.conform(t1), axis, start, count)


def _float32(pipe):
    """The pipeline's networks computing their convolutions in float32."""
    for m in pipe.models.values():
        for mod in m.modules():
            if hasattr(mod, "dtype"):
                mod.dtype = torch.float32
    return pipe


def test_weights_load_strictly_into_the_port(weights):
    _, states = weights
    for view, classes in (("axial", 79), ("coronal", 79), ("sagittal", 51)):
        keys = set(fastsurfer.FastSurferCNN(num_classes=classes, filters=64,
                                            kernel=CFG["kernel"]).state_dict())
        assert set(states[view]) == {k for k in keys if not k.endswith("num_batches_tracked")}
        assert all(v.device.type == "cpu" and v.dtype == torch.float32
                   for v in states[view].values())


@pytest.mark.parametrize("block", ["enc1", "enc3", "dec2"])
def test_block_float32(weights, block):
    t1, states = weights
    net = _net(states["axial"], 79, torch.float32)
    x = _slices(t1)
    if block != "enc1":  # a block's input: 64 channels of the first block's output
        x = ref.block(states["axial"], "enc1", x)
    with torch.no_grad():
        got = getattr(net, block)(x)
        want = ref.block(states["axial"], block, x)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("kernel", [5, 3])
@pytest.mark.parametrize("view, classes", [("axial", 79), ("sagittal", 51)])
def test_network_float32(weights, weights_k3, view, classes, kernel):
    t1, states = weights if kernel == 5 else weights_k3
    assert states[view]["enc2.conv1.weight"].shape == (64, 64, kernel, kernel)
    x = _slices(t1, axis=2 if view == "sagittal" else 0)
    with torch.no_grad():
        got = _net(states[view], classes, torch.float32, kernel)(x)
        want = ref.forward(states[view], x)
    assert got.dtype == torch.float32 and got.shape == want.shape == (4, classes, N, N)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("side", ["port_bf16", "reference_fp8"])
def test_network_bf16(weights, side):
    """90% of the bf16 network's logits within 3% of the largest magnitude;
    the fp8 control is not."""
    t1, states = weights
    x = _slices(t1)
    with torch.no_grad():
        want = ref.forward(states["axial"], x)
        got = (_net(states["axial"], 79, torch.bfloat16)(x) if side == "port_bf16"
               else ref.forward(states["axial"], x, "fp8"))
    within = float(((got - want).abs() <= 0.03 * want.abs().max()).float().mean())
    assert (within >= 0.9) == (side == "port_bf16"), within


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pooling_with_ties_is_torchs(dtype):
    """Constant regions (every window a four-way tie), windows with two or
    three equal maxima, and distinct values: the port's first-maximum rule
    gives torch's values, indices and unpooled maps."""
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 3, (2, 5, 8, 12), generator=g).to(dtype)
    x[:, :2] = 7  # constant channels
    x[:, 2, :4] = torch.randn((2, 4, 12), generator=g).to(dtype)
    pooled, idx = fastsurfer.max_pool_with_indices(x)
    want, flat = F.max_pool2d(x, 2, 2, return_indices=True)
    assert torch.equal(pooled, want)
    dy, dx = idx.long() // 2, idx.long() % 2
    rows = 2 * torch.arange(4)[:, None] + dy
    cols = 2 * torch.arange(6)[None, :] + dx
    assert torch.equal(rows * 12 + cols, flat)
    assert torch.equal(fastsurfer.max_unpool(pooled, idx), F.max_unpool2d(want, flat, 2, 2))


def test_sagittal_map_is_the_configurations():
    assert CFG["class_ids"] == fastsurfer.class_ids().tolist()
    assert CFG["sagittal_ids"] == fastsurfer.get_labels_from_lut()[1].tolist()
    want = ref.sagittal_map(CFG["class_ids"], CFG["sagittal_ids"], CFG["left_right"])
    assert want.tolist() == fastsurfer.infer_sagittal_mapping().tolist()
    logits = torch.randn(2, 3, 51)
    assert torch.equal(fastsurfer.apply_sagittal_mapping(logits), logits[..., want])


def test_pipeline_takes_the_weights_kernel(weights, weights_k3):
    """The pipeline builds its networks at the weights' width, 3 with none
    (a random init)."""
    for (_, states), k in ((weights, 5), (weights_k3, 3)):
        assert fastsurfer.kernel_of(states) == fastsurfer.kernel_of(states["axial"]) == k
        pipe = fastsurfer.FastSurferPipeline(variables=states, device="cpu")
        assert {m.enc1.conv1.kernel_size for m in pipe.models.values()} == {(k, k)}
        assert {m.dec1.conv3.kernel_size for m in pipe.models.values()} == {(k, k)}
    pipe = fastsurfer.FastSurferPipeline(variables={}, filters=8, device="cpu")
    assert pipe.models["axial"].dec1.conv3.kernel_size == (3, 3)


def test_pipeline_float32(weights):
    t1, states = weights
    pipe = _float32(fastsurfer.FastSurferPipeline(variables=states, batch_size=8, device="cpu"))
    got = pipe.aggregate(fastsurfer.conform_tensor(t1, N))
    labels = pipe.run_tensor(t1.numpy(), conform_size=N, return_freesurfer_ids=True)
    want, want_labels = ref.parcellate(t1, states, CFG, 8)
    assert got.shape == want.shape == (N, N, N, 79)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    top2 = want.topk(2, dim=-1).values
    decided = top2[..., 0] - top2[..., 1] > 1e-4 * want.std()
    assert decided.float().mean() > 0.99
    assert torch.equal(labels[decided], want_labels[decided])


def test_mask_and_ids(weights):
    t1, states = weights
    labels, mask = segment.SubpartSegmenter(variables=states, conform_size=N,
                                            device="cpu").segment(t1.numpy(), batch_size=8)
    assert labels.shape == mask.shape == (N, N, N)
    assert labels.dtype == np.int32 and mask.dtype == np.uint8
    assert set(np.unique(labels).tolist()) <= set(CFG["class_ids"])
    np.testing.assert_array_equal(mask, np.where(labels > 0, 255, 0))


def test_spans_and_counts(weights):
    """Untraced the ring stays empty; under a profiler the parcellation is
    one root with the build, conform, three views of four batches each (a
    model and an add inside each), labels and host result; its counts are
    the slices through a network, the weight bytes moved and the dense
    blocks' fused transitions (36 a network call); the answers
    are the untraced ones bit for bit."""
    t1, states = weights
    sub = segment.SubpartSegmenter(variables=states, conform_size=N, device="cpu")
    ilog._ring.clear()
    plain = sub.segment(t1.numpy(), batch_size=8)
    assert ilog.perf_report() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = sub.segment(t1.numpy(), batch_size=8)
    spans = ilog.perf_report()
    ilog._ring.clear()
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "parcellate"
    assert root["attrs"] == {"shape": (N, N, N), "batch": 8, "conform": N}
    by_id = {s["id"]: s for s in spans}
    assert all(s["root"] == root["id"] for s in spans)

    def children(parent):
        return [s["name"] for s in spans if s["parent"] == parent["id"]]

    assert children(root) == ["parcellate.build", "parcellate.conform"] \
        + ["parcellate.view"] * 3 + ["parcellate.labels", "parcellate.host_result"]
    views = [s for s in spans if s["name"] == "parcellate.view"]
    assert [v["attrs"] for v in views] == [{"view": v} for v in ("axial", "coronal", "sagittal")]
    for v in views:
        batches = [s for s in spans if s["parent"] == v["id"]]
        assert [b["attrs"] for b in batches] == [{"index": i} for i in range(N // 8)]
        for b in batches:
            assert children(b) == ["parcellate.model", "parcellate.add"]
    host = [s for s in spans if s["name"] == "parcellate.host_result"][0]
    assert host["attrs"] == {"bytes": N ** 3 * 5}
    moved = sum(t.nbytes for s in states.values() for t in s.values()) + 8 * 3 * 28
    assert root["counts"] == {"parcellate.weight_bytes": moved, "parcellate.slices": 3 * N,
                              "fastsurfer.epilogue": 36 * 3 * (N // 8)}
    assert all(by_id[s["parent"]]["start_ns"] <= s["start_ns"] <= s["end_ns"]
               <= by_id[s["parent"]]["end_ns"] for s in spans if s["parent"] is not None)

"""The weight gradient of a 3D convolution with one input or one output
channel (``ops/conv_wgrad.py``) and its routing in ``models/layers.py``, on
the CPU: the plain version against float64, which convolutions the rule
routes, the forward's bits and the traced step's count.  The CUDA kernel is
held to the plain version on the card (``tests/test_torch_cuda.py``).

The plain version sums in float32 and rounds once to the inputs' dtype, so
against a float64 sum it may lie half a bfloat16 unit in the last place
off (2^-8 of the value) plus a float32 summation's error, bounded here by
1e-5 of the sum of the terms' magnitudes (measured at most 3.5e-8 on these
cases).
"""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from invesalius3_tpu_torch.models import layers, train, unet2d, unet3d
from invesalius3_tpu_torch.ops import conv_wgrad
from invesalius3_tpu_torch.utils import logging as ilog

# (c_in, c_out, k, (n, d, h, w), dtype)
CASES = {
    "first_conv_bf16": (1, 8, 5, (2, 12, 10, 14), torch.bfloat16),
    "head_f32": (8, 1, 1, (2, 12, 10, 14), torch.float32),
    "ragged": (1, 8, 5, (1, 13, 17, 23), torch.float32),
    "four_channels_k1": (1, 4, 1, (2, 9, 8, 11), torch.float32),
    "one_output_k5_bf16": (8, 1, 5, (1, 7, 9, 11), torch.bfloat16),
}
# the plain version takes any odd k; the kernel and the routing k 1 and 5
PLAIN_CASES = {**CASES, "k3": (1, 4, 3, (2, 9, 8, 11), torch.float32)}


def _case(name, seed=0):
    c_in, c_out, k, (n, d, h, w), dtype = PLAIN_CASES[name]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c_in, d, h, w, generator=g).to(dtype)
    dy = torch.randn(n, c_out, d, h, w, generator=g).to(dtype)
    return x, dy, k


@pytest.mark.parametrize("name", sorted(PLAIN_CASES))
def test_plain_weight_gradient_against_float64(name):
    x, dy, k = _case(name)
    got = conv_wgrad.conv_wgrad_ref(x, dy, k)
    assert got.dtype == x.dtype and got.shape == (dy.shape[1], x.shape[1], k, k, k)
    want = torch.nn.grad.conv3d_weight(x.double(), got.shape, dy.double(), padding=k // 2)
    terms = torch.nn.grad.conv3d_weight(x.double().abs(), got.shape, dy.double().abs(),
                                        padding=k // 2)
    room = 1e-5 * terms + (2.0 ** -8 * want.abs() if x.dtype == torch.bfloat16 else 0.0)
    assert bool(((got.double() - want).abs() <= room).all())


def _unet_convs(model):
    return {name: m for name, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d))}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_routing_takes_the_unets_single_channel_convolutions(dtype):
    model = unet3d.Unet3D(init_features=8, dtype=dtype)
    routed = {name for name, m in _unet_convs(model).items() if layers.wgrad_routed(m, dtype)}
    assert routed == {"encoder1.enc1_conv1", "conv"}
    with torch.no_grad():
        assert not any(layers.wgrad_routed(m, dtype) for m in _unet_convs(model).values())
    with torch.inference_mode():
        assert not any(layers.wgrad_routed(m, dtype) for m in _unet_convs(model).values())
    model.requires_grad_(False)
    assert not any(layers.wgrad_routed(m, dtype) for m in _unet_convs(model).values())


@pytest.mark.parametrize("layer", [
    nn.Conv2d(1, 8, 3, padding=1),              # 2D (Unet2D, FastSurfer)
    nn.ConvTranspose3d(8, 1, 4, 2, 1),          # transposed
    nn.Conv3d(2, 8, 5, padding=2),              # wider
    nn.Conv3d(1, 16, 5, padding=2),             # more than 8 channels
    nn.Conv3d(1, 8, 5, padding=1),              # not padded by k // 2
    nn.Conv3d(1, 8, 5, padding=2, stride=2),    # strided
    nn.Conv3d(1, 8, 7, padding=3),              # k > 5
    nn.Conv3d(1, 8, 3, padding=1),              # k 3: no U-Net convolution has it
    nn.Conv3d(1, 8, (5, 5, 3), padding=(2, 2, 1)),  # not cubic
], ids=["2d", "transposed", "wider", "sixteen", "padding", "stride", "k7", "k3", "not_cubic"])
def test_routing_leaves_other_convolutions_to_torch(layer):
    for dtype in (torch.bfloat16, torch.float32):
        assert not layers.wgrad_routed(layer, dtype)


def test_routing_leaves_a_jit_trace_to_torch():
    model = unet3d.Unet3D(init_features=2)
    traced = torch.jit.trace(model, torch.zeros(1, 1, 16, 16, 16))
    assert "PythonOp" not in str(traced.graph)


def test_routing_leaves_float16_and_unet2d_to_torch():
    assert not layers.wgrad_routed(nn.Conv3d(1, 8, 5, padding=2), torch.float16)
    assert layers.wgrad_routed(nn.Conv3d(1, 8, 5, padding=2), torch.bfloat16)
    model = unet2d.Unet2D(features=4)
    assert not any(layers.wgrad_routed(m, torch.bfloat16) for m in _unet_convs(model).values())


@pytest.mark.parametrize("name", sorted(CASES))
def test_routed_forward_is_bit_identical(name):
    c_in, c_out, k, _, dtype = CASES[name]
    layer = nn.Conv3d(c_in, c_out, k, padding=k // 2)
    x, _, _ = _case(name)
    assert layers.wgrad_routed(layer, dtype)
    got = layers.conv(layer, x, dtype)
    with torch.no_grad():
        assert not layers.wgrad_routed(layer, dtype)
        want = layers.conv(layer, x, dtype)
    assert got.requires_grad and torch.equal(got.detach(), want)


@pytest.mark.parametrize("name", ["head_f32", "one_output_k5_bf16"])
def test_routed_backward_matches_autograd(name):
    """Both gradients of a routed convolution whose input takes one: the
    input's as autograd computes it, the weight's as the plain version."""
    c_in, c_out, k, _, dtype = CASES[name]
    layer = nn.Conv3d(c_in, c_out, k, padding=k // 2)
    x, dy, _ = _case(name, seed=1)
    xr = x.clone().requires_grad_(True)
    layers.conv(layer, xr, dtype).backward(dy)
    xp = x.clone().requires_grad_(True)
    F.conv3d(xp, layer.weight.detach().to(dtype), None, padding=k // 2).backward(dy)
    assert torch.equal(xr.grad, xp.grad)
    want = conv_wgrad.conv_wgrad_ref(x, dy, k).to(torch.float32)
    assert torch.equal(layer.weight.grad, want)


def _step(dtype, seed=3):
    model = unet3d.Unet3D(init_features=2, dtype=dtype)
    model.load_state_dict(layers.init_state(model, torch.Generator().manual_seed(seed)))
    x = torch.rand(2, 1, 16, 16, 16, generator=torch.Generator().manual_seed(seed))
    return model, train.adam(model.parameters()), x, (x > 0.5).to(torch.float32)


def test_train_step_routes_two_weight_gradients(monkeypatch):
    calls = []
    plain = conv_wgrad.conv_wgrad
    monkeypatch.setattr(conv_wgrad, "conv_wgrad",
                        lambda x, dy, k: calls.append((x.shape[1], dy.shape[1], k)) or plain(x, dy, k))
    model, opt, x, y = _step(torch.bfloat16)
    train.train_step(model, opt, x, y)
    assert sorted(calls) == [(1, 2, 5), (2, 1, 1)]
    calls.clear()
    model.train()
    with torch.inference_mode():
        model(x)
    assert calls == []


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_routed_step_forward_and_loss_equal_torchs(dtype, monkeypatch):
    """A training step's loss (the forward) is the same with the weight
    gradients routed or all on torch; the routed weights' gradients are
    the plain version's."""
    model, opt, x, y = _step(dtype)
    routed_loss = train.train_step(model, opt, x, y)
    routed = {k: p.grad.clone() for k, p in model.named_parameters()}
    monkeypatch.setattr(layers, "wgrad_routed", lambda layer, dtype: False)
    model, opt, x, y = _step(dtype)
    loss = train.train_step(model, opt, x, y)
    assert torch.equal(routed_loss, loss)
    for k, p in model.named_parameters():
        if k in ("encoder1.enc1_conv1.weight", "conv.weight"):
            # float32 sums in other orders; a bfloat16 weight gradient one
            # unit in the last place apart where they round apart
            ulp = 2.0 ** -7 if dtype == torch.bfloat16 and k != "conv.weight" else 0.0
            room = 1e-4 * p.grad.abs().max() + ulp * p.grad.abs()
            assert bool(((routed[k] - p.grad).abs() <= room).all()), k
        else:
            assert torch.equal(routed[k], p.grad), k


def test_traced_step_counts_the_weight_gradients():
    model, opt, x, y = _step(torch.bfloat16)
    train.train_step(model, opt, x, y)  # untraced: nothing recorded
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        train.train_step(model, opt, x, y)
    step = [e for e in ilog.perf_report() if e["name"] == "train.step"][-1]
    assert step["counts"] == {"conv.wgrad_kernel": 2}


def test_count_reaches_a_root_named_from_another_thread():
    import threading

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with ilog.span("outer"):
            root = ilog.root_span()
            t = threading.Thread(target=ilog.count, args=("c",), kwargs={"root": root})
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            ilog.count("c")
    assert [e for e in ilog.perf_report() if e["name"] == "outer"][-1]["counts"] == {"c": 2}
    assert ilog.root_span() is None


@pytest.mark.parametrize("shapes,dtypes,k,error", [
    (((1, 2, 4, 4, 4), (1, 8, 4, 4, 4)), (torch.float32,) * 2, 5, ValueError),   # 2 -> 8
    (((1, 1, 4, 4, 4), (1, 9, 4, 4, 4)), (torch.float32,) * 2, 5, ValueError),   # 1 -> 9
    (((1, 1, 4, 4, 4), (1, 8, 4, 4, 4)), (torch.float32,) * 2, 4, ValueError),   # even k
    (((1, 1, 4, 4, 4), (1, 8, 4, 4, 4)), (torch.float32,) * 2, 3, ValueError),   # k 3
    (((1, 1, 4, 4, 4), (1, 8, 4, 4, 5)), (torch.float32,) * 2, 5, ValueError),   # volumes
    (((1, 1, 4, 4, 4), (2, 8, 4, 4, 4)), (torch.float32,) * 2, 5, ValueError),   # batches
    (((1, 1, 4, 4, 4), (1, 8, 4, 4, 4)), (torch.float16,) * 2, 5, TypeError),
    (((1, 1, 4, 4, 4), (1, 8, 4, 4, 4)), (torch.float32, torch.bfloat16), 5, TypeError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(shapes, dtypes, k, error):
    x, dy = (torch.zeros(s, dtype=t) for s, t in zip(shapes, dtypes))
    with pytest.raises(error):
        conv_wgrad.conv_wgrad(x, dy, k)


def test_wrapper_rejects_two_devices():
    with pytest.raises(ValueError):
        conv_wgrad.conv_wgrad(torch.zeros(1, 1, 4, 4, 4),
                              torch.zeros(1, 8, 4, 4, 4, device="meta"), 5)

"""The competitive dense block's fused transition (``ops/cdb_epilogue.py``)
on the CPU: its plain version against the block's own modules bit for bit,
a routed ``FastSurferCNN`` forward against the modules' eager composition,
what is not routed, and what the wrapper refuses.  The kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from invesalius3_tpu_torch.models import fastsurfer as fs
from invesalius3_tpu_torch.models.layers import PReLU, load
from invesalius3_tpu_torch.ops import cdb_epilogue as ep

# a sibling helper module, by its bare name (see its docstring)
from cdb_oracle import (SPECIALS, eager_block, eager_forward, network, same_bits,
                        thick_batch, varied_state)

torch.set_num_threads(2)


def _with_specials(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    flat = t.view(-1)
    flat[:len(SPECIALS)] = torch.tensor(SPECIALS).to(t.dtype)
    return t


# the block's four transitions: (transition, in_block) -> what the modules do
TRANSITIONS = [("entry", True), ("entry", False), ("conv1", True), ("conv1", False),
               ("conv2", False), ("conv3", False)]


def _block_case(transition, in_block, dtype, seed=5):
    c = 6
    block = fs.CompetitiveDenseBlock(c, c, 3, in_block, dtype)
    block = load(block, varied_state(block, seed), "cpu").eval()
    g = torch.Generator().manual_seed(seed)
    y = _with_specials(torch.randn(2, c, 5, 8, generator=g) * 3)
    skip = _with_specials(torch.randn(2, c, 5, 8, generator=g) * 3).flip(-1).contiguous()
    if transition != "entry" or in_block:
        y = y.to(dtype)  # a convolution's output, or the network's cast input
    return block, y, skip


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("transition,in_block", TRANSITIONS,
                         ids=[f"{t}_{'in_block' if b else 'middle'}" for t, b in TRANSITIONS])
def test_ref_equals_the_modules(transition, in_block, dtype):
    """Each transition's plain version is its modules' result bit for bit,
    NaN, infinities, signed zeros and subnormals included."""
    block, y, skip = _block_case(transition, in_block, dtype)
    with torch.inference_mode():
        terms = dict(zip(("bn0", "bn1", "bn2", "bn3"),
                         (block._norm_terms(n) if hasattr(block, n) else None
                          for n in ("bn0", "bn1", "bn2", "bn3"))))
        if transition == "entry":
            if in_block:
                want, got = block.bn0(y).to(dtype), ep.cdb_epilogue_ref(y, terms["bn0"], act=dtype)
            else:
                want = block.prelu1(y).to(dtype)
                got = ep.cdb_epilogue_ref(y, slope=block.prelu1.weight, act=dtype)
            assert got[0] is None and same_bits(got[1], want)
            return
        if transition == "conv3":
            out, act = ep.cdb_epilogue_ref(y, terms["bn3"], out=True)
            assert act is None and same_bits(out, block.bn3(y))
            return
        bn, prelu = (block.bn1, block.prelu2) if transition == "conv1" else (block.bn2,
                                                                             block.prelu3)
        m = bn(y) if in_block else torch.maximum(bn(y), skip)
        out, act = ep.cdb_epilogue_ref(y, terms["bn1" if transition == "conv1" else "bn2"],
                                       None if in_block else skip, prelu.weight, True, dtype)
        assert same_bits(out, m) and same_bits(act, prelu(m).to(dtype))


@pytest.mark.parametrize("kernel,dtype", [(3, torch.bfloat16), (5, torch.bfloat16),
                                          (3, torch.float32)], ids=["3x3_bf16", "5x5_bf16",
                                                                    "3x3_f32"])
def test_routed_network_equals_the_eager_modules(kernel, dtype):
    """An eval forward under ``inference_mode`` takes the fused path, four
    calls a block, 36 a network, and gives the eager composition's logits
    bit for bit."""
    net, x = network(dtype, kernel), thick_batch()
    ep.reset_launches()
    with torch.inference_mode():
        got = net(x)
    assert ep.LAUNCHES == {"cdb_epilogue": 0, "ref": 36}
    with torch.no_grad():
        want = eager_forward(net, x)
    assert same_bits(got, want)


def _block_run(block, x, grad=False):
    ep.reset_launches()
    with torch.set_grad_enabled(grad):
        return block(x), ep.LAUNCHES["ref"]


def test_not_routed_in_train_mode():
    block = network().enc2
    x = torch.randn(2, 8, 16, 16)
    want_block = network().enc2.train()
    block.train()
    got, calls = _block_run(block, x)
    with torch.no_grad():
        want = eager_block(want_block, x)
    assert calls == 0 and same_bits(got, want)
    assert torch.equal(block.bn1.running_var, want_block.bn1.running_var)


def test_not_routed_with_autograd():
    block = network().enc2
    x = torch.randn(2, 8, 16, 16, requires_grad=True)
    got, calls = _block_run(block, x, grad=True)
    assert calls == 0 and got.requires_grad
    got.sum().backward()
    assert x.grad is not None and block.bn1.weight.grad is not None
    with torch.no_grad():
        assert same_bits(got.detach(), eager_block(block, x))


def test_not_routed_with_a_slope_per_channel():
    block = network().dec1
    block.prelu2 = PReLU(num_parameters=8, init=0.1)
    x = torch.randn(2, 8, 8, 8)  # W = C, so the eager slope broadcasts
    got, calls = _block_run(block, x)
    assert calls == 0 and same_bits(got, eager_block(block, x))


@pytest.mark.parametrize("x", [torch.randn(2, 8, 16, 16).transpose(2, 3),
                               torch.randn(2, 8, 16, 16).to(torch.bfloat16),
                               torch.randn(2, 8, 16, 16).to(torch.float64)],
                         ids=["non_contiguous", "bf16_middle", "float64"])
def test_not_routed_for_other_inputs(x):
    """A middle block's fused path takes a contiguous float32 input only."""
    block = network().enc3
    got, calls = _block_run(block, x)
    assert calls == 0 and same_bits(got, eager_block(block, x))


def test_norm_terms_follow_the_buffers():
    """``mul`` is made once a network, and anew after the running variance
    or the scale changes in place."""
    net, x = network(), thick_batch()
    with torch.inference_mode():
        net(x)
    first = net.enc2._muls["bn1"][1]
    with torch.inference_mode():
        net(x)
    assert net.enc2._muls["bn1"][1] is first
    with torch.no_grad():
        net.enc2.bn1.running_var.mul_(3.0)
        net.dec3.bn2.weight.mul_(-2.0)
    with torch.inference_mode():
        got = net(x)
    assert net.enc2._muls["bn1"][1] is not first
    with torch.no_grad():
        assert same_bits(got, eager_forward(net, x))


def _y(c=4, dtype=torch.bfloat16):
    return torch.randn(2, c, 4, 8).to(dtype)


def _norm(c=4):
    return torch.zeros(c), torch.ones(c), torch.zeros(c)


REFUSALS = {
    "non_contiguous_y": ValueError, "non_contiguous_skip": ValueError,
    "float16_y": TypeError, "float64_skip": TypeError, "int_act": TypeError,
    "bf16_slope": TypeError, "channels_of_the_norm": ValueError, "skip_shape": ValueError,
    "three_dims": ValueError, "empty": ValueError, "nothing_asked": ValueError,
    "slope_without_act": ValueError, "meta_device": ValueError,
}


def _refused(case):
    y = _y()
    if case == "non_contiguous_y":
        return dict(y=y.transpose(2, 3), norm=_norm(), act=torch.bfloat16)
    if case == "non_contiguous_skip":
        return dict(y=y, skip=torch.randn(2, 4, 8, 4).transpose(2, 3), out=True)
    if case == "float16_y":
        return dict(y=y.half(), out=True)
    if case == "float64_skip":
        return dict(y=y, skip=torch.randn(2, 4, 4, 8, dtype=torch.float64), out=True)
    if case == "int_act":
        return dict(y=y, act=torch.int8)
    if case == "bf16_slope":
        return dict(y=y, slope=torch.ones(1, dtype=torch.bfloat16), act=torch.bfloat16)
    if case == "channels_of_the_norm":
        return dict(y=y, norm=_norm(5), out=True)
    if case == "skip_shape":
        return dict(y=y, skip=torch.randn(2, 4, 4, 9), out=True)
    if case == "three_dims":
        return dict(y=y[0], out=True)
    if case == "empty":
        return dict(y=y[:0], out=True)
    if case == "nothing_asked":
        return dict(y=y, norm=_norm())
    if case == "slope_without_act":
        return dict(y=y, slope=torch.ones(1), out=True)
    return dict(y=torch.empty(2, 4, 4, 8, device="meta"), out=True)


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses(case):
    ep.reset_launches()
    with pytest.raises(REFUSALS[case]):
        ep.cdb_epilogue(**_refused(case))
    assert ep.LAUNCHES == {"cdb_epilogue": 0, "ref": 0}

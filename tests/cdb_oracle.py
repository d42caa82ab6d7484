"""The eager composition that FastSurferCNN's fused dense-block path is
held to, bit for bit, by ``test_torch_cdb_epilogue.py`` on the CPU and by
``test_torch_cuda.py`` on the card: the blocks' own modules one by one, and
the networks, inputs and bit comparisons both use.  A helper module, not a
test module: importing it sets nothing.  The tests import it by its bare
name, which pytest's default ``prepend`` import mode allows by putting this
directory (no package) on ``sys.path``."""

import torch

from invesalius3_tpu_torch.models import fastsurfer as fs
from invesalius3_tpu_torch.models.layers import conv, init_state, load

SPECIALS = [float("nan"), -0.0, 0.0, float("inf"), -float("inf"), 1e-40, -1e-40, 3.0]


def eager_block(block: fs.CompetitiveDenseBlock, x: torch.Tensor) -> torch.Tensor:
    """The block's forward as its modules compute it one by one."""
    dt = block.dtype
    if block.in_block:
        m1 = block.bn1(conv(block.conv1, block.bn0(x), dt))
    else:
        m1 = torch.maximum(block.bn1(conv(block.conv1, block.prelu1(x), dt)), x)
    m2 = torch.maximum(block.bn2(conv(block.conv2, block.prelu2(m1), dt)), m1)
    return block.bn3(conv(block.conv3, block.prelu3(m2), dt))


def eager_forward(net: fs.FastSurferCNN, x: torch.Tensor) -> torch.Tensor:
    """``FastSurferCNN.forward`` with every block run by ``eager_block``."""
    with fs.fp32_convs(x.device):
        skips, indices = [], []
        y = x.to(net.dtype)
        for i in range(1, 5):
            y = eager_block(getattr(net, f"enc{i}"), y)
            skips.append(y)
            y, idx = fs.max_pool_with_indices(y)
            indices.append(idx)
        y = eager_block(net.bottleneck, y)
        for i in range(3, -1, -1):
            y = torch.maximum(fs.max_unpool(y, indices[i]), skips[i])
            y = eager_block(getattr(net, f"dec{i + 1}"), y)
        return conv(net.classifier, y, torch.float32)


def varied_state(module: torch.nn.Module, seed: int) -> dict:
    """``init_state`` with every norm's four terms and every slope drawn
    away from the identity, so that each term moves the result."""
    state = init_state(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for name, t in state.items():
        norm = ".bn" in "." + name
        if norm and name.endswith(("running_var", "weight")):
            state[name] = 0.5 + torch.rand(t.shape, generator=g)
        elif norm or "prelu" in name:
            state[name] = torch.randn(t.shape, generator=g) * 0.5
    return state


def network(dtype=torch.bfloat16, kernel=3, filters=8, classes=5, device="cpu"):
    net = fs.FastSurferCNN(num_classes=classes, filters=filters, kernel=kernel, dtype=dtype)
    return load(net, varied_state(net, 11), device)


def thick_batch(n=2, side=32, seed=3, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, fs.THICK, side, side, generator=g) * 255).to(device)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.dtype == want.dtype and got.shape == want.shape and torch.equal(bits(got),
                                                                                bits(want))

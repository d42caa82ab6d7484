"""The layers of the JAX package's Flax models, with Flax's cast points.

The Flax models compute convolutions in ``dtype`` (bfloat16 in the
segmenters) with float32 parameters, and everything else in float32:

- ``nn.Conv`` / ``nn.ConvTranspose`` cast input and kernel to ``dtype``,
  convolve to a ``dtype`` result, then add the bias cast to ``dtype`` (two
  roundings in bfloat16; cuDNN's fused bias would round once);
- ``nn.BatchNorm(dtype=float32)`` promotes its input and returns float32:
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, with the running
  statistics in eval mode and the batch's in train mode (``BatchNorm``);
- a layer without a dtype (the 1x1 heads) runs in float32.

``torch.autocast`` casts at other points, so the modules call ``conv`` with
the dtype Flax uses.  Parameters stay float32 and are cast at use.  On the
card, float32 convolutions run with TF32 off inside ``fp32_convs``, as the
JAX reference computes them in float32.

A 3D convolution with one input or one output channel (``wgrad_routed``)
whose weight takes a gradient computes that gradient with the port's own
kernel (``ops/conv_wgrad.py``) instead of cuDNN's: the same sum in float32,
rounded once to the convolution's dtype.  Its forward is the same
``conv3d`` call.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from invesalius3_tpu_torch.ops import conv_wgrad
from invesalius3_tpu_torch.parallel import collectives
from invesalius3_tpu_torch.utils import logging as ilog

_CONV_FNS = {
    nn.Conv2d: F.conv2d, nn.Conv3d: F.conv3d,
    nn.ConvTranspose2d: F.conv_transpose2d, nn.ConvTranspose3d: F.conv_transpose3d,
}


def wgrad_routed(layer: nn.Module, dtype: torch.dtype) -> bool:
    """Whether ``conv`` takes the weight gradient of ``layer`` in ``dtype``
    from ``ops/conv_wgrad.py``: an ``nn.Conv3d`` of one group, stride 1, a
    cubic kernel of side 1 or 5 padded by k // 2, one input or one
    output channel and at most 8 on the other side, float32 or bfloat16,
    while autograd records and the weight takes a gradient (and no
    ``torch.jit`` trace records: a traced module keeps torch's
    convolution)."""
    if not torch.is_grad_enabled() or type(layer) is not nn.Conv3d:
        return False
    k = layer.kernel_size[0]
    return (layer.kernel_size == (k,) * 3 and layer.padding == (k // 2,) * 3
            and layer.stride == (1, 1, 1) and layer.groups == 1
            and conv_wgrad.takes(layer.in_channels, layer.out_channels, k)
            and dtype in (torch.float32, torch.bfloat16)
            and layer.weight.requires_grad and not torch.jit.is_tracing())


class _WgradConv3d(torch.autograd.Function):
    """``conv3d(x, w, padding=w.shape[-1] // 2)`` whose weight gradient comes
    from ``conv_wgrad.conv_wgrad`` (the kernel on the card, its plain
    version on the CPU) and whose input gradient, when asked for, from
    ``torch.nn.grad.conv3d_input``.  Each weight gradient adds 1 to the
    traced step's ``conv.wgrad_kernel`` count: autograd runs a CUDA backward
    on a thread of its own, so the root span is taken in the forward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.root = ilog.root_span()
        return F.conv3d(x, w, None, stride=1, padding=w.shape[-1] // 2)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w = ctx.saved_tensors
        k = w.shape[-1]
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv3d_input(x.shape, w, dy, padding=k // 2)
        if ctx.needs_input_grad[1]:
            gw = conv_wgrad.conv_wgrad(x.contiguous(), dy.contiguous(), k)
            ilog.count("conv.wgrad_kernel", root=ctx.root)
        return gx, gw


def conv(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` (a torch Conv / ConvTranspose holding the weights) applied
    as the Flax layer with ``dtype`` applies it: input and kernel in
    ``dtype``, a ``dtype`` result, then the ``dtype`` bias added.  The
    weight gradient of a ``wgrad_routed`` layer comes from
    ``ops/conv_wgrad.py``."""
    if wgrad_routed(layer, dtype):
        y = _WgradConv3d.apply(x.to(dtype), layer.weight.to(dtype))
    else:
        y = _CONV_FNS[type(layer)](x.to(dtype), layer.weight.to(dtype), None,
                                   stride=layer.stride, padding=layer.padding)
    if layer.bias is not None:
        y = y + layer.bias.to(dtype).view((1, -1) + (1,) * (y.dim() - 2))
    return y


MOMENTUM = 0.9  # Flax's: running = 0.9 * running + 0.1 * batch


class _GroupSum(torch.autograd.Function):
    """A sum over the ranks of a process group.  Every rank's loss depends
    on every rank's input through the sum, so the backward sums the
    cotangents over the group too."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return collectives.all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return collectives.all_reduce(grad, ctx.group), None


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Batch norm as Flax's ``nn.BatchNorm(dtype=float32, momentum=0.9)``
    computes it.  Its keys are torch's (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``), and a state
    dict without ``num_batches_tracked`` loads strictly, as into
    ``nn.BatchNorm*d``.

    In eval mode it normalises with the running statistics (Flax's
    ``use_running_average=True``).  In train mode it normalises with the
    batch's: float32 sums over every axis but the channel, ``mean = E[x]``
    and the fast variance ``max(E[x^2] - E[x]^2, 0)`` (Flax's
    ``use_fast_variance`` and ``force_float32_reductions``), and it updates
    the running statistics in place with Flax's momentum (``MOMENTUM``; the
    biased variance; torch's ``momentum`` attribute is not read).  With a
    process ``group`` set, the sums, and in the backward their cotangents,
    cross every rank, so each rank normalises with the global batch's
    statistics, as ``jit`` does over a sharded batch axis."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps)
        self.group = None

    def _check_input_dim(self, x: torch.Tensor) -> None:
        pass

    def _batch_stats(self, x: torch.Tensor):
        """(mean, var) of ``x`` per channel, over the group's ranks when it
        has one."""
        xf = x.to(torch.float32)
        dims = [0] + list(range(2, x.dim()))
        count = xf.new_full((1,), x.numel() // x.shape[1])
        sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims), count])
        if self.group is not None:
            sums = _GroupSum.apply(sums, self.group)
        c = x.shape[1]
        mean = sums[:c] / sums[-1]
        return mean, torch.clamp_min(sums[c:2 * c] / sums[-1] - mean * mean, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            mean, var = self._batch_stats(x)
            with torch.no_grad():
                self.running_mean.copy_(MOMENTUM * self.running_mean + (1 - MOMENTUM) * mean)
                self.running_var.copy_(MOMENTUM * self.running_var + (1 - MOMENTUM) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x.to(torch.float32) - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class PReLU(nn.PReLU):
    """Flax's ``nn.PReLU``: ``where(x >= 0, x, slope * x)``, the slope in
    the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


@contextlib.contextmanager
def fp32_convs(device: torch.device):
    """cuDNN's float32 convolutions in full float32 (not TF32) inside the
    block, on the card; the previous setting comes back after it."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def init_state(module: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A random state dict for ``module`` from ``generator`` (host float32),
    drawn as Flax's initialisers draw: kernels normal with variance
    1 / fan_in, biases 0, batch norms the identity (scale 1, bias 0, mean 0,
    var 1), PReLU slopes 0.25.  For tests and smoke runs only: an untrained
    network's output is noise."""
    state = {}
    for name, m in module.named_modules():
        p = f"{name}." if name else ""
        if isinstance(m, tuple(_CONV_FNS)):
            fan_in = m.in_channels * math.prod(m.kernel_size)
            state[p + "weight"] = torch.randn(
                m.weight.shape, generator=generator) / math.sqrt(fan_in)
            if m.bias is not None:
                state[p + "bias"] = torch.zeros(m.bias.shape)
        elif isinstance(m, BatchNorm):
            n = m.num_features
            state.update({p + "weight": torch.ones(n), p + "bias": torch.zeros(n),
                          p + "running_mean": torch.zeros(n),
                          p + "running_var": torch.ones(n)})
        elif isinstance(m, nn.PReLU):
            state[p + "weight"] = torch.full((m.num_parameters,), 0.25)
    return state


def as_state(variables) -> Dict[str, torch.Tensor]:
    """A state dict of host tensors from one of numpy arrays or tensors."""
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v)) for k, v in variables.items()}


def load(module: nn.Module, variables, device: torch.device,
         memory_format: torch.memory_format = torch.contiguous_format) -> nn.Module:
    """``module`` with ``variables`` loaded strictly, in eval mode, on
    ``device``, its weights in ``memory_format``."""
    module.load_state_dict(as_state(variables), strict=True)
    return module.eval().to(device).to(memory_format=memory_format)

"""Training of the segmentation models (port of the U-Net training step in
``__graft_entry__.py``: Flax's ``train=True``, binary cross-entropy,
``jax.value_and_grad`` and ``optax.adam(1e-3)`` over a batch sharded on a
"data" mesh axis).

    model = Unet3D(dtype=torch.bfloat16).to(dev)   # eval mode until a step
    opt = adam(model.parameters())
    loss = train_step(model, opt, x, y)           # x, y: (N, 1, D, H, W)

Across the processes of a ``torch.distributed`` group each rank feeds its
rows of the global batch (``parallel/distributed.local_data_slice``) and
passes the group: the batch norms normalise with the global batch's
statistics, each rank backpropagates its loss over the number of ranks and
the parameter gradients are summed over the group, which is the gradient
of the global batch's loss that the JAX package's sharded ``jit`` takes.
Every rank then takes the same Adam step.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from invesalius3_tpu_torch.models.layers import BatchNorm, fp32_convs
from invesalius3_tpu_torch.parallel import collectives
from invesalius3_tpu_torch.utils import logging as ilog

B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0  # optax.adam's defaults


def bce_loss(probs: torch.Tensor, y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The mean binary cross-entropy of probabilities ``probs`` against
    targets ``y``, in the graft entry's formula:
    ``-mean(y log(p + eps) + (1 - y) log(1 - p + eps))``."""
    return -torch.mean(y * torch.log(probs + eps) + (1 - y) * torch.log(1 - probs + eps))


class Adam:
    """``optax.adam(lr)`` (``scale_by_adam`` then ``scale_by_learning_rate``,
    optax's default ``B1``, ``B2``, ``EPS`` and ``EPS_ROOT``), written out in
    optax's order on float32 moments: ``mu = (1 - b1) g + b1 mu``,
    ``nu = (1 - b2) g^2 + b2 nu``, each divided by its bias correction
    ``1 - b^count``, the update ``-lr mu_hat / (sqrt(nu_hat + eps_root) +
    eps)`` added to the parameter.  ``step`` reads each parameter's
    ``.grad``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3):
        self.params: List[torch.Tensor] = list(params)
        self.lr = lr
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        # optax computes the corrections in float32 (a Python float to an
        # int32 count's power)
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(self.count))
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * (g * g) + B2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2 + EPS_ROOT) + EPS)
            p.add_(-self.lr * update)

    def load_state_dict(self, state: dict) -> None:
        """Take ``{"count", "mu", "nu"}``, the moments listed in the
        parameters' order (``convert.adam_state_from_jax``'s form): they are
        copied onto the parameters' devices."""
        if len(state["mu"]) != len(self.params) or len(state["nu"]) != len(self.params):
            raise ValueError(f"{len(state['mu'])} moments for {len(self.params)} parameters")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst.shape != src.shape:
                raise ValueError(f"a moment of shape {tuple(src.shape)} for a parameter of "
                                 f"shape {tuple(dst.shape)}")
            dst.copy_(src)


def adam(params: Iterable[torch.Tensor], lr: float = 1e-3) -> Adam:
    """``optax.adam(lr)`` over ``params`` (as the graft entry's
    ``optax.adam(1e-3)``)."""
    return Adam(params, lr)


@contextlib.contextmanager
def _training(model: nn.Module, group):
    """``model`` in train mode with its batch norms' statistics over
    ``group``; its mode and the norms' groups come back after the block."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    was = model.training
    model.train()
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None
        model.train(was)


def train_step(model: nn.Module, opt: Adam, x: torch.Tensor, y: torch.Tensor,
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """One training step on this rank's rows ``x`` of the batch and their
    targets ``y``: the model in train mode (the JAX ``train=True``), the
    BCE of its probabilities, the gradients and one Adam step.  Returns the
    loss of the global batch (0-d float32, detached); leaves the parameters
    stepped, the batch norms' running statistics updated, each parameter's
    ``.grad`` the global batch's gradient, and the model in its former
    mode.  With ``group`` every rank must hold the same number of rows.
    Traced (``utils.logging.span``), it is the span ``train.step``."""
    with ilog.span("train.step", rows=x.shape[0]):
        world = 1 if group is None else dist.get_world_size(group)
        opt.zero_grad()
        with _training(model, group):
            loss = bce_loss(model(x), y)
            with fp32_convs(x.device):  # the backward's float32 convolutions too
                (loss if world == 1 else loss / world).backward()
        loss = loss.detach()
        if world > 1:
            grads = [p.grad for p in opt.params]
            flat = collectives.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
            for g, summed in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(summed.view_as(g))
            loss = collectives.all_reduce(loss, group) / world
        opt.step()
        return loss

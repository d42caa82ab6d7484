"""Plain reference of the InVesalius 3D U-Net (invesalius/segmentation/
deep_learning/model.py ``Unet3D``) in float32, with its patch-grid
segmentation and its training step.

- The network: four encoder blocks of (5^3 convolution, batch norm, ReLU)
  twice with max-pooling by 2 between them, a bottleneck block, four
  decoders each a k=4 s=2 p=1 transposed convolution, a concatenation
  with the skip and a block, a 1x1 head and a sigmoid.  Weights come as a
  state dict under the checkpoint's names.
- Batch norm: eval mode with the running statistics; train mode with the
  batch's (the mean and the variance E[x^2] - E[x]^2 over every axis but
  the channel, as Flax's BatchNorm computes them).
- Segmentation: the volume rescaled to [0, 1], 48^3 patches at 50% overlap
  (the last patch of an axis ends at its border), each patch's
  probabilities written over the earlier ones in grid order, the mask
  the probability's threshold at 0.5.
- Training: the mean binary cross-entropy -mean(y log(p + 1e-6) + (1 - y)
  log(1 - p + 1e-6)), its gradient, and optax's Adam (lr 1e-3, b1 0.9,
  b2 0.999, eps 1e-8).

Every convolution runs in float32 with TF32 off.  ``quant="fp8"`` rounds
each 5^3 and transposed convolution's input and kernel to float8 e4m3
with a per-tensor scale (the control: the step of precision below the
configuration's bf16).  Imports torch only.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

EPS_BN = 1e-5
F8_MAX = 448.0


@contextlib.contextmanager
def full_fp32():
    """float32 convolutions and products without TF32 inside the block."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()  # rounding forward, identity backward


def _conv(x, w, b, quant, transposed=False):
    if quant == "fp8":
        x, w = fp8(x), fp8(w)
    if transposed:
        return F.conv_transpose3d(x, w, b, stride=2, padding=1)
    return F.conv3d(x, w, b, padding=w.shape[-1] // 2)


def _norm(x, p: Dict[str, torch.Tensor], name: str, train: bool):
    if train:
        dims = [0, 2, 3, 4]
        mean = x.mean(dims)
        var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    shape = (1, -1, 1, 1, 1)
    scale = torch.rsqrt(var + EPS_BN) * p[f"{name}.weight"]
    return (x - mean.view(shape)) * scale.view(shape) + p[f"{name}.bias"].view(shape)


def _block(x, p, prefix: str, alias: str, train: bool, quant):
    for i in (1, 2):
        c = f"{prefix}.{alias}_conv{i}"
        x = _conv(x, p[f"{c}.weight"], p[f"{c}.bias"], quant)
        x = torch.relu(_norm(x, p, f"{prefix}.{alias}_norm{i}", train))
    return x


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool = False,
            quant: Optional[str] = None) -> torch.Tensor:
    """(N, 1, D, H, W) float32 -> sigmoid probabilities (N, 1, D, H, W)."""
    skips = []
    y = x
    for i in (1, 2, 3, 4):
        y = _block(y, p, f"encoder{i}", f"enc{i}", train, quant)
        skips.append(y)
        y = F.max_pool3d(y, 2)
    y = _block(y, p, "bottleneck", "bottleneck", train, quant)
    for i in (4, 3, 2, 1):
        up = _conv(y, p[f"upconv{i}.weight"], p[f"upconv{i}.bias"], quant, transposed=True)
        y = _block(torch.cat([up, skips[i - 1]], 1), p, f"decoder{i}", "dec4", train, quant)
    return torch.sigmoid(F.conv3d(y, p["conv.weight"], p["conv.bias"]))


# segmentation ------------------------------------------------------------------

def grid_starts(size: int, p: int, overlap: float) -> List[int]:
    step = p - int(p * overlap)
    starts = [i for i in range(0, size, step) if i + p <= size] or [0]
    if starts[-1] + p < size:
        starts.append(size - p)
    return starts


def segment(image: torch.Tensor, p: Dict[str, torch.Tensor], patch: int, overlap: float,
            batch: int, threshold: float, quant: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probability float32, mask uint8 0/255) of the (Z, Y, X) ``image``."""
    img = image.to(torch.float32)
    lo, hi = img.min(), img.max()
    norm = (img - lo) / torch.where(hi == lo, torch.ones_like(hi), hi - lo)
    shape = norm.shape
    norm = F.pad(norm, [0, max(0, patch - shape[2]), 0, max(0, patch - shape[1]),
                        0, max(0, patch - shape[0])])
    grid = [(z, y, x) for z in grid_starts(norm.shape[0], patch, overlap)
            for y in grid_starts(norm.shape[1], patch, overlap)
            for x in grid_starts(norm.shape[2], patch, overlap)]
    prob = torch.zeros_like(norm)
    r = torch.arange(patch, device=norm.device)
    with torch.no_grad(), full_fp32():
        for i in range(0, len(grid), batch):
            chunk = grid[i:i + batch]
            o = torch.tensor(chunk, device=norm.device)
            z, y, x = (o[:, a, None] + r for a in range(3))
            xb = norm[z[:, :, None, None], y[:, None, :, None], x[:, None, None, :]][:, None]
            out = forward(p, xb, quant=quant)[:, 0]
            for (oz, oy, ox), pr in zip(chunk, out):
                prob[oz:oz + patch, oy:oy + patch, ox:ox + patch] = pr
    prob = prob[:shape[0], :shape[1], :shape[2]]
    return prob, ((prob >= threshold).to(torch.uint8) * 255)


# training ----------------------------------------------------------------------

B1, B2, EPS, LR = 0.9, 0.999, 1e-8, 1e-3


def bce(probs: torch.Tensor, y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return -torch.mean(y * torch.log(probs + eps) + (1 - y) * torch.log(1 - probs + eps))


def leaf_names(p: Dict[str, torch.Tensor]) -> List[str]:
    """The trained leaves: every entry but the running statistics."""
    return [k for k in p if "running_" not in k and "num_batches" not in k]


def train(state: Dict[str, torch.Tensor], batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
          quant: Optional[str] = None, mu: Optional[Dict[str, torch.Tensor]] = None,
          nu: Optional[Dict[str, torch.Tensor]] = None, count: int = 0) -> dict:
    """Adam steps from ``state`` on ``batches``: each step's loss, each
    leaf's first gradient norm, each leaf's change norm after the last.
    ``mu``, ``nu`` and ``count`` carry an optimizer state the steps start
    from (a fresh one where they are not given)."""
    leaves = leaf_names(state)
    params = {k: v.detach().to(torch.float32).clone() for k, v in state.items()}
    for k in leaves:
        params[k].requires_grad_(True)
    mu = {k: (mu[k].to(torch.float32).clone() if mu else torch.zeros_like(params[k]))
          for k in leaves}
    nu = {k: (nu[k].to(torch.float32).clone() if nu else torch.zeros_like(params[k]))
          for k in leaves}
    losses, grad_norms = [], None
    with full_fp32():
        for step, (x, y) in enumerate(batches, count + 1):
            loss = bce(forward(params, x, train=True, quant=quant), y)
            grads = torch.autograd.grad(loss, [params[k] for k in leaves])
            losses.append(float(loss.detach()))
            if grad_norms is None:
                grad_norms = {k: float(torch.linalg.vector_norm(g.double()))
                              for k, g in zip(leaves, grads)}
            bc1, bc2 = 1 - B1 ** step, 1 - B2 ** step
            with torch.no_grad():
                for k, g in zip(leaves, grads):
                    mu[k].mul_(B1).add_((1 - B1) * g)
                    nu[k].mul_(B2).add_((1 - B2) * g * g)
                    params[k].sub_(LR * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS))
    change = {k: float(torch.linalg.vector_norm((params[k].detach() - state[k].to(torch.float32))
                                                .double())) for k in leaves}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

"""The weight gradient of a 3D convolution with one input or one output
channel: the hand-written CUDA kernel and its plain version.

``conv_wgrad(x, dy, k)`` is ``dW`` of ``conv3d(x, W, stride=1,
padding=k // 2)`` for ``x`` (N, C_in, D, H, W) and the output's gradient
``dy`` (N, C_out, D, H, W), where ``min(C_in, C_out) == 1``, ``max(C_in,
C_out) <= 8`` and ``k`` is 1 or 5 (the U-Net's): ``dW[o, i, kd, kh, kw] = sum over n,
d, h, w of x[n, i, d + kd - p, h + kh - p, w + kw - p] * dy[n, o, d, h,
w]`` (x is 0 outside the volume), summed in float32 and rounded once to the
inputs' dtype (float32 or bfloat16).  It replaces no TPU kernel: in the
U-Net's training step (``models/layers.py`` routes its single-channel
convolutions here) cuDNN's direct kernel for the 1^3 head took 42% of the
step.  A CUDA tensor goes through ``csrc/conv_wgrad.cu`` (two launches: the
tiles' partial sums, then their sum in a fixed order); only a CPU tensor
takes the plain version, ``conv_wgrad_ref``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# calls that launched the CUDA kernel (its two launches count once), in
# all and by kernel side; callers reset the counts to measure one run
LAUNCHES = {"conv_wgrad": 0, "k1": 0, "k5": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GRID: Dict[Tuple[int, int, int], int] = {}  # (device, k, dtype) -> blocks
_CHANNELS = 8  # the kernel's channels: its scratch holds 8 a tap


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def takes(c_in: int, c_out: int, k: int) -> bool:
    """Whether the kernel takes a convolution of ``c_in`` to ``c_out``
    channels with a k^3 kernel (stride 1, padding k // 2)."""
    return min(c_in, c_out) == 1 and max(c_in, c_out) <= 8 and k in (1, 5)


def conv_wgrad_ref(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch ``dW``: for each tap, the float32 sum of the shifted
    input's channels against the gradient's, rounded once to ``x.dtype``."""
    p = k // 2
    d, h, w = dy.shape[2:]
    xp = F.pad(x.to(torch.float32), (p,) * 6)
    g = dy.to(torch.float32)
    out = torch.empty(dy.shape[1], x.shape[1], k, k, k, dtype=torch.float32, device=x.device)
    for kd in range(k):
        for kh in range(k):
            for kw in range(k):
                win = xp[:, :, kd:kd + d, kh:kh + h, kw:kw + w]
                out[:, :, kd, kh, kw] = torch.einsum("nidhw,nodhw->oi", win, g)
    return out.to(x.dtype)


def _check(x: torch.Tensor, dy: torch.Tensor, k: int) -> None:
    if x.dim() != 5 or dy.dim() != 5 or x.shape[0] != dy.shape[0] or x.shape[2:] != dy.shape[2:]:
        raise ValueError("x and dy must be (N, C, D, H, W) of one batch and volume, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if not takes(x.shape[1], dy.shape[1], k):
        raise ValueError(f"no kernel for {x.shape[1]} -> {dy.shape[1]} channels at k = {k}: "
                         "one side must have one channel, the other at most 8, and k be 1 or 5")
    if x.dtype != dy.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x and dy must both be float32 or bfloat16, got {x.dtype}, {dy.dtype}")
    if x.device != dy.device:
        raise ValueError(f"x and dy must be on one device, got {x.device}, {dy.device}")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")


def conv_wgrad(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """``dW`` (C_out, C_in, k, k, k) in ``x.dtype``.  CUDA tensors launch the
    kernel on the current stream and must be contiguous; CPU tensors take
    ``conv_wgrad_ref``."""
    _check(x, dy, k)
    if x.device.type == "cpu":
        return conv_wgrad_ref(x, dy, k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("the CUDA weight gradient needs contiguous (N, C, D, H, W) tensors")
    from invesalius3_tpu_torch import _build

    lib = _build.conv_wgrad_lib()
    n, c_in, d, h, w = x.shape
    c_out = dy.shape[1]
    # the side of many channels is summed against the single channel
    many, one, c = (dy, x, c_out) if c_in == 1 else (x, dy, c_in)
    code = _DTYPE_CODE[x.dtype]
    dw = torch.empty(c_out, c_in, k, k, k, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        key = (x.device.index, k, code)
        if key not in _GRID:
            grid = lib.conv_wgrad_grid(k, code)
            if grid <= 0:
                raise RuntimeError(f"conv_wgrad_grid({k}, {code}) failed: {grid}")
            _GRID[key] = grid
        grid = _GRID[key]
        partial = torch.empty(grid * _CHANNELS * k ** 3, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv_wgrad(many.data_ptr(), one.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                             n, c, d, h, w, k, int(c_in != 1), code, grid, stream)
    if err != 0:
        raise RuntimeError(f"conv_wgrad launch failed ({tuple(x.shape)} -> {c_out} channels, "
                           f"k {k}, {x.dtype}): error {err}")
    LAUNCHES["conv_wgrad"] += 1
    LAUNCHES[f"k{k}"] += 1
    return dw

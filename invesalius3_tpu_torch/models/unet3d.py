"""3D U-Net for volumetric segmentation (port of
invesalius3_tpu/models/unet3d.py).

The reference torch model (reference invesalius/segmentation/
deep_learning/model.py:9-114 ``Unet3D``): a 4-level encoder/decoder, 5x5x5
convolutions with padding 2, BatchNorm + ReLU twice a block, max-pooling
by 2, ConvTranspose3d(k=4, s=2, p=1) up-convolutions (Flax's "SAME" with
``transpose_kernel=True``), skip concatenations, a sigmoid 1x1 head,
``init_features=8``.  The parameter names are the reference's, so a
published ``state_dict`` loads with ``load_state_dict(strict=True)``:
``encoder1.enc1_conv1.weight``, ``encoder1.enc1_norm1.running_mean``, ...
and all four decoders name their inner layers ``dec4_*`` (a quirk of the
reference).

Activations are NCDHW; convolutions compute in ``dtype`` (bfloat16 in the
segmenters) with the JAX model's cast points (``models/layers.py``).  A
model starts in eval mode, as the Flax model's ``train`` flag defaults to
False; ``model.train()`` is that flag (``models/train.py`` steps it).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from invesalius3_tpu_torch.models.layers import BatchNorm, conv, fp32_convs, init_state

SIZE = 48  # reference patch size (model.py:6)


class ConvBlock(nn.Module):
    """(conv 5^3 -> BatchNorm -> ReLU) twice; layers ``{alias}_conv{i}``
    and ``{alias}_norm{i}``."""

    def __init__(self, in_channels: int, features: int, alias: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.alias = alias
        self.dtype = dtype
        for i, cin in ((1, in_channels), (2, features)):
            setattr(self, f"{alias}_conv{i}", nn.Conv3d(cin, features, 5, padding=2))
            setattr(self, f"{alias}_norm{i}", BatchNorm(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in (1, 2):
            x = conv(getattr(self, f"{self.alias}_conv{i}"), x, self.dtype)
            x = torch.relu(getattr(self, f"{self.alias}_norm{i}")(x))
        return x


class Unet3D(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 init_features: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        f = init_features
        self.dtype = dtype
        self.encoder1 = ConvBlock(in_channels, f, "enc1", dtype)
        self.encoder2 = ConvBlock(f, f * 2, "enc2", dtype)
        self.encoder3 = ConvBlock(f * 2, f * 4, "enc3", dtype)
        self.encoder4 = ConvBlock(f * 4, f * 8, "enc4", dtype)
        self.bottleneck = ConvBlock(f * 8, f * 16, "bottleneck", dtype)
        for i, feats in ((4, f * 8), (3, f * 4), (2, f * 2), (1, f)):
            setattr(self, f"upconv{i}", nn.ConvTranspose3d(feats * 2, feats, 4, 2, 1))
            setattr(self, f"decoder{i}", ConvBlock(feats * 2, feats, "dec4", dtype))
        self.conv = nn.Conv3d(f, out_channels, 1)
        self.eval()  # Flax's default, train=False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, D, H, W) float32 -> sigmoid probabilities (N, out, D, H,
        W) float32.  In train mode the batch norms normalise with the
        batch's statistics and update their running ones (the JAX model's
        ``train=True``)."""
        with fp32_convs(x.device):
            skips = []
            y = x
            for i in (1, 2, 3, 4):
                y = getattr(self, f"encoder{i}")(y)
                skips.append(y)
                y = F.max_pool3d(y, 2)
            y = self.bottleneck(y)
            for i in (4, 3, 2, 1):
                up = conv(getattr(self, f"upconv{i}"), y, self.dtype)
                skip = skips[i - 1]
                y = getattr(self, f"decoder{i}")(torch.cat([up.to(skip.dtype), skip], 1))
            return torch.sigmoid(conv(self.conv, y, torch.float32))


def init_params(generator: torch.Generator, **kw) -> Dict[str, torch.Tensor]:
    """A random state dict of ``Unet3D(**kw)`` from ``generator``."""
    return init_state(Unet3D(**kw), generator)


def load_torch_checkpoint(path) -> Dict:
    """The state dict of a reference torch checkpoint — eager ``.pt``
    state_dict (brain/trachea) or TorchScript archive (mandible, reference
    segment.py:260 torch.jit.load) — under the reference's names."""
    from invesalius3_tpu_torch.models.torch_convert import torch_state_dict

    return torch_state_dict(path)

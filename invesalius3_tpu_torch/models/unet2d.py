"""2D U-Net for slice-wise segmentation, cranioplasty implant generation
(port of invesalius3_tpu/models/unet2d.py).

The reference ships its implant model as an opaque TorchScript archive
(reference invesalius/segmentation/deep_learning/segment.py:227-264
``segment_torch_jit`` with ``cranioplasty_jit_ct_binary`` weights).  This
is the JAX package's 2D U-Net with its layer names (``enc1_conv`` /
``enc1_norm`` / ``upconv1`` / ``conv``), so a state dict under those names,
eager or read out of a TorchScript archive (models/torch_convert.py), loads
with ``load_state_dict(strict=True)``.

Activations are NCHW; convolutions compute in ``dtype`` (bfloat16 by
default) with the JAX model's cast points (``models/layers.py``).  The
model starts in eval mode (the Flax flag's default); ``train()`` is the
JAX model's ``train=True``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from invesalius3_tpu_torch.models.layers import BatchNorm, conv, fp32_convs

PATCH = 480  # reference implant patch size (segment.py:30)


class Unet2D(nn.Module):
    """3-level encoder/decoder: (conv3x3 + BN + relu) per level, maxpool 2,
    ConvTranspose k2 s2 upsampling, skip concats, 1x1 sigmoid head."""

    def __init__(self, features: int = 16, out_channels: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        f = features
        self.dtype = dtype
        for name, cin, cout in (("enc1", 1, f), ("enc2", f, f * 2), ("enc3", f * 2, f * 4),
                                ("dec2", f * 4, f * 2), ("dec1", f * 2, f)):
            setattr(self, f"{name}_conv", nn.Conv2d(cin, cout, 3, padding=1))
            setattr(self, f"{name}_norm", BatchNorm(cout))
        self.upconv2 = nn.ConvTranspose2d(f * 4, f * 2, 2, 2)
        self.upconv1 = nn.ConvTranspose2d(f * 2, f, 2, 2)
        self.conv = nn.Conv2d(f, out_channels, 1)
        self.eval()  # Flax's default, train=False

    def _block(self, x: torch.Tensor, name: str) -> torch.Tensor:
        x = conv(getattr(self, f"{name}_conv"), x, self.dtype)
        return torch.relu(getattr(self, f"{name}_norm")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, 1, H, W) float32 -> sigmoid probabilities (N, out, H, W)."""
        with fp32_convs(x.device):
            e1 = self._block(x, "enc1")
            e2 = self._block(F.max_pool2d(e1, 2), "enc2")
            e3 = self._block(F.max_pool2d(e2, 2), "enc3")
            u2 = conv(self.upconv2, e3, self.dtype)
            d2 = self._block(torch.cat([u2.to(e2.dtype), e2], 1), "dec2")
            u1 = conv(self.upconv1, d2, self.dtype)
            d1 = self._block(torch.cat([u1.to(e1.dtype), e1], 1), "dec1")
            return torch.sigmoid(conv(self.conv, d1, torch.float32))


def load_torch_checkpoint(path) -> Dict:
    """The state dict of a torch ``.pt`` / TorchScript checkpoint, wrapper
    prefixes stripped."""
    from invesalius3_tpu_torch.models.torch_convert import torch_state_dict

    return torch_state_dict(path)

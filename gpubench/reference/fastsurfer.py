"""Plain reference of FastSurferCNN (Henschel et al., "FastSurfer - a fast
and accurate deep learning based neuroimaging pipeline", NeuroImage 219
(2020) 117012; github.com/Deep-MI/FastSurfer, ``FastSurferCNN/models``) and
of the 2.5D whole-brain parcellation InVesalius runs with it
(invesalius/segmentation/deep_learning/fastsurfer_subpart), in float32.

- The network: the input block, then three encoder blocks, each a
  competitive dense block whose output (the skip) is max-pooled 2x2 with
  the index of each window's maximum kept; a bottleneck block; four
  decoder blocks, each unpooling by its encoder's indices, a maxout
  competition with that encoder's skip, and a competitive dense block; a
  1x1 classifier with a bias.  k, the blocks' convolution width, is the
  weights' own: 5 in the published network.  Pooling and unpooling are
  ``F.max_pool2d(..., return_indices=True)`` and ``F.max_unpool2d``, the
  ops the published code uses.
- A competitive dense block: three (PReLU, k x k convolution, batch norm)
  stages; the second and third stages take the maximum of the previous
  stage's norm and that stage's own input (maxout in place of dense
  connections).  The input block normalises the raw thick slices with a
  batch norm in place of the first PReLU and has no first competition.
- Batch norms in eval mode: ``(x - running_mean) * (rsqrt(running_var +
  1e-5) * weight) + bias``.
- The pipeline: the volume's intensities rescaled to [0, 255]; along each
  axis (axial 0, coronal 1, sagittal 2) every slice with its three
  neighbours on each side (edge slices repeated) as 7 channels; each
  view's network on ``batch`` slices at a time; the sagittal network's 51
  merged classes spread over the 79 by a gather; the logits summed with
  weights 0.4 / 0.4 / 0.2 (axial, coronal, sagittal, in that order) into
  one (D, H, W, 79) float32 array; its argmax mapped to FreeSurfer ids.
  The sum is built a view and a batch at a time.

Departures from the publication, each the port's:
- Three PReLU slopes a block, under the port's names ``prelu1``-
  ``prelu3`` (the input block ``prelu2``, ``prelu3``), where the published
  block applies one ``nn.PReLU()`` module, one slope, at every stage; a
  published checkpoint gives the three the same slope.
- No bias on the k x k convolutions (the published ``nn.Conv2d`` carry
  one): in eval mode a bias before a batch norm folds into its running
  mean.
- Ties: a 2x2 window with several equal maxima pools to the first in
  (row, column) order, torch's rule; the port's own argmax rule is held to
  it by tests with forced ties.
- The sagittal map is derived from the configuration's id lists: a full
  class whose id the sagittal net lacks takes its left twin (a right
  cortical id less 1000) or its right twin (a left subcortical id).
- No reorientation to LIA and no resampling: the volume comes at the
  conform size, where the conform is the intensity rescale alone; the
  views are taken along the volume's own axes.

Every convolution runs in float32 with TF32 off.  ``quant="fp8"`` rounds
each k x k convolution's input and kernel to float8 e4m3 under a per-tensor
scale (the control: the step of precision below the configuration's bf16
convolutions); the classifier stays float32, as the port computes it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .unet3d import fp8, full_fp32

EPS_BN = 1e-5
VIEWS = (("axial", 0), ("coronal", 1), ("sagittal", 2))
ENCODERS = ("enc1", "enc2", "enc3", "enc4")


def _norm(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str, fit=None) -> torch.Tensor:
    if fit is not None:
        fit(name, x)
    shape = (1, -1, 1, 1)
    scale = torch.rsqrt(p[f"{name}.running_var"] + EPS_BN) * p[f"{name}.weight"]
    return (x - p[f"{name}.running_mean"].view(shape)) * scale.view(shape) \
        + p[f"{name}.bias"].view(shape)


def _conv(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant == "fp8":
        x, w = fp8(x), fp8(w)
    return F.conv2d(x, w, padding=w.shape[-1] // 2)


def block(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
          quant: Optional[str] = None, fit=None) -> torch.Tensor:
    """One competitive dense block; ``enc1`` is the input block."""
    def stage(i: int, y: torch.Tensor) -> torch.Tensor:
        if i == 1 and name == "enc1":
            y = _norm(y, p, "enc1.bn0", fit)
        else:
            y = F.prelu(y, p[f"{name}.prelu{i}.weight"])
        return _norm(_conv(y, p[f"{name}.conv{i}.weight"], quant), p, f"{name}.bn{i}", fit)

    m1 = stage(1, x)
    if name != "enc1":
        m1 = torch.maximum(m1, x)
    m2 = torch.maximum(stage(2, m1), m1)
    return stage(3, m2)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
            quant: Optional[str] = None, fit=None) -> torch.Tensor:
    """(N, 7, H, W) float32 thick slices -> (N, classes, H, W) float32
    logits; H and W divisible by 16.  ``fit``, where given, is called with
    each norm's name and input before the norm reads its statistics (the
    weights' generator sets them from it)."""
    skips, indices = [], []
    y = x
    for name in ENCODERS:
        y = block(p, name, y, quant, fit)
        skips.append(y)
        y, idx = F.max_pool2d(y, 2, 2, return_indices=True)
        indices.append(idx)
    y = block(p, "bottleneck", y, quant, fit)
    for i in (3, 2, 1, 0):
        up = F.max_unpool2d(y, indices[i], 2, 2, output_size=skips[i].shape[-2:])
        y = block(p, f"dec{i + 1}", torch.maximum(up, skips[i]), quant, fit)
    return F.conv2d(y, p["classifier.weight"], p["classifier.bias"])


# the 2.5D pipeline ---------------------------------------------------------------

def sagittal_map(class_ids: Sequence[int], sagittal_ids: Sequence[int],
                 left_right: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """int64 (len(class_ids),): for each full class, the index of the
    sagittal class whose logit it takes: the same id, else the left twin of
    a right cortical id (id - 1000), else the right twin of a left
    subcortical id."""
    at = {int(s): j for j, s in enumerate(sagittal_ids)}
    right = {int(a): int(b) for a, b in left_right}
    out = []
    for c in class_ids:
        c = int(c)
        out.append(at[c] if c in at else at[c - 1000] if c - 1000 in at else at[right[c]])
    return torch.tensor(out, dtype=torch.int64)


def conform(volume: torch.Tensor) -> torch.Tensor:
    """The intensities rescaled linearly onto [0, 255] in float32."""
    v = volume.to(torch.float32)
    lo, hi = v.min(), v.max()
    return (v - lo) / torch.where(hi == lo, torch.ones_like(hi), hi - lo) * 255.0


def thick_slices(volume: torch.Tensor, axis: int, start: int, count: int,
                 thick: int = 7) -> torch.Tensor:
    """(count, thick, H, W): slices ``start``.. along ``axis``, each with its
    ``thick // 2`` neighbours on either side, the edge slices repeated."""
    v = volume.movedim(axis, 0)
    h = thick // 2
    at = torch.arange(start, start + count)[:, None] + torch.arange(-h, h + 1)[None]
    return v[at.clamp(0, v.shape[0] - 1).to(v.device)]


def parcellate(volume: torch.Tensor, states: Dict[str, Dict[str, torch.Tensor]], cfg: dict,
               batch: int, quant: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the weighted logit sum (D, H, W, classes) float32, the labels as
    FreeSurfer ids int32) of the (D, H, W) ``volume`` at the conform size,
    on its device; ``states`` maps each view to its network's weights (on
    the volume's device), ``cfg`` is the configuration (``class_ids``,
    ``sagittal_ids``, ``left_right``, ``view_weights``, ``thick``)."""
    if tuple(volume.shape) != (int(cfg["conform"]),) * 3:
        raise ValueError(f"the reference takes a volume at the conform size, not {volume.shape}")
    dev = volume.device
    ids = torch.tensor(cfg["class_ids"], dtype=torch.int32, device=dev)
    to_full = sagittal_map(cfg["class_ids"], cfg["sagittal_ids"], cfg["left_right"]).to(dev)
    with torch.no_grad(), full_fp32():
        vol = conform(volume)
        agg = torch.zeros(vol.shape + (len(ids),), dtype=torch.float32, device=dev)
        for view, axis in VIEWS:
            weight = torch.tensor(cfg["view_weights"][view], dtype=torch.float32, device=dev)
            n = vol.shape[axis]
            for i in range(0, n, batch):
                b = min(batch, n - i)
                x = thick_slices(vol, axis, i, b, int(cfg["thick"]))
                out = forward(states[view], x, quant)
                if view == "sagittal":
                    out = out.index_select(1, to_full)
                agg.narrow(axis, i, b).add_((out.permute(0, 2, 3, 1) * weight).movedim(0, axis))
        labels = ids[agg.argmax(-1)]
    return agg, labels

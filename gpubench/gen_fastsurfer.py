"""FastSurferCNN's weights from the seed: each view's network at the
configuration's widths, under the port's names (``<block>.conv{i}``,
``<block>.bn{i}``, ``<block>.prelu{i}``, ``classifier``), drawn on the
device, its norms' running statistics fitted to what they see on the
cell's own volume, as a trained network's follow its data, and handed over
on the host, as a checkpoint loader leaves them.  Nothing here imports the
program.

Why fitted: with statistics near the identity nothing centres the
activations, whose offsets grow to hundreds of times their spread through
the 27 convolutions; bf16's relative rounding of such values then flips
2x2 pooling indices and competitions everywhere.  On 4 axial slices of
128^2 through one view on the CPU, the bf16 network's labels left the
float32 network's on 37% of the voxels, and on 23% of those whose top two
logits differ by 0.3 standard deviations; fitted, on 16% and 1.5%.  A
trained network's norms centre its activations."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from gpubench import gen
from gpubench.reference import fastsurfer as ref
from gpubench.reference.unet3d import full_fp32

BLOCKS = ("enc1", "enc2", "enc3", "enc4", "bottleneck", "dec4", "dec3", "dec2", "dec1")
VIEW_STREAMS = {"axial": 4, "coronal": 5, "sagittal": 6}
FIT_SLICES = 16  # slices along the view's axis, evenly spaced, that the norms are fitted on


def shapes(cfg: dict, classes: int) -> Dict[str, Tuple[int, ...]]:
    """Parameter and running-statistic shapes of one view's network."""
    f, k, thick = int(cfg["filters"]), int(cfg["kernel"]), int(cfg["thick"])
    out: Dict[str, Tuple[int, ...]] = {}

    def norm(name: str, c: int) -> None:
        for s in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{s}"] = (c,)

    for b in BLOCKS:
        if b == "enc1":
            norm("enc1.bn0", thick)
        for i in (1, 2, 3):
            if i > 1 or b != "enc1":
                out[f"{b}.prelu{i}.weight"] = (1,)
            out[f"{b}.conv{i}.weight"] = (f, thick if (b, i) == ("enc1", 1) else f, k, k)
            norm(f"{b}.bn{i}", f)
    out["classifier.weight"] = (classes, f, 1, 1)
    out["classifier.bias"] = (classes,)
    return out


def view_state(cfg: dict, classes: int, seed: int, stream: int, volume: torch.Tensor,
               axis: int) -> Dict[str, torch.Tensor]:
    """One view's float32 weights on the host, drawn on the volume's device
    in three draws: kernels He-normal (variance 2 / fan_in); norm offsets and
    the classifier's bias normal at ``bias_sd``; from one uniform draw, PReLU
    slopes in ``init["prelu"]`` and each norm's spread around what it sees
    (scale and variance factor in [1 - s, 1 + s], mean offset in [-s, s]
    standard deviations, s = ``stat_spread``).  Then one float32 pass over
    ``FIT_SLICES`` thick slices of ``volume`` along ``axis`` sets each norm's
    running mean to its input's mean plus the offset and its running
    variance to its input's variance times the factor, norm by norm."""
    device = volume.device
    shp = shapes(cfg, classes)
    init = cfg["init"]
    g = gen.generator(seed, device, stream)
    kernels = [n for n, s in shp.items() if len(s) > 1]
    vectors = [n for n, s in shp.items() if len(s) == 1]
    normal = torch.randn(sum(math.prod(shp[n]) for n in kernels), generator=g, device=device)
    small = torch.randn(sum(shp[n][0] for n in vectors), generator=g, device=device)
    unif = torch.rand(sum(shp[n][0] for n in vectors), generator=g, device=device)
    state, at = {}, 0
    for n in kernels:
        size = math.prod(shp[n])
        state[n] = normal[at:at + size].view(shp[n]) * math.sqrt(2.0 / math.prod(shp[n][1:]))
        at += size
    s, (lo, hi) = init["stat_spread"], init["prelu"]
    at = 0
    for n in vectors:
        c = shp[n][0]
        u = unif[at:at + c]
        if n.endswith((".running_var", ".weight")) and ".bn" in n:
            state[n] = 1.0 + s * (2 * u - 1)
        elif n.endswith(".running_mean"):
            state[n] = s * (2 * u - 1)
        elif ".prelu" in n:
            state[n] = lo + (hi - lo) * u
        else:
            state[n] = init["bias_sd"] * small[at:at + c]
        at += c

    def fit(name: str, x: torch.Tensor) -> None:
        var = x.var((0, 2, 3), unbiased=False)
        state[f"{name}.running_mean"] = x.mean((0, 2, 3)) + state[f"{name}.running_mean"] * var.sqrt()
        state[f"{name}.running_var"] = var * state[f"{name}.running_var"]

    n = volume.shape[axis]
    at = torch.linspace(0, n - 1, min(FIT_SLICES, n)).round().long()
    conformed = ref.conform(volume)
    x = torch.cat([ref.thick_slices(conformed, axis, int(i), 1, int(cfg["thick"])) for i in at])
    with torch.no_grad(), full_fp32():
        ref.forward(state, x, fit=fit)
    return {n: v.contiguous().cpu() for n, v in state.items()}


def state(cfg: dict, seed: int, volume: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
    """{view: weights} fitted on ``volume`` (at the conform size, on the
    device to draw on): the axial and coronal networks over ``classes``, the
    sagittal over ``sagittal_classes``, each from its own stream."""
    axes = cfg["view_axes"]
    return {view: view_state(cfg, int(cfg["sagittal_classes"] if view == "sagittal"
                                      else cfg["classes"]), seed, stream, volume, axes[view])
            for view, stream in VIEW_STREAMS.items()}

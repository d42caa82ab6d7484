"""The general generator: every input a cell runs on, made on the device
from ``--seed`` with a ``torch.Generator`` of that device, in a few large
calls.  A configuration's file names the phantom and its sizes; a traffic
file names the action and its parameters.  Nothing here imports the
program: the same tensors go to the program and to the plain reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def generator(seed: int, device: torch.device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and a stream number,
    so that each kind of input draws from its own sequence.  Any whole
    number is a seed: it is folded into the 63 bits a generator takes."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63 - 1))
    return g


def _centred(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device) - n / 2.0


def head_ct(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    """An int16 head CT of side ``cfg["n"]``: air, soft tissue in a sphere
    of radius ``soft_r`` (a share of the side), a skull shell from
    ``shell_r``, an inner bone island inside ``island_r``, and uniform
    integer noise in [-noise, noise) drawn from ``seed``."""
    n = int(cfg["n"])
    hu = cfg["hu"]
    c = _centred(n, device)
    r = torch.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    ct = torch.full((n, n, n), hu["air"], dtype=torch.int16, device=device)
    ct[r < cfg["soft_r"] * n] = hu["soft"]
    ct[(r >= cfg["shell_r"] * n) & (r < cfg["soft_r"] * n)] = hu["shell"]
    ct[r < cfg["island_r"] * n] = hu["island"]
    del r
    noise = int(cfg["noise"])
    ct += torch.randint(-noise, noise, (n, n, n), generator=generator(seed, device, 1),
                        device=device, dtype=torch.int16)
    return ct


def markers(cfg: dict, device: torch.device) -> torch.Tensor:
    """int16 watershed seeds at the shares of the side that ``cfg["markers"]``
    lists as (label, z, y, x)."""
    n = int(cfg["n"])
    m = torch.zeros((n, n, n), dtype=torch.int16, device=device)
    for label, *pos in cfg["markers"]:
        m[tuple(min(n - 1, int(p * n)) if isinstance(p, float) else int(p) for p in pos)] = label
    return m


def t1_head(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    """An int16 T1 MRI of side ``cfg["n"]``: a bright ellipsoidal brain with
    darker ventricles inside a dim skull, Gaussian noise drawn from
    ``seed``."""
    n = int(cfg["n"])
    c = _centred(n, device) / (n / 2.0)
    zz, yy, xx = c[:, None, None], c[None, :, None], c[None, None, :]
    r = torch.sqrt(zz ** 2 + (yy / 0.85) ** 2 + (xx / 0.75) ** 2)
    vol = torch.where(r < 0.9, 300.0, 20.0) + torch.where(r < 0.75, 500.0, 0.0)
    vol = vol - torch.where((xx.abs() < 0.12) & (yy.abs() < 0.3) & (zz.abs() < 0.2), 450.0, 0.0)
    vol += cfg["noise_sd"] * torch.randn((n, n, n), generator=generator(seed, device, 2),
                                         device=device)
    return vol.to(torch.int16)


def threshold_mask(ct: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """uint8 0/255: the voxels in [lo, hi]."""
    return ((ct >= lo) & (ct <= hi)).to(torch.uint8) * 255


def window_255(ct: torch.Tensor, ww: float, wl: float) -> torch.Tensor:
    """The window/level ramp onto [0, 255] in float32 (a viewer's LUT)."""
    d = ct.to(torch.float32)
    lo = wl - 0.5 - (ww - 1.0) / 2.0
    hi = wl - 0.5 + (ww - 1.0) / 2.0
    ramp = ((d - (wl - 0.5)) / (ww - 1.0) + 0.5) * 255.0
    return torch.where(d <= lo, 0.0, torch.where(d > hi, 255.0, ramp))


def rescale01(v: torch.Tensor) -> torch.Tensor:
    """Linear rescale of the whole volume onto [0, 1]."""
    lo, hi = v.min(), v.max()
    return (v - lo) / torch.where(hi == lo, torch.ones_like(hi), hi - lo)


def patch_origins(g: torch.Generator, shape: Tuple[int, int, int], p: int, count: int
                  ) -> torch.Tensor:
    """(count, 3) int64 origins of p^3 patches inside ``shape``, uniform,
    drawn on the generator's device."""
    hi = torch.tensor([s - p + 1 for s in shape], device=g.device)
    return (torch.rand((count, 3), generator=g, device=g.device) * hi).long()


def gather(volume: torch.Tensor, origins: torch.Tensor, p: int) -> torch.Tensor:
    """(N, 1, p, p, p) patches of ``volume`` at ``origins`` in one indexed read."""
    r = torch.arange(p, device=volume.device)
    z, y, x = (origins[:, a, None] + r for a in range(3))
    return volume[z[:, :, None, None], y[:, None, :, None], x[:, None, None, :]][:, None]


# the U-Net's weights ---------------------------------------------------------

def unet3d_shapes(f: int = 8, cin: int = 1, cout: int = 1) -> Dict[str, Tuple[int, ...]]:
    """Parameter and running-statistic shapes of the published 3D U-Net
    (init_features ``f``), under the names of its torch checkpoint."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def block(prefix: str, alias: str, ci: int, c: int) -> None:
        for i, k in ((1, ci), (2, c)):
            shapes[f"{prefix}.{alias}_conv{i}.weight"] = (c, k, 5, 5, 5)
            shapes[f"{prefix}.{alias}_conv{i}.bias"] = (c,)
            for s in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{prefix}.{alias}_norm{i}.{s}"] = (c,)

    ci = cin
    for i, c in enumerate((f, 2 * f, 4 * f, 8 * f), 1):
        block(f"encoder{i}", f"enc{i}", ci, c)
        ci = c
    block("bottleneck", "bottleneck", 8 * f, 16 * f)
    for i, c in ((4, 8 * f), (3, 4 * f), (2, 2 * f), (1, f)):
        shapes[f"upconv{i}.weight"] = (2 * c, c, 4, 4, 4)
        shapes[f"upconv{i}.bias"] = (c,)
        block(f"decoder{i}", "dec4", 2 * c, c)
    shapes["conv.weight"] = (cout, f, 1, 1, 1)
    shapes["conv.bias"] = (cout,)
    return shapes


def _fan_in(name: str, shape: Tuple[int, ...]) -> int:
    if name.startswith("upconv"):  # (in, out, k, k, k): each output sums in x k^3 taps
        return shape[0] * math.prod(shape[2:])
    return math.prod(shape[1:])


def unet3d_state(cfg: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Float32 weights of the U-Net on ``device`` from ``seed``, in three
    draws: every kernel He-normal (variance 2 / fan_in), every bias and
    norm offset normal at ``cfg["init"]["bias_sd"]``, every norm scale and
    running statistic from one uniform draw (scale and variance in
    [1 - s, 1 + s], mean in [-s, s] with s = ``stat_spread``)."""
    shapes = unet3d_shapes(int(cfg["init_features"]), int(cfg["in_channels"]),
                           int(cfg["out_channels"]))
    g = generator(seed, device, 3)
    kernels = [k for k, s in shapes.items() if len(s) > 1]
    vectors = [k for k, s in shapes.items() if len(s) == 1]
    normal = torch.randn(sum(math.prod(shapes[k]) for k in kernels), generator=g, device=device)
    small = torch.randn(sum(shapes[k][0] for k in vectors), generator=g, device=device)
    unif = torch.rand(sum(shapes[k][0] for k in vectors), generator=g, device=device) * 2 - 1
    state, at = {}, 0
    for k in kernels:
        size = math.prod(shapes[k])
        state[k] = normal[at:at + size].view(shapes[k]) * math.sqrt(2.0 / _fan_in(k, shapes[k]))
        at += size
    init, at = cfg["init"], 0
    s = init["stat_spread"]
    for k in vectors:
        c = shapes[k][0]
        if k.endswith((".running_var", "norm1.weight", "norm2.weight")):
            state[k] = 1.0 + s * unif[at:at + c]
        elif k.endswith(".running_mean"):
            state[k] = s * unif[at:at + c]
        else:
            state[k] = init["bias_sd"] * small[at:at + c]
        at += c
    return {k: v.contiguous() for k, v in state.items()}


def cycle_item(seed: int, k: int, i: int) -> int:
    """The item the i-th action takes from a fixed set of ``k``: the actions
    run through the set in cycles, each cycle in an order drawn from
    ``seed``, so every seed does the same work in another order."""
    g = torch.Generator().manual_seed((int(seed) * 7_919 + i // k) % (2**63 - 1))
    return int(torch.randperm(k, generator=g)[i % k])


def pick(seed: int, items: List[int], count: int) -> List[int]:
    """``count`` distinct entries of ``items`` drawn from ``seed`` on the
    host, in the order drawn."""
    g = torch.Generator().manual_seed((int(seed) * 104_729 + 17) % (2**63 - 1))
    return [items[j] for j in torch.randperm(len(items), generator=g)[:count].tolist()]


def keep_indices(seed: int, count: int, horizon: int) -> List[int]:
    """``count`` distinct action numbers in [0, horizon) drawn from
    ``seed`` on the host: the actions whose answers are kept and judged."""
    g = torch.Generator().manual_seed(int(seed) % (2**63 - 1))
    return sorted(torch.randperm(horizon, generator=g)[:count].tolist())

"""The yardstick's arithmetic: operations and bytes from shapes, and the
peaks of the card they are held against.  These count the work an action
needs, whatever the program does to get it done."""

from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA H100 SXM, dense, at its full 700 W (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def unet3d_flops(p: int, f: int = 8) -> int:
    """Operations (2 a multiply-add) of one p^3 patch through the 3D U-Net
    with ``f`` initial features: the 5^3 convolutions of the nine blocks,
    the k=4 s=2 up-convolutions (4^3 multiply-adds an input voxel and
    channel pair) and the 1x1 head."""
    n, ops, cin = p ** 3, 0, 1
    for c in (f, 2 * f, 4 * f, 8 * f):
        ops += 2 * 125 * n * (cin * c + c * c)
        cin, n = c, n // 8
    ops += 2 * 125 * n * (cin * 16 * f + (16 * f) ** 2)
    cin = 16 * f
    for c in (8 * f, 4 * f, 2 * f, f):
        ops += 2 * 64 * n * cin * c
        n *= 8
        ops += 2 * 125 * n * (2 * c * c + c * c)
        cin = c
    return ops + 2 * n * f


def train_step_flops(p: int, batch: int, f: int = 8) -> int:
    """A training step: the forward and, at twice its cost, the backward,
    over ``batch`` patches of p^3."""
    return 3 * unet3d_flops(p, f) * batch


def sweep_bytes(shape: Tuple[int, int, int], label_bytes: int) -> int:
    """The least bytes one bidirectional watershed sweep over ``shape``
    moves: the packed int32 rank and the labels read and written once, the
    int32 cost image read once."""
    z, y, x = shape
    return z * y * x * (4 + 4 + 2 * label_bytes + 4)


def refine_sweep_bytes(levels: Iterable[Tuple[Tuple[int, int, int], int]],
                       label_bytes: int) -> int:
    """Bytes of the sweeps of a multigrid watershed's refine loops: three
    sweeps (one an axis) a round at each level's shape."""
    return sum(3 * rounds * sweep_bytes(shape, label_bytes) for shape, rounds in levels)

"""FastSurferCNN's operations from its shapes: what one whole-brain
parcellation needs, whatever the program does to get it done (the
convolutions alone; norms, PReLU, competitions and pooling are left out, as
``counts.unet3d_flops`` leaves out the U-Net's)."""

from __future__ import annotations


def slice_flops(h: int, w: int, classes: int, f: int = 64, k: int = 3, thick: int = 7) -> int:
    """Operations (2 a multiply-add) of one h x w thick slice through one
    network: three k x k convolutions in each of the nine blocks, the first
    block's first from ``thick`` channels, the blocks at h x w (enc1, dec1),
    a quarter of it (enc2, dec2), a sixteenth (enc3, dec3), a 64th (enc4,
    dec4) and a 256th (the bottleneck); then the 1x1 classifier."""
    n, taps = h * w, k * k
    ops = 2 * taps * n * (thick * f + 2 * f * f)  # enc1
    ops += 2 * taps * n * 3 * f * f  # dec1
    for lv in (1, 2, 3):  # enc2-4 and dec2-4
        ops += 2 * 2 * taps * (n >> (2 * lv)) * 3 * f * f
    ops += 2 * taps * (n >> 8) * 3 * f * f  # the bottleneck
    return ops + 2 * n * f * classes


def parcellate_flops(cfg: dict) -> int:
    """Operations of one parcellation at the conform size: every slice of
    each axis through its view's network (the sagittal one with its
    merged classes)."""
    n, f, k, thick = (int(cfg[key]) for key in ("conform", "filters", "kernel", "thick"))
    return n * sum(slice_flops(n, n, int(cfg[c]), f, k, thick)
                   for c in ("classes", "classes", "sagittal_classes"))

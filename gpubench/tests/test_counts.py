"""The yardstick's counts, pinned to the figures the program's own notes
give: 14.86 TFLOP for the brain grid at 256^3, 2.853 TFLOP a training step,
0.801 ms for a 512^3 sweep at 3.35 TB/s."""

import pytest

from gpubench import counts
from gpubench.reference.unet3d import grid_starts


def test_brain_grid_flops():
    patches = len(grid_starts(256, 48, 0.5)) ** 3
    assert patches == 1000
    assert counts.unet3d_flops(48) * patches / 1e12 == pytest.approx(14.86, abs=5e-3)


def test_training_step_flops():
    assert counts.train_step_flops(96, 8) / 1e12 == pytest.approx(2.853, abs=5e-4)


def test_sweep_bytes():
    seconds = counts.sweep_bytes((512, 512, 512), 4) / counts.PEAK_HBM_BYTES_S
    assert seconds * 1e3 == pytest.approx(0.801, abs=5e-4)
    # three sweeps a round at each level's shape, int16 labels
    levels = [((128,) * 3, 10), ((512,) * 3, 4)]
    assert counts.refine_sweep_bytes(levels, 2) == 3 * (10 * 128**3 + 4 * 512**3) * 16

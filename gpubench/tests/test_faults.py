"""A whole run at a tiny size on the CPU, the card's look skipped, with the
timed path broken underneath: ``correct`` comes out false, once for each
fault the cell can have.  The same runs unbroken come out correct."""

import pytest

from gpubench import faults
from gpubench.tests.tiny import run_tiny

SEED = 2**32 + 3

CASES = [("head_ct512.watershed", "altered_labels", None),
         ("unet3d_f8.brain_segment", "altered_probability", None),
         ("unet3d_f8.train96", "half_batch", "float32"),
         ("unet3d_f8.train96", "unchanged", "float32")]


@pytest.mark.parametrize("workload, fault, conv_dtype", CASES)
def test_fault_is_not_correct(workload, fault, conv_dtype):
    with faults.planted(fault):
        result = run_tiny(workload, SEED, conv_dtype=conv_dtype)
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("workload, conv_dtype", sorted({(w, d) for w, _, d in CASES}))
def test_sound_run_is_correct(workload, conv_dtype):
    result = run_tiny(workload, SEED, conv_dtype=conv_dtype)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0

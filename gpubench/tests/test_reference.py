"""The plain references against the program at tiny sizes on the CPU:
where both compute in float32 they agree to rounding, and the program's
bf16 U-Net stays within the cell's limit."""

import pytest

from gpubench.tests.tiny import action, small_volumes

SEED = 2**31 + 77  # more than 32 signed bits hold


def readings(workload, conv_dtype=None):
    with small_volumes():
        a = action(workload, SEED, conv_dtype)
        answer = a.first_answer()
        a.release()
        return {c["name"]: c["value"] for c in a.judge([answer], a.reference())}


def test_watershed_labels_equal():
    assert readings("head_ct512.watershed") == {"labels_differing": 0}


@pytest.mark.parametrize("conv_dtype, logit_gap", [("float32", 1e-3), ("bfloat16", 0.25)])
def test_segmentation_close(conv_dtype, logit_gap):
    assert readings("unet3d_f8.brain_segment", conv_dtype)["logit_gap"] < logit_gap


def test_training_float32_close():
    # a float32 program follows the float32 reference to rounding; Adam's
    # first steps are about lr sign(g), so small gradients' changes move most
    r = readings("unet3d_f8.train96", "float32")
    assert r["grad_norm_gap_median"] < 1e-3 and r["window_grad_gap_median"] < 1e-3
    assert r["change_norm_gap"] < 0.1 and r["window_change_gap"] < 0.1

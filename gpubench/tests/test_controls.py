"""Each cell's control comes out as not correct at a size a test holds:
the reference with one guarantee broken (the watershed stopped short of
its fixpoint) or one step of precision lower (fp8 convolutions), judged
by the cell's own numbers and limits."""

import pytest

from gpubench.tests.tiny import action, small_volumes


@pytest.mark.parametrize("workload, conv_dtype", [
    ("head_ct512.watershed", None), ("unet3d_f8.brain_segment", None),
    ("unet3d_f8.train96", "float32")])
@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_control_fails(workload, conv_dtype, seed):
    with small_volumes():
        a = action(workload, seed, conv_dtype)
        a.make_inputs()
        checks = a.judge([a.control()], a.reference())
    assert any(c["value"] > c["limit"] for c in checks), checks

"""The whole action's share of the card's dense bf16 peak: the U-Net
operations one action needs (``counts.unet3d_flops`` over the patch grid,
or three passes over the batch for a training step) over the action's
mean wall time in the window (the profiled actions left out)."""

from gpubench import counts


def read(ctx):
    flops = getattr(ctx["action"], "flops_per_action", None)
    times = ctx["action_times"]
    if not flops or not times:
        return None
    return 100.0 * flops / (sum(times) / len(times)) / counts.PEAK_BF16_FLOPS

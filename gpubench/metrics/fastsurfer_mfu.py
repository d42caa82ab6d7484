"""The whole parcellation's share of the card's dense bf16 peak: the
FastSurferCNN operations one action needs (``counts_fastsurfer``: every
slice of each axis through its view's network) over the action's mean wall
time in the window, read as ``unet_mfu`` reads the U-Net's."""

from gpubench import run

read = run.metric_reader("unet_mfu")

"""Deep-learning segmentation (port of invesalius3_tpu/models/): the 3D and
2D U-Nets, FastSurferCNN, the patch-grid segmenters, the checkpoint
readers and the training step (``train``).  Plain PyTorch modules; the
convolutions are the library's."""

"""The benchmark of invesalius3_tpu_torch on one NVIDIA H100 (see run.py)."""

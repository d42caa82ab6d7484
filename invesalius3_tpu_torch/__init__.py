"""invesalius3_tpu_torch: the PyTorch / CUDA port of invesalius3_tpu.

It mirrors the JAX package's module paths (``ops.watershed``,
``ops.marching``, ``ops.mesh``, ``io.mesh_io`` ...), so each module's
counterpart is easy to find; the JAX package stays the reference, and the
tests hold each module against it.  The hand-written CUDA kernels live in
``csrc/`` and are built at first use by ``_build`` (never on import).
``pipeline`` runs the headline segmentation-to-STL flow.

This package imports torch and numpy only: never jax, never invesalius3_tpu.
"""

__version__ = "0.1.0"

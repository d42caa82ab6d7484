"""The port's whole segmentation-to-STL flow against the JAX package's
(bench.py ``pipeline()``, single device) on a small ``make_ct`` phantom:
the same triangles in the same order, corners within one float16 ulp."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from invesalius3_tpu.io import mesh_io as mesh_io_jax
from invesalius3_tpu.ops import marching as marching_jax
from invesalius3_tpu.ops import mesh as mesh_jax
from invesalius3_tpu.ops import watershed as ws_jax
from invesalius3_tpu_torch import pipeline

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STL_RECORD = np.dtype([("normal", "<f4", 3), ("corners", "<f4", (3, 3)),
                       ("attr", "<u2")])


def _jax_flow(ct, markers, path):
    labels = ws_jax.watershed(jnp.asarray(ct), jnp.asarray(markers),
                              algorithm="Watershed")
    mask = jnp.where(labels == 1, jnp.uint8(255), jnp.uint8(0))
    dm = marching_jax.mask_to_surface_device(mask, spacing=pipeline.SPACING)
    out3v = mesh_jax.ca_smoothing_device(dm, **pipeline.CA_PARAMS)
    mesh_io_jax.write_stl_from_device(path, dataclasses.replace(dm, verts3v=out3v))
    return dm.n_tris


def _records(path):
    data = path.read_bytes()
    n = int(np.frombuffer(data, "<u4", 1, 80)[0])
    assert len(data) == 84 + 50 * n
    return data[:84], np.frombuffer(data, STL_RECORD, n, 84)


def test_slice_matches_jax_flow(tmp_path):
    n = 36
    ct, markers = pipeline.make_ct(n), pipeline.bench_markers(n)
    want_tris = _jax_flow(ct, markers, tmp_path / "jax.stl")
    res = pipeline.run(ct, markers, tmp_path / "port.stl", device="cpu")
    assert res.mesh.n_tris == want_tris > 500
    assert set(res.times) == {"h2d", "watershed", "marching", "smoothing", "stl"}
    head_w, rec_w = _records(tmp_path / "jax.stl")
    head_g, rec_g = _records(tmp_path / "port.stl")
    assert head_g == head_w
    a = rec_g["corners"].astype(np.float32)
    b = rec_w["corners"].astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
    assert (np.abs(a - b) <= ulp.astype(np.float32)).all()
    assert (rec_g["attr"] == 0).all()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import invesalius3_tpu_torch, invesalius3_tpu_torch._build\n"
        "import invesalius3_tpu_torch.convert, invesalius3_tpu_torch.pipeline\n"
        "from invesalius3_tpu_torch.ops import (kernels, marching, mesh,\n"
        "    morphology, watershed, windowing, casting, threshold,\n"
        "    projection_kernels, projections)\n"
        "from invesalius3_tpu_torch.io import mesh_io\n"
        "from invesalius3_tpu_torch import constants, events\n"
        "from invesalius3_tpu_torch.core import (canvas, geometry, mask,\n"
        "    slice, volume)\n"
        "from invesalius3_tpu_torch.utils import helpers\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'invesalius3_tpu' or m.startswith('invesalius3_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

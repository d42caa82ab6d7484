"""The headline flow on one device: CT -> watershed on the morphological
gradient -> mask -> marching tetrahedra -> context-aware smoothing ->
binary STL (port of bench.py ``make_ct``, the bench markers and
``pipeline()``, single device).

    from invesalius3_tpu_torch import pipeline
    ct = pipeline.make_ct(512)
    res = pipeline.run(ct, pipeline.bench_markers(512), "out.stl")  # on the card
    print(res.mesh.n_verts, res.mesh.n_tris, res.times)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from invesalius3_tpu_torch.convert import to_device
from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.io import mesh_io
from invesalius3_tpu_torch.ops import marching, mesh, watershed

SPACING = (0.5, 0.5, 0.5)
CA_PARAMS = {"t": 0.7, "tmax": 3.0, "bmin": 0.5, "n_iters": 10}


def make_ct(n: int) -> np.ndarray:
    """Synthetic cranium-like int16 CT: skull shell, soft tissue, an inner
    bone island and noise, from seed 0 (the same volume as bench.py's)."""
    c = n / 2.0
    yy = (np.arange(n, dtype=np.float32) - c) ** 2
    r2p = yy[:, None] + yy[None, :]
    ct = np.empty((n, n, n), np.int16)
    rng = np.random.default_rng(0)
    sl = np.empty((n, n), np.int16)
    for z in range(n):
        r = np.sqrt((z - c) ** 2 + r2p)
        sl[:] = -1000
        sl[r < 0.42 * n] = 40
        sl[(r >= 0.36 * n) & (r < 0.42 * n)] = 1200
        sl[r < 0.08 * n] = 900
        sl += rng.integers(-20, 20, (n, n), dtype=np.int16)
        ct[z] = sl
    return ct


def bench_markers(n: int) -> np.ndarray:
    """int16 seeds: 1 in the skull shell, 2 in the inner island, 3 in the
    background (bench.py)."""
    markers = np.zeros((n, n, n), np.int16)
    c = n // 2
    markers[c, c, int(0.61 * n)] = 1
    markers[c, c, c] = 2
    markers[2, 2, 2] = 3
    return markers


@dataclasses.dataclass
class Result:
    labels: torch.Tensor        # watershed labels, int16
    mesh: marching.DeviceMesh   # smoothed mesh as written to the STL
    times: Dict[str, float]     # seconds per stage


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ct: np.ndarray, markers: np.ndarray, out_path, device=DEFAULT_DEVICE,
        sweep: Optional[watershed.Sweep] = None,
        rounds: Optional[list] = None) -> Result:
    """Run the flow once on ``device`` (the card unless "cpu" is passed) and
    write ``out_path``.  Each stage ends with a device synchronise, so the
    stage times are the device's.  ``sweep`` and ``rounds`` pass to
    ``watershed.watershed``."""
    device = resolve_device(device)
    times: Dict[str, float] = {}
    t0 = time.perf_counter()
    ct_d = to_device(ct, device)
    markers_d = to_device(markers, device)
    _sync(device)
    times["h2d"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    labels = watershed.watershed(ct_d, markers_d, algorithm="Watershed",
                                 sweep=sweep, rounds=rounds)
    _sync(device)
    times["watershed"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mask = torch.where(labels == 1, 255, 0).to(torch.uint8)
    dm = marching.mask_to_surface_device(mask, spacing=SPACING)
    _sync(device)
    times["marching"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out3v = mesh.ca_smoothing_device(dm, **CA_PARAMS)
    _sync(device)
    times["smoothing"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dm = dataclasses.replace(dm, verts3v=out3v)
    mesh_io.write_stl_from_device(out_path, dm)
    times["stl"] = time.perf_counter() - t0
    return Result(labels=labels, mesh=dm, times=times)

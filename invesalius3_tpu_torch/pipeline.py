"""The headline flow: CT -> watershed on the morphological gradient ->
mask -> marching tetrahedra -> context-aware smoothing -> binary STL (port
of bench.py ``make_ct``, the bench markers and ``pipeline()``, on one
device or, with ``shards``, over a shard list as bench.py's sharded branch).

    from invesalius3_tpu_torch import pipeline
    from invesalius3_tpu_torch.parallel.mesh_utils import make_mesh
    ct = pipeline.make_ct(512)
    res = pipeline.run(ct, pipeline.bench_markers(512), "out.stl")  # on the card
    print(res.mesh.n_verts, res.mesh.n_tris, res.times)
    res = pipeline.run(ct, pipeline.bench_markers(512), "out.stl",
                       shards=make_mesh(8))  # 8 Z-slabs over the cards
    print(res.cuts, res.watershed_stats["rounds"], res.times)

Across processes every rank calls the same ``run`` with the same host
arrays and a mesh from ``distributed.global_mesh()`` (after
``distributed.initialize()``); rank 0 writes the STL.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from invesalius3_tpu_torch.convert import to_device
from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.io import mesh_io
from invesalius3_tpu_torch.ops import marching, mesh, watershed
from invesalius3_tpu_torch.parallel import sharded_ops
from invesalius3_tpu_torch.parallel.mesh_utils import Sharded, ShardMesh, shard_volume

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
    labels: Union[torch.Tensor, Sharded]  # watershed labels, int16
    mesh: Optional[marching.DeviceMesh]   # smoothed mesh as written (one device)
    times: Dict[str, float]               # seconds per stage (this process's)
    # the sharded flow's: (verts_sh, faces_sh, checks, meta) of
    # sharded_mask_to_surface, the Z cuts, and the watershed's stats
    # ("rounds", "halo_bytes" and "wire_bytes" per level, sweep "launches"
    # per shard), gathered from every process
    parts: Optional[tuple] = None
    cuts: Optional[List[int]] = None
    watershed_stats: Optional[dict] = None
    stl: Optional[str] = None  # the file written (None on a rank that did not write)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sync_mesh(shards: ShardMesh) -> None:
    held = shards.devices.ravel()[shards.ranks.ravel() == shards.rank]
    for d in {d for d in held if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def run(ct: np.ndarray, markers: np.ndarray, out_path, device=DEFAULT_DEVICE,
        sweep: Optional[watershed.Sweep] = None,
        rounds: Optional[list] = None,
        shards: Optional[ShardMesh] = None) -> Result:
    """Run the flow once on ``device`` (the card unless "cpu" is passed) and
    write ``out_path``.  Each stage ends with a device synchronise, so the
    stage times are the device's.  ``sweep`` and ``rounds`` pass to
    ``watershed.watershed``; the face table streams to the host while the
    mesh is smoothed (``mesh_io.DeviceFaceStream``).

    With ``shards`` (a mesh of ``device``'s kind) the flow runs Z-sharded
    as bench.py's sharded branch: ``sharded_watershed(stop="label",
    quiet_rounds=2)``, label 1 as the mask, the balanced fused surface and
    smoothing, ``write_stl_sharded``; ``rounds`` then receives the rounds
    per level, coarse to fine.  Across processes (``shards`` from
    ``distributed.global_mesh()``) every rank runs it on the same host
    arrays and holds its own shards; rank 0 writes ``out_path`` and its
    ``Result.stl`` names it."""
    device = resolve_device(device)
    if shards is not None:
        return _run_sharded(ct, markers, out_path, device, shards, sweep, rounds)
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
    faces = mesh_io.DeviceFaceStream(dm)
    out3v = mesh.ca_smoothing_device(dm, **CA_PARAMS)
    _sync(device)
    times["smoothing"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dm = dataclasses.replace(dm, verts3v=out3v)
    mesh_io.write_stl_from_device(out_path, dm, face_stream=faces)
    times["stl"] = time.perf_counter() - t0
    return Result(labels=labels, mesh=dm, times=times, stl=str(out_path))


def _run_sharded(ct, markers, out_path, device: torch.device, shards: ShardMesh,
                 sweep: Optional[watershed.Sweep], rounds: Optional[list]) -> Result:
    if any(d.type != device.type for d in shards.devices.ravel()):
        raise ValueError(f"shards {shards} are not on {device.type}")
    times: Dict[str, float] = {}
    t0 = time.perf_counter()
    ct_sh = shard_volume(ct, shards)
    markers_sh = shard_volume(markers, shards)
    if ct_sh.shape[0] != ct.shape[0]:
        raise ValueError(f"Z = {ct.shape[0]} must divide evenly over "
                         f"{shards.shape['z']} shards")
    _sync_mesh(shards)
    times["h2d"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ws_stats: dict = {}
    run_ws = sharded_ops.sharded_watershed(shards, stop="label", quiet_rounds=2)
    labels = run_ws(ct_sh, markers_sh, algorithm="Watershed", sweep=sweep,
                    stats=ws_stats)
    _sync_mesh(shards)
    times["watershed"] = time.perf_counter() - t0
    if rounds is not None:
        rounds.extend(ws_stats["rounds"])

    t0 = time.perf_counter()
    mask = labels.map(lambda a: torch.where(a == 1, 255, 0).to(torch.uint8))
    _sync_mesh(shards)
    times["mask"] = time.perf_counter() - t0

    parts = sharded_ops.sharded_mask_to_surface(
        shards, mask, spacing=SPACING, smooth=CA_PARAMS, balance=True,
        return_parts=True)
    times.update(parts[3]["times"])

    t0 = time.perf_counter()
    mesh_io.write_stl_sharded(out_path, parts[0], parts[1], shards=shards)
    times["stl"] = time.perf_counter() - t0
    return Result(labels=labels, mesh=None, times=times, parts=parts,
                  cuts=parts[3]["cuts"], watershed_stats=ws_stats,
                  stl=str(out_path) if shards.rank == 0 else None)

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (invesalius3_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each fatal on failure (no phase catches an error):

1. builds the CUDA sweep kernel and the STL packer from the repository's
   sources;
2. holds the sweep kernel against its plain PyTorch version, bit for bit,
   for axes 0, 1, 2 with int16 and int32 labels at 64^3 and (11, 21, 130);
3. runs the segmentation-to-STL flow at 128^3 through the kernel and
   through the plain sweep: labels and STL bytes must be identical;
4. runs the flow at 512^3 (bench.py's phantom and markers, spacing 0.5 mm)
   once to warm up and once timed, with the kernel's launch counts reset
   just before the timed run; checks the STL size, a closed oriented mesh
   and finite vertices;
5. times the kernel against the plain version at 512^3 per axis.

It prints the card's name and power limit first, a JSON line of the
kernels before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits with status 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from invesalius3_tpu_torch import _build, pipeline
from invesalius3_tpu_torch.ops import kernels

KERNEL_SOURCE = "invesalius3_tpu_torch/csrc/watershed_sweep.cu"
REPLACES = {  # sweep axis -> the TPU kernel it replaces
    0: "invesalius3_tpu/ops/pallas_kernels.py:259",  # watershed_sweep_z
    1: "invesalius3_tpu/ops/pallas_kernels.py:289",  # watershed_sweep_y
    2: "invesalius3_tpu/ops/pallas_kernels.py:289",  # y kernel on swapped axes
}
# the JAX package's 512^3 counts (BENCH_r05.json); its vertex count holds
# one padding orphan the port does not have
REF_TRIS, REF_VERTS = 6_168_140, 3_084_021 - 1


def log(*a) -> None:
    print(*a, flush=True)


def check_sweep_kernel(dev) -> None:
    for shape in [(64, 64, 64), (11, 21, 130)]:
        for lab_dtype in (np.int16, np.int32):
            for axis in (0, 1, 2):
                case = kernels.sweep_case(shape, lab_dtype, seed=axis)
                want = kernels.watershed_sweep_ref(
                    *(torch.from_numpy(a.copy()).to(dev) for a in case), axis)
                got = kernels.watershed_sweep(
                    *(torch.from_numpy(a.copy()).to(dev) for a in case), axis)
                torch.cuda.synchronize()
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                log(f"  sweep axis {axis} {np.dtype(lab_dtype).name} {shape}: "
                    f"{'bit-exact' if same else 'MISMATCH'}")
                if not same:
                    raise AssertionError(f"sweep kernel differs from the plain "
                                         f"version: axis {axis} {shape}")


def check_mesh(dm) -> None:
    """Finite vertices, face ids in range, every edge in exactly two faces
    and every directed edge once (closed and consistently oriented)."""
    V = dm.n_verts
    if not bool(torch.isfinite(dm.verts3v).all()):
        raise AssertionError("non-finite vertices")
    f = dm.faces3t.long()
    if int(f.min()) < 0 or int(f.max()) >= V:
        raise AssertionError("face id out of range")
    a = torch.cat([f[0], f[1], f[2]])
    b = torch.cat([f[1], f[2], f[0]])
    _, counts = torch.unique(torch.minimum(a, b) * V + torch.maximum(a, b),
                             return_counts=True)
    if not bool((counts == 2).all()):
        raise AssertionError("mesh is not closed (edge not in two faces)")
    if torch.unique(a * V + b).numel() != a.numel():
        raise AssertionError("mesh is not consistently oriented")


def time_sweeps(dev, n: int):
    """Kernel and plain-version milliseconds per sweep at n^3 with int32
    labels (the multigrid's dtype), and the largest difference."""
    case = [torch.from_numpy(a).to(dev)
            for a in kernels.sweep_case((n, n, n), np.int32, seed=5)]
    work = [a.clone() for a in case]
    out = {}
    for axis in (0, 1, 2):
        def run(fn):
            for w, a in zip(work, case):
                w.copy_(a)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*work, axis)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

        ms_k = [run(kernels.watershed_sweep) for _ in range(5)]
        rank_k, lab_k = work[0].clone(), work[1].clone()
        ms_p = [run(kernels.watershed_sweep_ref) for _ in range(2)]
        err = max(int((rank_k.long() - work[0].long()).abs().max()),
                  int((lab_k.long() - work[1].long()).abs().max()))
        if err != 0:
            raise AssertionError(f"sweep kernel differs at {n}^3, axis {axis}")
        # first launch of each includes warm-up; keep the best of the rest
        out[axis] = {"ms": min(ms_k[1:]), "plain_ms": min(ms_p[1:]),
                     "max_abs_err": err}
        log(f"  axis {axis}: kernel {ms_k} ms, plain {ms_p} ms")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    builds = _build.build_all()
    log(f"[1] build: {time.perf_counter() - t0:.2f} s")
    for name, info in builds.items():
        log(f"  {name}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    {line.strip()}")

    log("[2] sweep kernel vs plain version")
    check_sweep_kernel(dev)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        launches, times = run_flows(dev, Path(d))

    log(json.dumps({"kernels": [
        {"name": f"watershed_sweep[axis={axis}]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES[axis],
         "launches": launches[axis], **times[axis]}
        for axis in (0, 1, 2)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_flows(dev, tmp: Path):
    """Phases 3 to 5; returns (launch counts of the timed 512^3 run, sweep
    timings per axis)."""
    log("[3] 128^3 flow: kernel vs plain sweep")
    ct, markers = pipeline.make_ct(128), pipeline.bench_markers(128)
    res_k = pipeline.run(ct, markers, tmp / "k128.stl", device=dev)
    res_p = pipeline.run(ct, markers, tmp / "p128.stl", device=dev,
                         sweep=kernels.watershed_sweep_ref)
    if not torch.equal(res_k.labels, res_p.labels):
        raise AssertionError("128^3 labels differ between kernel and plain")
    mk, mp = res_k.mesh, res_p.mesh
    if not (torch.equal(mk.faces3t, mp.faces3t)
            and torch.equal(mk.verts3v, mp.verts3v)
            and (tmp / "k128.stl").read_bytes() == (tmp / "p128.stl").read_bytes()):
        raise AssertionError("128^3 meshes differ between kernel and plain")
    check_mesh(res_k.mesh)
    log(f"  labels bitwise equal, meshes and STL identical: {mk.n_verts} verts, "
        f"{mk.n_tris} tris; kernel {res_k.times['watershed']:.3f} s "
        f"vs plain {res_p.times['watershed']:.3f} s watershed")
    del res_k, res_p, mk, mp

    log("[4] 512^3 flow")
    t0 = time.perf_counter()
    ct, markers = pipeline.make_ct(512), pipeline.bench_markers(512)
    log(f"  make_ct(512): {time.perf_counter() - t0:.2f} s (host)")
    out = tmp / "out512.stl"
    t0 = time.perf_counter()
    pipeline.run(ct, markers, out, device=dev)
    log(f"  warm-up run: {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    rounds = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = pipeline.run(ct, markers, out, device=dev, rounds=rounds)
    total = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"  timed run: {total:.3f} s; stages (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in res.times.items()))
    log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  refine rounds per level (shape, rounds): {rounds}")
    log(f"  sweep launches: {launches}")
    n_verts, n_tris = res.mesh.n_verts, res.mesh.n_tris
    size = out.stat().st_size
    log(f"  n_verts {n_verts} (JAX package: {REF_VERTS} without its orphan), "
        f"n_tris {n_tris} (JAX package: {REF_TRIS}), STL {size} bytes")
    if size != 84 + 50 * n_tris:
        raise AssertionError(f"STL size {size} != 84 + 50 * {n_tris}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a sweep axis never launched: {launches}")
    labels = set(torch.unique(res.labels).tolist())
    if labels != {1, 2, 3}:
        raise AssertionError(f"unexpected labels {labels}")
    check_mesh(res.mesh)
    log("  mesh closed, oriented, finite")
    del res

    log("[5] sweep kernel vs plain at 512^3 (int32 labels)")
    return launches, time_sweeps(dev, 512)


if __name__ == "__main__":
    sys.exit(main())

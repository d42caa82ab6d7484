#!/usr/bin/env python3
"""Smoke run of the PyTorch port (invesalius3_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each fatal on failure (no phase catches an error):

1. builds the CUDA sweep kernel, the CUDA ray kernels (LMIP, MIDA) and the
   STL packer from the repository's sources, all compilers at once;
2. holds the sweep kernel against its plain PyTorch version, bit for bit,
   for axes 0, 1, 2 with int16 and int32 labels, on 64^3 and the edge
   shapes of ``kernels.SWEEP_CHECK_SHAPES`` (an even and an odd x, rays
   many tiles long, rays of length 1 and 2);
3. runs the segmentation-to-STL flow at 128^3 through the kernel and
   through the plain sweep, and the two-level multigrid watershed at 128^3
   through both: labels, refine rounds and STL bytes must be identical;
4. runs the flow at 512^3 (bench.py's phantom and markers, spacing 0.5 mm)
   once to warm up and once timed, with the kernel's launch counts reset
   just before the timed run; checks the STL size and counts, the refine
   rounds per level, a closed oriented mesh and finite vertices; then once
   more with every sweep launch between CUDA events and its changed
   elements counted (``SweepRecorder``): per-axis kernel ms in the flow,
   launches per level and the sweep's byte bound; and once under
   ``torch.profiler``: the device's idle share and its largest kernels;
5. times the kernel against the plain version at 512^3 per axis, int32
   and int16 labels, with each case's byte bound and the kernel's share;
6. holds the ray kernels against their plain PyTorch versions on every
   case of ``projection_kernels.ray_cases()``: LMIP bit for bit, MIDA within
   1 after the cast, one launch counted per call (int16, float32 and uint8
   slabs, every axis, inverted, narrowed and misaligned slabs, odd x, long
   rows and rays of 1 and 2, MIDA's table at and past its capacity,
   degenerate windows, a constant slab, a NaN), and MIDA's min/max pass bit
   for bit against torch.aminmax;
7. drives the slice viewer's frame path at 512^3 (``Slice.get_rendered_slice``
   on ``make_ct(512)``, window 400/40, the bone mask shown): every projection
   type but Normal, in every orientation, at slabs 64 and 512, once through
   the kernels (launch counts reset just before, read just after) and once
   through the plain versions; the frames must agree; then the median warm
   frame time per type and orientation;
8. times the ray kernels at 512^3, full depth, per axis (``time_rays.py``'s
   method: many calls between one pair of CUDA events): the library call
   alone and the wrapper, device launches a call from a profiler window,
   the plain version, the byte bound and the share; then the min/max pass
   against torch.aminmax.

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
from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch.core.slice import Slice
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.ops import kernels, watershed
from invesalius3_tpu_torch.ops import projection_kernels as rays

import time_rays as time_rays_lib

KERNEL_SOURCE = "invesalius3_tpu_torch/csrc/watershed_sweep.cu"
REPLACES = {  # sweep axis -> the TPU kernel it replaces
    0: "invesalius3_tpu/ops/pallas_kernels.py:259",  # watershed_sweep_z
    1: "invesalius3_tpu/ops/pallas_kernels.py:289",  # watershed_sweep_y
    2: "invesalius3_tpu/ops/pallas_kernels.py:289",  # y kernel on swapped axes
}
RAY_SOURCE = "invesalius3_tpu_torch/csrc/ray_projections.cu"
RAY_REPLACES = {"lmip": "invesalius3_tpu/ops/pallas_kernels.py:81",   # lmip_axis0
                "mida": "invesalius3_tpu/ops/pallas_kernels.py:147"}  # mida_axis0
RAY_FNS = {"lmip": (rays.lmip_rays, rays.lmip_ref),
           "mida": (rays.mida_rays, rays.mida_ref)}
ORIENTATIONS = [const.AXIAL, const.CORONAL, const.SAGITTAL]
# the MIDA types: kernel and plain frames agree within 1 (the rest exactly)
MIDA_TYPES = {const.PROJECTION_MIDA, const.PROJECTION_CONTOUR_MIDA}
FRAME_N = 512  # the frame path's CT: make_ct(512), 256 MiB of int16
# the JAX package's 512^3 counts (BENCH_r05.json); its vertex count holds
# one padding orphan the port does not have
REF_TRIS, REF_VERTS = 6_168_140, 3_084_021 - 1
# refine rounds per multigrid level of the 512^3 flow (the JAX package's)
REF_ROUNDS = [((128, 128, 128), 14), ((256, 256, 256), 10), ((512, 512, 512), 24)]
HBM_BYTES_PER_S = 3.35e12  # an H100 SXM's device-memory rate (data sheet)


def log(*a) -> None:
    print(*a, flush=True)


def sweep_bytes(n_elems: int, changed: int, lab_bytes: int) -> int:
    """Bytes one sweep must move: rank, lab and f read once, rank and lab
    written where they changed."""
    return n_elems * (8 + lab_bytes) + changed * (4 + lab_bytes)


def sweep_bound_ms(n_elems: int, changed: int, lab_bytes: int) -> float:
    return sweep_bytes(n_elems, changed, lab_bytes) / HBM_BYTES_PER_S * 1e3


class SweepRecorder:
    """A sweep function that runs ``inner`` between two CUDA events and
    counts the elements each launch changed (rank and label change
    together).  ``report`` reads the events once the run is over."""

    def __init__(self, inner):
        self.inner = inner
        self.records = []  # (shape, axis, lab bytes, start, end, changed)

    def __call__(self, rank, lab, f, axis):
        before = rank.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.inner(rank, lab, f, axis)
        end.record()
        self.records.append((tuple(rank.shape), axis, lab.element_size(), start,
                             end, (rank != before).sum()))
        return rank, lab

    def summary(self):
        """{axis: (launches, kernel ms, bound ms)}, {level shape: {axis:
        launches}}."""
        torch.cuda.synchronize()
        per_axis = {a: [0, 0.0, 0.0] for a in (0, 1, 2)}
        levels = {}
        for shape, axis, lb, start, end, changed in self.records:
            acc = per_axis[axis]
            acc[0] += 1
            acc[1] += start.elapsed_time(end)
            acc[2] += sweep_bound_ms(int(np.prod(shape)), int(changed), lb)
            lv = levels.setdefault(shape, {0: 0, 1: 0, 2: 0})
            lv[axis] += 1
        return {a: tuple(v) for a, v in per_axis.items()}, levels

    def report(self):
        per_axis, levels = self.summary()
        lines = [f"axis {a}: {n} launches, {ms:.3f} ms in the flow, bound "
                 f"{b:.3f} ms ({b / ms:.1%})" for a, (n, ms, b) in per_axis.items()]
        ms = sum(v[1] for v in per_axis.values())
        b = sum(v[2] for v in per_axis.values())
        lines.append(f"all axes: {ms:.3f} ms, bound {b:.3f} ms ({b / ms:.1%})")
        lines.append("launches per level (shape: axis 0/1/2): " + "; ".join(
            f"{s}: {v[0]}/{v[1]}/{v[2]}" for s, v in levels.items()))
        return lines


def check_sweep_kernel(dev) -> None:
    for shape in kernels.SWEEP_CHECK_SHAPES:
        for lab_dtype in (np.int16, np.int32):
            for axis in (0, 1, 2):
                case = kernels.sweep_case(shape, lab_dtype, seed=axis)
                want = kernels.watershed_sweep_ref(
                    *(torch.from_numpy(a.copy()).to(dev) for a in case), axis)
                got = kernels.watershed_sweep(
                    *(torch.from_numpy(a.copy()).to(dev) for a in case), axis)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(
                        f"sweep kernel differs from the plain version: axis "
                        f"{axis} {np.dtype(lab_dtype).name} {shape}")
        log(f"  {shape}: bit-exact on every axis, int16 and int32 labels")


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


def time_sweeps(dev, n: int, lab_dtype):
    """Kernel and plain-version milliseconds per sweep at n^3, the largest
    difference, and the case's byte bound (``sweep_bytes``)."""
    case = [torch.from_numpy(a).to(dev)
            for a in kernels.sweep_case((n, n, n), lab_dtype, seed=5)]
    work = [a.clone() for a in case]
    lab_bytes = np.dtype(lab_dtype).itemsize
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
        changed = int((rank_k != case[0]).sum())
        bound = sweep_bound_ms(n ** 3, changed, lab_bytes)
        # first launch of each includes warm-up; keep the best of the rest
        out[axis] = {"ms": min(ms_k[1:]), "plain_ms": min(ms_p[1:]),
                     "max_abs_err": err, "bound_ms": bound, "bound_by": "bytes",
                     "library_ms": None}
        log(f"  {np.dtype(lab_dtype).name} axis {axis}: kernel "
            f"{[round(t, 4) for t in ms_k]} ms, plain {[round(t, 3) for t in ms_p]} "
            f"ms; bound {bound:.4f} ms ({changed} elements changed), share "
            f"{bound / min(ms_k[1:]):.1%}")
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

    errs = {(k, a): 0.0 for k in RAY_FNS for a in (0, 1, 2)}
    log("[6] ray kernels vs plain versions")
    check_ray_kernels(dev, errs)
    ray_launches, slc = frame_path(dev, errs)
    log("[8] ray kernels vs plain at full depth (int16, the frame's window)")
    ray_times = ray_timings(slc, errs)

    entries = [
        {"name": f"watershed_sweep[axis={axis}]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES[axis],
         "launches": launches[axis], **times[axis]}
        for axis in (0, 1, 2)]
    entries += [
        {"name": f"{k}_axis0[axis={axis}]", "route": "cuda", "source": RAY_SOURCE,
         "replaces": RAY_REPLACES[k], "launches": ray_launches[k][axis],
         "max_abs_err": errs[(k, axis)], **ray_times[(k, axis)]}
        for k in RAY_FNS for axis in (0, 1, 2)]
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_flows(dev, tmp: Path):
    """Phases 3 to 5; returns (launch counts of the timed 512^3 run, sweep
    timings per axis)."""
    log("[3] 128^3 flow: kernel vs plain sweep")
    ct, markers = pipeline.make_ct(128), pipeline.bench_markers(128)
    rounds_k, rounds_p = [], []
    res_k = pipeline.run(ct, markers, tmp / "k128.stl", device=dev,
                         rounds=rounds_k)
    res_p = pipeline.run(ct, markers, tmp / "p128.stl", device=dev,
                         sweep=kernels.watershed_sweep_ref, rounds=rounds_p)
    if not torch.equal(res_k.labels, res_p.labels):
        raise AssertionError("128^3 labels differ between kernel and plain")
    if rounds_k != rounds_p:
        raise AssertionError(f"128^3 refine rounds differ: kernel {rounds_k}, "
                             f"plain {rounds_p}")
    mk, mp = res_k.mesh, res_p.mesh
    if not (torch.equal(mk.faces3t, mp.faces3t)
            and torch.equal(mk.verts3v, mp.verts3v)
            and (tmp / "k128.stl").read_bytes() == (tmp / "p128.stl").read_bytes()):
        raise AssertionError("128^3 meshes differ between kernel and plain")
    check_mesh(res_k.mesh)
    # the flow's 128^3 watershed is the plain fixpoint (no multigrid below
    # 192 a side); the two-level multigrid is held here too, rounds and all
    ct_d, m_d = torch.from_numpy(ct).to(dev), torch.from_numpy(markers).to(dev)
    mg_k, mg_p = [], []
    lab_k = watershed.watershed(ct_d, m_d, multigrid_levels=2, rounds=mg_k)
    lab_p = watershed.watershed(ct_d, m_d, multigrid_levels=2,
                                sweep=kernels.watershed_sweep_ref, rounds=mg_p)
    if not torch.equal(lab_k, lab_p) or mg_k != mg_p or not mg_k:
        raise AssertionError(f"128^3 multigrid differs: rounds {mg_k} vs {mg_p}")
    log(f"  two-level multigrid: labels bitwise equal, rounds {mg_k} equal")
    log(f"  flow: labels bitwise equal, rounds {rounds_k} equal, meshes and STL "
        f"identical: {mk.n_verts} verts, "
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
    if (n_tris, n_verts) != (REF_TRIS, REF_VERTS):
        raise AssertionError(f"n_tris {n_tris}, n_verts {n_verts}: the JAX "
                             f"package gives {REF_TRIS}, {REF_VERTS}")
    if rounds != REF_ROUNDS:
        raise AssertionError(f"refine rounds {rounds} != {REF_ROUNDS}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a sweep axis never launched: {launches}")
    labels = set(torch.unique(res.labels).tolist())
    if labels != {1, 2, 3}:
        raise AssertionError(f"unexpected labels {labels}")
    check_mesh(res.mesh)
    log("  mesh closed, oriented, finite")
    del res

    rec = SweepRecorder(kernels.watershed_sweep)
    rounds = []
    t0 = time.perf_counter()
    res = pipeline.run(ct, markers, out, device=dev, sweep=rec, rounds=rounds)
    log(f"  instrumented run (each sweep between CUDA events, changed elements "
        f"counted): {time.perf_counter() - t0:.3f} s; rounds {rounds}")
    if rounds != REF_ROUNDS or res.mesh.n_tris != REF_TRIS:
        raise AssertionError(f"instrumented run: rounds {rounds}, n_tris "
                             f"{res.mesh.n_tris}")
    for line in rec.report():
        log(f"    {line}")
    del res, rec
    profile_flow(dev, ct, markers, out)

    log("[5] sweep kernel vs plain at 512^3")
    times = time_sweeps(dev, 512, np.int32)
    time_sweeps(dev, 512, np.int16)
    return launches, times


def profile_flow(dev, ct, markers, out: Path) -> None:
    """One warm flow under torch.profiler: the device's kernel and copy
    time, its idle share of the run's wall time, and the largest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipeline.run(ct, markers, out, device=dev)
        wall = time.perf_counter() - t0
    # kernels and copies only: an aten op's row repeats its kernels' time
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and not e.key.startswith(("aten::", "cuda"))
            and "Activity Buffer" not in e.key]
    busy = sum(ms for _, ms, _ in rows) / 1e3
    log(f"  profiled run: wall {wall:.4f} s, device kernel and copy time "
        f"{busy:.4f} s, idle share {1 - busy / wall:.1%}")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"    {ms:9.3f} ms {count:5d}x  {name[:90]}")


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want|, NaN against NaN counting as equal."""
    d = (got.double() - want.double()).abs()
    d = torch.where(torch.isnan(got) & torch.isnan(want), 0.0, d)
    return float(d.max())


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit: equal dtype, shape and values, NaN where the other is."""
    return (got.dtype == want.dtype and got.shape == want.shape
            and bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all()))


def check_ray_kernels(dev, errs) -> None:
    """Phase 6: LMIP bit-exact, MIDA within 1 after the cast, one launch
    counted per call; the min/max pass bit-exact against torch.aminmax."""
    f32_diff = 0.0
    for case in rays.ray_cases():
        axis = case.axis
        slab = rays.case_slab(case, dev)
        for k, params in (("lmip", rays.LMIP_PARAMS), ("mida", rays.MIDA_PARAMS)):
            kernel, plain = RAY_FNS[k]
            for a, b in params:
                before = rays.LAUNCHES[k][axis]
                got, want = kernel(slab, axis, a, b), plain(slab, axis, a, b)
                torch.cuda.synchronize()
                if rays.LAUNCHES[k][axis] != before + 1:
                    raise AssertionError(f"{k}: {case.label} counted "
                                         f"{rays.LAUNCHES[k][axis] - before} launches")
                err = _err(got, want)
                errs[(k, axis)] = max(errs[(k, axis)], err)
                if slab.dtype == torch.float32 and k == "mida":
                    f32_diff = max(f32_diff, err)
                if (k == "lmip" and not _same(got, want)) or err > 1 \
                        or got.dtype != want.dtype:
                    raise AssertionError(f"{k} kernel differs from its plain version: "
                                         f"{case.label}, params {(a, b)}, max err {err}")
        mm = rays.slab_minmax(slab)
        if not _same(mm, rays.minmax_ref(slab)):
            raise AssertionError(f"min/max pass differs from torch.aminmax: {case.label}: "
                                 f"{mm.tolist()}")
        log(f"  {case.label}: lmip bit-exact, min/max exact, mida max err "
            f"{errs[('mida', axis)]:g} so far")
    log(f"  largest MIDA difference on float32 slabs: {f32_diff!r}")


def _slabs(n: int):
    """(first slice, slab) pairs of phase 7: a slab of n/8 from the middle
    and the whole volume from slice 0."""
    return ((n * 7 // 16, n // 8), (0, n))


def _frames(n: int):
    """(projection, orientation, first slice, slab) of phase 7."""
    types = [p for p in sorted(const.PROJECTION_NAMES) if p != const.PROJECTION_NORMAL]
    return [(p, o, start, slabs) for p in types for o in ORIENTATIONS
            for start, slabs in _slabs(n)]


def frame_path(dev, errs, n: int = FRAME_N):
    """Phase 7; returns (ray-kernel launch counts of the main path's run,
    the Slice of the n^3 volume on the card)."""
    log(f"[7] slice viewer frame path at {n}^3")
    t0 = time.perf_counter()
    vol = Volume.from_numpy(pipeline.make_ct(n), spacing=pipeline.SPACING,
                            device=dev)
    slc = Slice(vol)
    slc.set_window(400.0, 40.0)
    slc.create_new_mask(threshold_range=const.THRESHOLD_PRESETS_CT["Bone"])
    torch.cuda.synchronize()
    log(f"  set-up (make_ct, h2d, bone mask): {time.perf_counter() - t0:.2f} s")
    frames = _frames(n)
    for p, o, start, slabs in frames:           # warm-up
        slc.get_rendered_slice(o, start, projection=p, slabs=slabs)
    torch.cuda.reset_peak_memory_stats()
    rays.reset_launches()
    t0 = time.perf_counter()
    rgb_k = [slc.get_rendered_slice(o, start, projection=p, slabs=slabs)
             for p, o, start, slabs in frames]
    total = time.perf_counter() - t0
    launches = {k: dict(v) for k, v in rays.LAUNCHES.items()}
    log(f"  main path: {len(frames)} frames in {total:.3f} s; ray kernel "
        f"launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if min(n for per_axis in launches.values() for n in per_axis.values()) <= 0:
        raise AssertionError(f"a ray kernel axis never launched: {launches}")
    if any(launches[k][a] != 4 for k in RAY_FNS for a in (0, 1, 2)):
        raise AssertionError(f"expected 4 launches per ray kernel and axis: {launches}")

    t0 = time.perf_counter()
    n_diff = 0
    for (p, o, start, slabs), rgb in zip(frames, rgb_k):
        axis = const.ORIENTATION_AXIS[o]
        img_k = slc.project(o, start, slabs, projection=p)
        img_p = slc.project(o, start, slabs, projection=p, plain=True)
        rgb_p = slc.render_image(img_p, o, start, slc.window_width,
                                 slc.window_level)
        if rgb.shape != (n, n, 3) or rgb.dtype != np.uint8:
            raise AssertionError(f"frame {p} {o}: {rgb.shape} {rgb.dtype}")
        err = _err(img_k, img_p)
        if p in MIDA_TYPES:
            errs[("mida", axis)] = max(errs[("mida", axis)], err)
        elif p in (const.PROJECTION_LMIP, const.PROJECTION_CONTOUR_LMIP):
            errs[("lmip", axis)] = max(errs[("lmip", axis)], err)
        exact = p not in MIDA_TYPES
        if (exact and (err != 0 or not np.array_equal(rgb, rgb_p))) or err > 1:
            raise AssertionError(f"frame {const.PROJECTION_NAMES[p]} {o} slab "
                                 f"{slabs}: kernel and plain differ (max {err})")
        n_diff += int(not np.array_equal(rgb, rgb_p))
    log(f"  {len(frames)} frames checked against the plain versions "
        f"({time.perf_counter() - t0:.1f} s): exact types equal, RGB frames "
        f"differing {n_diff}")

    log("  warm frame ms, median of 5 (host clock, RGB on the host): "
        f"type, orientation: slab {n // 8} / slab {n}")
    for p in sorted({f[0] for f in frames}):
        for o in ORIENTATIONS:
            ms = []
            for start, slabs in _slabs(n):
                t = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    slc.get_rendered_slice(o, start, projection=p, slabs=slabs)
                    t.append((time.perf_counter() - t0) * 1e3)
                ms.append(float(np.median(t)))
            log(f"    {const.PROJECTION_NAMES[p]:>13s} {o:>8s}: "
                f"{ms[0]:8.3f} / {ms[1]:8.3f}")
    return launches, slc


def _event_ms(fn, reps: int):
    """Milliseconds of one call by CUDA events (for the slow plain
    versions): one warm-up, then the best of ``reps``; returns (best, the
    output)."""
    out = fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best, out


def lmip_reads(volume, axis: int, tmin: float, tmax: float) -> int:
    """Elements the LMIP kernel must read: every ray up to and including the
    step that stops it (the first strict decrease once a value in
    [tmin, tmax] has been seen), the rest of a stopped ray not at all."""
    lanes = volume.movedim(axis, 0)
    m = lanes[0].float()
    start = (m >= tmin) & (m <= tmax)
    stopped = torch.zeros_like(start)
    reads = torch.tensor(m.numel(), dtype=torch.int64, device=volume.device)
    for z in range(1, lanes.shape[0]):
        reads += (~stopped).sum()
        v = lanes[z].float()
        stop = ~stopped & start & (v < m)
        go = ~stopped & ~stop
        m = torch.where(go & (v > m), v, m)
        start = torch.where(go, start | ((v >= tmin) & (v <= tmax)), start)
        stopped |= stop
    return int(reads)


def ray_bound_ms(k: str, volume, axis: int, params) -> float:
    """The least time for a ray kernel's call at the device-memory rate:
    LMIP reads what its rays need (``lmip_reads``); MIDA normalises by the
    slab's min and max, so it reads every element; both write one plane."""
    n = lmip_reads(volume, axis, *params) if k == "lmip" else volume.numel()
    plane = volume.numel() // volume.shape[axis]
    return (n + plane) * volume.element_size() / HBM_BYTES_PER_S * 1e3


def ray_timings(slc, errs):
    """Phase 8 at full depth on the frame path's volume, per kernel and
    axis, with the frame path's parameters (LMIP (40, 40), MIDA (40, 40)):
    kernel ms (the library call alone) and wrapper ms by many calls between
    one pair of CUDA events, device launches per call from a profiler
    window (``time_rays.time_kernels``), the plain version's ms, the byte
    bound and the kernel's share of it; then the min/max pass against
    torch.aminmax, and the LMIP and MIDA frames' project and frame ms
    (``time_rays.time_frames``)."""
    volume = slc.matrix
    out = {}
    timed = time_rays_lib.time_kernels(rays, volume, log)
    for k, (kernel, plain) in RAY_FNS.items():
        for axis in (0, 1, 2):
            p_ms, want = _event_ms(lambda: plain(volume, axis, *time_rays_lib.PARAMS), 1)
            got = kernel(volume, axis, *time_rays_lib.PARAMS)
            err = _err(got, want)
            errs[(k, axis)] = max(errs[(k, axis)], err)
            if (k == "lmip" and not _same(got, want)) or err > 1:
                raise AssertionError(f"{k} axis {axis} at full size differs (max {err})")
            row = timed[(k, axis)]
            bound = ray_bound_ms(k, volume, axis, time_rays_lib.PARAMS)
            out[(k, axis)] = {"ms": row["kernel_ms"], "plain_ms": p_ms, "bound_ms": bound,
                              "bound_by": "bytes", "library_ms": None}
            log(f"  {k} axis {axis}: kernel {row['kernel_ms']:.4f} ms, wrapper "
                f"{row['wrapper_ms']:.4f} ms, {row['launches_per_call']:g} device "
                f"launches a call; plain {p_ms:.3f} ms; max err {err:g}; bound "
                f"{bound:.4f} ms, share {bound / row['kernel_ms']:.1%} (kernel), "
                f"{bound / row['wrapper_ms']:.1%} (wrapper)")
    time_rays_lib.time_minmax(rays, volume, log)
    time_rays_lib.time_frames(slc, const, volume.shape[0], log)
    return out


if __name__ == "__main__":
    sys.exit(main())

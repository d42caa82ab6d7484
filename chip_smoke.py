#!/usr/bin/env python3
"""Smoke run of the PyTorch port (invesalius3_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each fatal on failure (no phase catches an error):

1. builds the CUDA sweep kernel, the CUDA ray kernels (LMIP, MIDA), the
   STL packer, the QEM decimator and the DICOM codecs (lossless JPEG and
   PackBits) from the repository's sources, all compilers at once;
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
   against torch.aminmax;
9. runs the headless app's surface flow at 512^3 on the card: ``make_ct(512)``
   (spacing 0.5 mm) written as an uncompressed NIfTI, then ``app.main``
   (--import-file, -t Bone, -e STL, -s .inv3, --algorithm ca_smoothing) once
   to warm up and once timed (its .inv3 save timed); then, stage by stage on
   a Slice of that file, ``create_surface_from_mask`` for Default,
   context-aware smoothing with grid and with mesh propagation,
   keep-largest, and quality "Low" (QEM decimation by 0.4; 36-45 s at 512^3
   on the card's host, under the 60 s that would move it to 256^3), the STL
   export and the .inv3 open.  Every undecimated surface must be closed,
   oriented and finite; Default and smoothed surfaces have one triangle
   count; grid and mesh propagation move the vertices alike; keep-largest
   leaves one component; "Low" reaches its triangle target; volumes and
   areas are finite and positive; the app's STL is the smoothed surface's
   records; the reopened .inv3 holds the same mask and surface.  No kernel
   lies on this path (the counts are printed);
10. drives the slice viewer's mask-editing tools on a Slice of
   ``make_ct(512)`` (spacing 0.5 mm) as the viewer server's endpoints call
   them: the CT Bone mask (``count_regions`` gives the shell and the
   island, ``largest_component`` is the shell); an erase stroke carving
   enclosed pockets in the shell, then ``Mask.fill_holes_auto(1000, 6)``,
   which must refill exactly those pockets with 254, with undo and redo; a
   paint stroke; the four threshold brushes; a stroke with stamps at 0 and
   511 on every axis (each stroke held to a stamp-by-stamp numpy oracle);
   ``count_regions`` and ``largest_component`` of the edited mask against
   ``scipy.ndimage.label``; ``floodfill_threshold`` from a shell seed against
   the shell's component of ``label`` and scipy's iterated dilation;
   ``select_part`` and "remove" on the island (the visible count falls by
   the island's size); ``region_grow_dynamic`` and
   ``region_grow_confidence`` from a soft-tissue seed; the automatic hole
   fill against scipy; ``apply_image_filter`` with each filter in 3D and in
   2D (the axes in turn; median at size 3); ``calc_mask_area`` against an
   exposed-face count in float64.  Per op: the wall time (device
   synchronised; pure ops twice, first and warm), the fixpoint checks and
   the peak device memory.  The same sequence first runs at 64^3 on the card
   and on the CPU, and every mask, label array and filtered image must be
   equal.  No kernel lies on this path (the counts must stay 0).
11. drives the 3D viewer's path on a Slice of ``make_ct(512)`` (spacing
   0.5 mm) as the viewer server's endpoints call it: ``reslice.
   apply_view_matrix_transform`` of the whole volume under a 20 degree
   oblique rotation about its centre with each of the four methods
   (nearest and trilinear against a float64 numpy oracle on 10^4 sampled
   voxels; the identity leaves a slab's interior unchanged, with the slab
   offset); ``Slice.apply_reorientation`` (tricubic) with the Bone mask
   edited by a stroke (its nearest resample) and an unedited mask (the
   threshold of the new matrix); ``resize_volume`` to 256^3 (orders 0 and
   1) and ``resize_by_spacing_scale(3)``; ``shear_warp_render`` with the
   Bone, "Soft + Skin" and MIP presets at image 512 / downsample 1 and
   image 256 / downsample 2 from the six principal directions and (30,
   20), each a cold frame and the median of 5 warm frames, and one
   unshaded frame per preset against the gather raycaster; the gather
   raycaster ``render`` at 512 with 256 steps (Bone, MIP, a crop plane);
   ``render_mask_preview``; the Bone surface (9,235,800 triangles) through
   ``render_surfaces`` (plain, SSAO, alpha 0.5), ``render_scene`` with
   every glyph and the slice plane, ``remove_non_visible_faces``, and the
   decimating path on a 128^3 CT's surface; ``polygon2mask`` and
   ``mask_cut`` in both edit modes with and without a depth limit (only
   visible voxels cut, a z-slab against a numpy oracle).  Per op: the wall
   time (first and warm), the peak device memory (under 24 GiB for every
   reslice method and the mask cut).  The same sequence first runs at
   64^3 on the card and on the CPU within the CPU tests' bounds.  No
   kernel lies on this path (the counts must stay 0).
12. drives the deep-learning segmentation family (``models_phase``): writes
   every checkpoint at the published widths into a temporary models dir
   under the reference key names (``Unet3D`` 8 features for brain, trachea
   and mandible from seeded generators, the mandible as a TorchScript
   archive; the three FastSurfer views, 64 filters, as ONNX; the
   cranioplasty ``Unet2D`` as a TorchScript archive whose weights make its
   mask the bone mask's 3x3 majority vote, ``majority_implant_state``) and
   resolves each through the port's models dir, downloads refused; runs
   every segmenter on the card and on the CPU at small sizes (brain and
   trachea 64^3, mandible 100x96x96, the implant binary and gray on a
   4-slice 512^2 slab, FastSurfer at conform 64) within the CPU tests'
   bounds (FastSurfer's chaotic random net by the 99th percentile of its
   sums and 99% of its decided labels); times cuDNN's NCDHW against
   channels-last a batch; then at full width, twice each (first, warm),
   with peak memory, patches a second, TFLOP/s and the share of the bf16
   peak: ``BrainSegmenter`` on a 256^3 MRI phantom (1000 patches; batch 4
   against batch 8; one run under ``torch.profiler``), ``TracheaSegmenter``
   on ``make_ct(512)`` (9261 patches), ``MandibleSegmenter`` on its first
   256 slices (500 patches of 96^3), each with eight patches run alone
   against the volume on the voxels they write last;
   ``app.main(["--cranioplasty", ct.nii, implant.stl])`` on ``make_ct(512)``
   (2048 patches of 480^2), its STL equal to the surface of the majority
   vote; ``SubpartSegmenter`` at conform 256 on a 256^3 phantom with
   ``run_quick_qc`` and ``structure_masks``, and the three-view sum at 27
   voxels rebuilt bit for bit from its slices.  No kernel lies on this
   path (the counts must stay 0).
13. drives the study importers (``study_importers``): ``make_ct(512)`` as
   512 DICOM files of 512^2 (explicit VR LE, HU + 1024 rescaled by -1024,
   patient, study and series UIDs, positions along the normal, names
   shuffled) beside a second, 128-slice series; times ``load_dicom_dir``,
   the pixel reads, the rescale and ``group_to_volume`` with its H2D
   (pageable, and a pinned copy for comparison), the volume equal to
   ``make_ct(512)`` bit for bit with its spacing and affine; ``app -i -t
   Bone -e --algorithm ca_smoothing``, its STL bytes equal to the same flow
   from a NIfTI of the array; ``--import-all``, two STLs named by the
   series UIDs; the series written with a 15 degree gantry tilt through
   ``group_to_volume``, ``fix_gantry_tilt`` at 512^3 on the card against
   the CPU (equal on at least 99.9% of voxels, within one grey level), both
   timed, with the peak device memory; RLE and lossless JPEG series of 32
   slices decoded by the native library (equal to the written pixels and,
   every fourth slice, to the plain Python decoders), JPEG-LS lossless and
   near-lossless, 12-bit JPEG, baseline JPEG and JPEG 2000 on two slices
   each (lossless equal, lossy within the JAX tests' bounds), ms a slice;
   ``pillow: <version|absent>``: with Pillow, ``--import-folder --spacing``
   on 512 16-bit TIFF slices (STL equal to the NIfTI flow's), without it
   the Pillow paths must raise naming Pillow; a 512x512x512 V4.2 PAR/REC
   pair read and imported (STL equal).  No kernel lies on this path (the
   counts must stay 0).

It prints the card's name and power limit first, a JSON line of the
kernels before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits with status 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import scipy.ndimage as ndi
import torch

from invesalius3_tpu_torch import _build, app, pipeline
from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.core.project import Project
from invesalius3_tpu_torch.core.slice import Slice
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.io import dicom, mesh_io, nifti
from invesalius3_tpu_torch.io import dicom_codecs as codecs
from invesalius3_tpu_torch.core.surface import Surface, create_surface_from_mask
from invesalius3_tpu_torch.models import fastsurfer, onnx_convert, segment, unet2d, unet3d
from invesalius3_tpu_torch.models import layers as mlayers
from invesalius3_tpu_torch.net import download
from invesalius3_tpu_torch.ops import (connected, floodfill, kernels, mesh, morphology,
                                       rasterize, raycast, render_mesh, reslice, resize,
                                       transforms, watershed)
from invesalius3_tpu_torch.ops import projection_kernels as rays
from invesalius3_tpu_torch.ops import threshold as thr_ops
from invesalius3_tpu_torch.utils import paths

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
APP_N = 512  # the app flow's CT side (phase 9)
MASK_EDIT_N = 512  # the mask-editing path's CT side (phase 10)
MASK_EDIT_SMALL = 64  # its sequence on the card and on the CPU
VIEWER_N = 512  # the 3D viewer path's CT side (phase 11)
VIEWER_SMALL = 64  # its sequence on the card and on the CPU


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


def check_closed(verts3v: torch.Tensor, faces3t: torch.Tensor) -> None:
    """Finite vertices, face ids in range, every edge in exactly two faces
    and every directed edge once (closed and consistently oriented)."""
    V = verts3v.shape[1]
    if not bool(torch.isfinite(verts3v).all()):
        raise AssertionError("non-finite vertices")
    f = faces3t.long()
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


def check_mesh(dm) -> None:
    check_closed(dm.verts3v, dm.faces3t)


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
    del slc
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_app_") as d:
        app_flow(dev, Path(d))
    torch.cuda.empty_cache()
    mask_editing(dev)
    torch.cuda.empty_cache()
    viewer_3d(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_models_") as d:
        models_phase(dev, Path(d))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as d:
        study_importers(dev, Path(d))

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


def _surface_on(s, dev):
    """A host surface's (3, V) verts and (3, F) faces on the card."""
    return (torch.from_numpy(s.vertices).to(dev).t(),
            torch.from_numpy(s.faces).to(dev).t())


def _check_measures(name: str, s) -> None:
    if not (np.isfinite([s.volume, s.area]).all() and s.volume > 0 and s.area > 0):
        raise AssertionError(f"{name}: volume {s.volume}, area {s.area}")


def _timed_surface(slc, name: str, **opts):
    """One create_surface_from_mask with its stage seconds printed."""
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = slc.create_surface_from_mask(times=times, **opts)
    total = time.perf_counter() - t0
    log(f"  {name}: {total:.3f} s; " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; {len(s.faces)} tris, {len(s.vertices)} verts, volume {s.volume!r} mm^3, "
        f"area {s.area!r} mm^2")
    _check_measures(name, s)
    return s


def _bone_slice(path: Path, dev, stages=None):
    """A Slice of the NIfTI at ``path`` on the card with the CT Bone mask,
    each stage's seconds recorded in ``stages`` (NIfTI read, h2d,
    threshold)."""
    stages = {} if stages is None else stages
    t0 = time.perf_counter()
    img = nifti.read_nifti(path)
    stages["nifti_read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vol = Volume.from_numpy(img.data, spacing=img.spacing, affine=img.affine, device=dev)
    torch.cuda.synchronize()
    stages["h2d"] = time.perf_counter() - t0
    slc = Slice(vol)
    t0 = time.perf_counter()
    slc.create_new_mask(threshold_range=const.THRESHOLD_PRESETS_CT["Bone"])
    torch.cuda.synchronize()
    stages["threshold"] = time.perf_counter() - t0
    return slc


def app_flow(dev, tmp: Path, n: int = APP_N) -> None:
    """Phase 9: the headless app and the surface cases at n^3 on the card."""
    import os

    log(f"[9] the headless app's surface flow at {n}^3")
    os.environ["XDG_CONFIG_HOME"] = str(tmp / "config")  # the app's session
    kernels.reset_launches()
    rays.reset_launches()
    t0 = time.perf_counter()
    ct_path = tmp / "ct.nii"
    nifti.write_nifti(ct_path, pipeline.make_ct(n), spacing=pipeline.SPACING)
    log(f"  make_ct({n}) written as {ct_path.name}: {time.perf_counter() - t0:.2f} s (host)")
    argv = ["--import-file", str(ct_path), "-t", "Bone", "-e", str(tmp / "bone.stl"),
            "-s", str(tmp / "proj.inv3"), "--algorithm", "ca_smoothing"]
    log(f"  app.main({' '.join(a.replace(str(tmp), '$TMP') for a in argv)})")
    stages = {}
    save = Project.save

    def timed_save(self, *a, **kw):  # the app's own .inv3 save, timed
        t0 = time.perf_counter()
        save(self, *a, **kw)
        stages["inv3_save"] = time.perf_counter() - t0

    for run in ("warm-up", "timed"):
        torch.cuda.reset_peak_memory_stats()
        Project.save = timed_save if run == "timed" else save
        t0 = time.perf_counter()
        try:
            if app.main(argv, device=dev) != 0:
                raise AssertionError("app.main failed")
        finally:
            Project.save = save
        torch.cuda.synchronize()
        log(f"  {run} run: {time.perf_counter() - t0:.3f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    slc = _bone_slice(ct_path, dev, stages)
    torch.cuda.reset_peak_memory_stats()
    surfs = {
        "Default": _timed_surface(slc, "Default"),
        "ca_grid": _timed_surface(slc, "ca_smoothing, grid propagation",
                                  algorithm="ca_smoothing"),
        "ca_mesh": _timed_surface(slc, "ca_smoothing, mesh propagation",
                                  algorithm="ca_smoothing",
                                  ca_options={"propagate": "mesh"}),
        "keep_largest": _timed_surface(slc, "Default, keep_largest", keep_largest=True),
    }
    log(f"  peak device memory of the four cases: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, s in surfs.items():
        check_closed(*_surface_on(s, dev))
    log("  every undecimated surface closed, oriented, finite")
    n_tris = {k: len(s.faces) for k, s in surfs.items()}
    if not n_tris["Default"] == n_tris["ca_grid"] == n_tris["ca_mesh"]:
        raise AssertionError(f"triangle counts differ: {n_tris}")
    base = surfs["Default"].vertices
    d_grid = np.linalg.norm(surfs["ca_grid"].vertices - base, axis=1)
    d_mesh = np.linalg.norm(surfs["ca_mesh"].vertices - base, axis=1)
    gap = float(np.abs(surfs["ca_grid"].vertices - surfs["ca_mesh"].vertices).max())
    log(f"  grid vs mesh propagation: mean move {d_grid.mean():.5f} vs "
        f"{d_mesh.mean():.5f} mm, largest vertex gap {gap:.5f} mm")
    if abs(d_grid.mean() - d_mesh.mean()) >= 0.15 * max(d_mesh.mean(), 1e-6) or gap > 0.5:
        raise AssertionError("grid and mesh propagation disagree")
    comps = np.unique(mesh.mesh_components(surfs["keep_largest"].faces,
                                           len(surfs["keep_largest"].vertices)))
    if len(comps) != 1 or n_tris["keep_largest"] >= n_tris["Default"]:
        raise AssertionError(f"keep_largest: {len(comps)} components, "
                             f"{n_tris['keep_largest']} of {n_tris['Default']} tris")
    log(f"  keep_largest: one component, {n_tris['keep_largest']} of "
        f"{n_tris['Default']} triangles")

    low = _timed_surface(slc, 'quality "Low"', quality="Low")
    target = int(n_tris["Default"] * (1.0 - const.SURFACE_QUALITY["Low"][3]))
    if not target - 2 <= len(low.faces) <= target:
        raise AssertionError(f"Low: {len(low.faces)} tris, target {target}")

    ref = surfs["ca_grid"]
    stl = (tmp / "bone.stl").read_bytes()
    if stl[84:] != mesh_io.stl_records(ref.vertices, ref.faces).tobytes() \
            or int.from_bytes(stl[80:84], "little") != len(ref.faces):
        raise AssertionError("the app's STL is not the smoothed surface")
    log("  the app's STL read back equals the smoothed surface's records")
    t0 = time.perf_counter()
    ref.export(tmp / "export.stl")
    stages["export_stl"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    opened = Project.open(tmp / "proj.inv3", device=dev)
    torch.cuda.synchronize()
    stages["inv3_open"] = time.perf_counter() - t0
    m = next(iter(opened.mask_dict.values()))
    s = next(iter(opened.surface_dict.values()))
    if not torch.equal(m.data, slc.current_mask.data):
        raise AssertionError("reopened .inv3: the mask differs")
    if not np.array_equal(s.faces, ref.faces) or not np.allclose(
            s.vertices, ref.vertices, rtol=1e-5, atol=1e-4):
        raise AssertionError("reopened .inv3: the surface differs")
    log("  the app's .inv3 reopened: same mask, same faces, vertices within the "
        "VTP text's 6 digits")
    log("  stages (s): " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    log(f"  kernel launches on this path: sweeps {dict(kernels.LAUNCHES)}, rays "
        f"{ {k: dict(v) for k, v in rays.LAUNCHES.items()} } (no kernel lies on it)")


# ---------------------------------------------------------------------------
# phase 10: the mask-editing path
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


class OpTimes:
    """Phase 10's record per op: the wall time with the device synchronised
    (a pure op twice: first and warm), the fixpoint checks (``checks`` or
    ``rounds`` lists the op fills) and the peak device memory."""

    def __init__(self, dev):
        self.dev = dev
        self.stats = {}

    def __call__(self, name: str, fn, repeat: bool = True):
        times = []
        for _ in range(2 if repeat else 1):
            checks = []
            _sync(self.dev)
            if self.dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(checks)
            _sync(self.dev)
            times.append((time.perf_counter() - t0) * 1e3)
        peak = (torch.cuda.max_memory_allocated() / 2**30 if self.dev.type == "cuda"
                else None)
        self.stats[name] = {"ms": times[-1], "first_ms": times[0], "checks": checks,
                            "peak_gib": peak}
        first = f" (first {times[0]:.2f})" if repeat else " (one call)"
        log(f"    {name}: {times[-1]:.2f} ms{first}; checks {checks or '-'}; peak "
            + (f"{peak:.2f} GiB" if peak is not None else "n/a"))
        return out


def _untimed(name: str, fn, repeat: bool = True):
    return fn([])


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _stroke_oracle(before, image, brush, centers, op, value=254, tmin=0, tmax=0):
    """A stroke stamp by stamp in numpy, each stamp clamped as
    ``lax.dynamic_slice`` clamps it (the JAX package's scan)."""
    out = before.copy()
    for c in np.asarray(centers):
        start = [min(max(int(ci) - s // 2, 0), m - s)
                 for ci, s, m in zip(c, brush.shape, out.shape)]
        sl = tuple(slice(st, st + s) for st, s in zip(start, brush.shape))
        roi = out[sl]
        if op == "paint":
            roi[brush] = value
            continue
        inside = (image[sl] >= tmin) & (image[sl] <= tmax)
        if op == "thresh":
            roi[brush] = np.where(inside, 254, 1)[brush]
        elif op == "thresh_erase":
            roi[brush] = np.where(inside, 1, 254)[brush]
        elif op == "thresh_add":
            roi[brush & inside] = 254
        else:
            roi[brush & ~inside] = 1
    return out


def _same_partition(got: np.ndarray, ref: np.ndarray, n: int) -> None:
    """Two labelings 0..n of one volume name the same parts (0 the same)."""
    fwd = np.full(n + 1, -1, np.int64)
    fwd[ref.ravel()] = got.ravel()
    back = np.full(n + 1, -1, np.int64)
    back[got.ravel()] = ref.ravel()
    if not (np.array_equal(fwd[ref], got) and np.array_equal(back[got], ref)
            and fwd[0] == 0):
        raise AssertionError("the labels differ from scipy.ndimage.label's")


def _holes_oracle(mask: np.ndarray, max_size: int, strct) -> np.ndarray:
    imask = ~(mask > 127)
    lab, _ = ndi.label(imask, strct)
    sizes = np.bincount(lab.ravel())
    sizes[0] = 0
    per = sizes[lab]
    return np.where(imask & (per > 0) & (per <= max_size), np.uint8(254), mask)


def _exposed_area(vis: np.ndarray, spacing) -> float:
    """Exposed-face area in float64 (the volume's border counts as inside)."""
    sx, sy, sz = spacing
    area = 0.0
    for axis, face in ((0, sx * sy), (1, sx * sz), (2, sy * sz)):
        n = vis.shape[axis]
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis], hi[axis] = slice(0, n - 1), slice(1, n)
        a, b = vis[tuple(lo)], vis[tuple(hi)]
        area += face * (int((a & ~b).sum()) + int((b & ~a).sum()))
    return area


def edit_sequence(dev, n: int, timed=_untimed, oracle: bool = False) -> dict:
    """Phase 10's calls on a Slice of ``make_ct(n)`` on ``dev``, in the
    order the viewer server's endpoints make them (/api/threshold,
    /api/brush, /api/mask/fill_holes, undo and redo, /api/mask/part,
    /api/floodfill, /api/filter, /api/mask/stats).  ``timed(name, fn)``
    runs each op; ``oracle`` holds the results to numpy and scipy on the
    host.  Returns every result by name (tensors on ``dev``)."""
    s6 = morphology.structure_3d(6)
    out = {}
    slc = Slice(Volume.from_numpy(pipeline.make_ct(n), spacing=pipeline.SPACING, device=dev))
    image = _host(slc.matrix) if oracle else None
    c = n // 2
    shell_x = c + round(0.39 * n)  # the middle of the shell, 0.36n to 0.42n
    bone = const.THRESHOLD_PRESETS_CT["Bone"]

    # 1. threshold and the parts
    timed("threshold", lambda ch: thr_ops.threshold_new_mask(slc.matrix, *bone))
    mask = slc.create_new_mask(threshold_range=bone)
    out["threshold"] = mask.data
    vis = mask.visible_array()
    out["regions"] = timed("count_regions", lambda ch: connected.count_regions(vis, 6, ch))
    out["largest"] = timed("largest_component",
                           lambda ch: connected.largest_component(vis, 6, ch))
    if oracle:
        ref, k = ndi.label(_host(vis), s6)
        if out["regions"][1] != 2 or k != 2:
            raise AssertionError(f"count_regions {out['regions'][1]}, scipy {k}: want 2")
        _same_partition(out["regions"][0], ref, k)
        if not np.array_equal(_host(out["largest"]), ref == ref[c, c, shell_x]):
            raise AssertionError("largest_component is not the shell")
        log(f"  threshold: {int(_host(vis).sum())} visible voxels, 2 regions (scipy: 2), "
            "the largest is the shell")

    # 2. brush strokes
    def stroke(name, brush, centers, op, value=254, tmin=226, tmax=3071):
        before = _host(mask.data) if oracle else None
        cen = np.asarray(centers, np.int32)
        if op == "paint":
            fn = lambda ch: morphology.paint_brush_trajectory(  # noqa: E731
                mask.data, brush, cen, value, brush.shape)
        else:
            fn = lambda ch: morphology.paint_brush_trajectory_threshold(  # noqa: E731
                mask.data, slc.matrix, brush, cen, tmin, tmax, brush.shape, op)
        new = timed(name, fn)
        mask.apply(new)
        out[name] = mask.data
        if oracle:
            want = _stroke_oracle(before, image, brush, cen, op, value, tmin, tmax)
            if not np.array_equal(_host(new), want):
                raise AssertionError(f"{name} differs from the stamp-by-stamp oracle")
        return before

    sx = slc.spacing[0]
    r_vox = min(4, max(0, int((0.06 * n - 3) / 2)))  # a pocket inside the shell
    dot = morphology.brush_element(max(r_vox * sx, 0.4 * sx), slc.spacing, const.BRUSH_CIRCLE)
    far = n - shell_x  # the shell's middle on the low side of each axis
    pockets = [(c, c, shell_x), (c, c, far), (c, shell_x, c), (c, far, c),
               (shell_x, c, c), (far, c, c)]
    before = stroke("erase stroke", dot, pockets, "paint", const.MASK_ERASED)
    erased = mask.data
    filled = timed("fill_holes_automatically",
                   lambda ch: connected.fill_holes_automatically(erased, 1000, 6, ch))
    timed("Mask.fill_holes_auto", lambda ch: mask.fill_holes_auto(1000, 6), repeat=False)
    if not torch.equal(mask.data, filled):
        raise AssertionError("Mask.fill_holes_auto differs from fill_holes_automatically")
    out["filled"] = mask.data
    timed("Mask.undo", lambda ch: mask.undo(), repeat=False)
    out["undone"] = mask.data
    undo_ok = torch.equal(mask.data, erased)
    timed("Mask.redo", lambda ch: mask.redo(), repeat=False)
    if not (undo_ok and torch.equal(mask.data, filled)):
        raise AssertionError("undo / redo of the hole fill do not give back its two sides")
    if oracle:
        carved = _host(erased) != before
        want = np.where(carved, np.uint8(254), before)
        if not np.array_equal(_host(filled), want):
            raise AssertionError("fill_holes_auto did not refill exactly the carved pockets")
        if not np.array_equal(_host(filled), _holes_oracle(_host(erased), 1000, s6)):
            raise AssertionError("fill_holes_automatically differs from scipy's")
        log(f"  erase stroke: {int(carved.sum())} voxels in {len(pockets)} pockets "
            f"(brush {dot.shape}), all refilled with 254 (scipy agrees); undo and "
            "redo give back both sides")
    ball = morphology.brush_element(2.0 * sx, slc.spacing, const.BRUSH_CIRCLE)
    stroke("paint stroke", ball, [(c, c, c + round(0.2 * n) + k) for k in range(6)], "paint")
    inner = c + round(0.36 * n)  # across the shell's inner edge
    across = [(c - 3, c + 1, inner + k) for k in range(-3, 4)]
    for op in ("thresh", "thresh_erase", "thresh_add", "thresh_erase_only"):
        stroke(f"{op} stroke", ball, across, op)
    edges = [(0, 0, 0), (n - 1, n - 1, n - 1), (0, n - 1, c), (n - 1, 0, c), (c, 0, n - 1),
             (c, n - 1, 0)]
    stroke("edge stroke", ball, edges, "paint")

    # 3. the parts of the edited mask
    vis = mask.visible_array()
    out["regions_after"] = timed("count_regions (edited)",
                                 lambda ch: connected.count_regions(vis, 6, ch))
    out["largest_after"] = timed("largest_component (edited)",
                                 lambda ch: connected.largest_component(vis, 6, ch))
    island = (c, c, c)
    if oracle:
        ref, k = ndi.label(_host(vis), s6)
        _same_partition(out["regions_after"][0], ref, k)
        sizes = np.bincount(ref.ravel())
        sizes[0] = 0
        if out["regions_after"][1] != k or not np.array_equal(
                _host(out["largest_after"]), ref == int(np.argmax(sizes))):
            raise AssertionError("the edited mask's parts differ from scipy's")
        island_size = int(sizes[ref[island]])
        log(f"  edited mask: {k} regions (scipy: {k}), largest {int(sizes.max())} voxels")

    # 4. floodfill
    allowed = (slc.matrix >= bone[0]) & (slc.matrix <= bone[1])
    lab = timed("label (bone)", lambda ch: connected.label(allowed, 6, ch))
    seeds = floodfill.seeds_to_mask(slc.matrix.shape, [(c, c, shell_x)], device=dev)
    reached = timed("floodfill_threshold", lambda ch: floodfill.floodfill_threshold(
        slc.matrix, seeds, bone[0], bone[1], checks=ch))
    out["flood_shell"] = reached
    if not torch.equal(reached, lab == lab[c, c, shell_x]):
        raise AssertionError("floodfill_threshold differs from the shell's label component")
    if oracle:
        want = ndi.binary_dilation(_host(seeds), s6, iterations=-1, mask=_host(allowed))
        if not np.array_equal(_host(reached), want):
            raise AssertionError("floodfill_threshold differs from scipy's iterated dilation")
        log(f"  floodfill_threshold: {int(reached.sum())} voxels, the shell's label "
            "component and scipy's iterated dilation")
    visible_before = int(mask.visible_array().sum())
    part = timed("select_part", lambda ch: connected.select_part(mask.data, island, 6, ch))
    mask.apply(floodfill.apply_fill(mask.data, part, const.MASK_ERASED))
    out["removed"] = mask.data
    drop = visible_before - int(mask.visible_array().sum())
    if oracle and drop != island_size:
        raise AssertionError(f"removing the island dropped {drop} voxels, not {island_size}")
    soft = (c, c, c + round(0.25 * n))
    out["dynamic"] = timed("region_grow_dynamic", lambda ch: floodfill.region_grow_dynamic(
        slc.matrix, soft, 30.0, 30.0, checks=ch))
    out["confidence"] = timed("region_grow_confidence",
                              lambda ch: floodfill.region_grow_confidence(
                                  slc.matrix, soft, 2.5, 3, checks=ch))
    if not (out["dynamic"][soft] and out["confidence"][soft]):
        raise AssertionError("a region grow from the soft-tissue seed is empty")
    if oracle:
        log(f"  island removed: visible count fell by {drop} (its size); region grow "
            f"dynamic {int(out['dynamic'].sum())}, confidence "
            f"{int(out['confidence'].sum())} voxels")

    # 5. filters and the mask area
    axes = [const.AXIAL, const.CORONAL, const.SAGITTAL]
    for i, (ft, fname) in enumerate(sorted(const.FILTER_NAMES.items())):
        for dim, orient in (("3D", const.AXIAL), ("2D", axes[i % 3])):
            def run(ch, ft=ft, dim=dim, orient=orient):
                slc.select_image_version("original")
                slc.apply_image_filter(ft, 1.0, dim, orient)
                return slc.matrix
            name = f"{fname} {dim}" + (f" {orient}" if dim == "2D" else "")
            img = timed(name, run)
            if img.shape != slc.image_versions[0][1].shape or img.dtype != torch.int16:
                raise AssertionError(f"{name}: {tuple(img.shape)} {img.dtype}")
            out[name] = img
    slc.select_image_version("original")
    area = timed("calc_mask_area", lambda ch: slc.calc_mask_area(mask))
    out["area"] = area
    if oracle:
        want = _exposed_area(_host(mask.visible_array()), slc.spacing)
        if abs(area - want) > 1e-5 * want:
            raise AssertionError(f"calc_mask_area {area!r}, exposed faces {want!r}")
        log(f"  calc_mask_area {area!r} mm^2, exposed faces in float64 {want!r}")
    return out


def _compare_runs(got: dict, want: dict) -> int:
    """Phase 10's card-against-CPU check: masks, labels and counts equal;
    filtered int16 images within one grey level on at most 0.1% of voxels;
    the area within a relative 1e-5.  Returns the largest image
    difference."""
    worst = 0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float):
            if abs(g - w) > 1e-5 * abs(w):
                raise AssertionError(f"{k}: {g!r} against the CPU's {w!r}")
        elif isinstance(w, tuple):
            if g[1] != w[1] or not np.array_equal(g[0], w[0]):
                raise AssertionError(f"{k}: the labels differ from the CPU's")
        elif k.split()[0] in const.FILTER_NAMES.values():
            d = np.abs(_host(g).astype(np.int64) - _host(w).astype(np.int64))
            worst = max(worst, int(d.max()))
            if d.max() > 1 or (d > 0).mean() > 1e-3:
                raise AssertionError(f"{k}: differs from the CPU's by {int(d.max())}")
        elif not np.array_equal(_host(g), _host(w)):
            raise AssertionError(f"{k}: differs from the CPU's")
    return worst


def mask_editing(dev, n: int = MASK_EDIT_N, small: int = MASK_EDIT_SMALL) -> dict:
    """Phase 10; returns the per-op record of the n^3 run."""
    log(f"[10] the mask-editing path at {n}^3")
    kernels.reset_launches()
    rays.reset_launches()
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    got = edit_sequence(dev, small)
    want = edit_sequence(cpu, small)
    worst = _compare_runs(got, want)
    log(f"  {small}^3 on {dev.type} and on the CPU ({time.perf_counter() - t0:.2f} s): "
        f"{len(want)} results, masks, labels and counts equal; filtered images differ "
        f"by at most {worst}")
    del got, want
    t0 = time.perf_counter()
    log(f"  per op at {n}^3 (wall ms, device synchronised):")
    ops = OpTimes(dev)
    edit_sequence(dev, n, ops, oracle=True)
    launches = {"sweeps": dict(kernels.LAUNCHES),
                "rays": {k: dict(v) for k, v in rays.LAUNCHES.items()}}
    log(f"  phase [10]: {time.perf_counter() - t0:.1f} s at {n}^3 with the host checks; "
        f"kernel launches on this path: {launches} (no kernel lies on it)")
    if any(kernels.LAUNCHES.values()) or any(
            v for per_axis in rays.LAUNCHES.values() for v in per_axis.values()):
        raise AssertionError(f"a hot-path kernel launched on the mask-editing path: {launches}")
    return ops.stats


# ---------------------------------------------------------------------------
# phase 11: the 3D viewer's render and reorientation path
# ---------------------------------------------------------------------------

METHOD_NAMES = {const.INTERP_NEAREST: "nearest", const.INTERP_TRILINEAR: "trilinear",
                const.INTERP_TRICUBIC: "tricubic", const.INTERP_LANCZOS: "lanczos"}
VIEWS = [(0, 0), (180, 0), (90, 0), (-90, 0), (0, 89), (0, -89), (30, 20)]
SW_PRESETS = ["Bone", "Soft + Skin", "MIP"]
GIB_LIMIT = 24.0  # peak device memory allowed for each reslice method and mask_cut


def _oblique(shape, spacing, degrees: float = 20.0) -> np.ndarray:
    """M = T1 R^T T0: a rotation by ``degrees`` about the (1, 1, 1) axis
    through the volume's physical centre, (z, y, x) world order, float32."""
    c = np.array([s * n / 2.0 for s, n in zip(spacing[::-1], shape)])
    h = np.radians(degrees) / 2.0
    R = transforms.quaternion_matrix([np.cos(h)] + [np.sin(h) / np.sqrt(3.0)] * 3)
    return (transforms.translation_matrix(c) @ R.T
            @ transforms.translation_matrix(-c)).astype(np.float32)


def _reslice_oracle(ct, spacing, m, method, idx):
    """Nearest or trilinear samples at the flat output voxels ``idx`` in
    float64 numpy (transforms.rs semantics: cval outside [0, dim-1)), and
    which of them lie within 1e-3 voxel of a boundary that float32
    coordinates may cross (an integer for nearest, the valid range's ends
    for trilinear)."""
    dz, dy, dx = ct.shape
    z, y, x = np.unravel_index(idx, ct.shape)
    sx, sy, sz = spacing
    w = np.stack([z * sz, y * sy, x * sx, np.ones(len(idx))]).astype(np.float64)
    t = m.astype(np.float64) @ w
    cz, cy, cx = t[0] / t[3] / sz, t[1] / t[3] / sy, t[2] / t[3] / sx
    valid = (cz >= 0) & (cz < dz - 1) & (cy >= 0) & (cy < dy - 1) & (cx >= 0) & (cx < dx - 1)
    cs = np.stack([cz, cy, cx])
    if method == const.INTERP_NEAREST:
        near = (np.abs(cs - np.round(cs)) < 1e-3).any(0)
    else:
        dims = np.array([dz, dy, dx])[:, None]
        near = ((np.abs(cs) < 1e-3) | (np.abs(cs - (dims - 1)) < 1e-3)).any(0)
    cz, cy, cx = (np.where(valid, c, 0.0) for c in (cz, cy, cx))
    v = ct.astype(np.float64)
    if method == const.INTERP_NEAREST:
        out = v[cz.astype(int), cy.astype(int), cx.astype(int)]
    else:
        z0, y0, x0 = (np.floor(c).astype(int) for c in (cz, cy, cx))
        fz, fy, fx = cz - z0, cy - y0, cx - x0
        out = 0.0
        for oz in (0, 1):
            for oy in (0, 1):
                for ox in (0, 1):
                    wgt = ((fz if oz else 1 - fz) * (fy if oy else 1 - fy)
                           * (fx if ox else 1 - fx))
                    out = out + wgt * v[np.minimum(z0 + oz, dz - 1), np.minimum(y0 + oy, dy - 1),
                                        np.minimum(x0 + ox, dx - 1)]
        out = np.round(out)
    return np.where(valid, out, float(ct.min())), near


def _cut_oracle(mask, spacing, depth, poly, m, mv, edit_mode, z0, z1) -> np.ndarray:
    """The mask cut of the planes z0..z1 in float64 numpy (mask_cut.rs)."""
    Z, Y, X = mask.shape
    sx, sy, sz = spacing
    zz, yy, xx = np.meshgrid(np.arange(z0, z1) * sz, np.arange(Y) * sy, np.arange(X) * sx,
                             indexing="ij")
    p = np.stack([xx, yy, zz, np.ones_like(xx)]).reshape(4, -1)
    q = m.astype(np.float64) @ p
    c = mv.astype(np.float64) @ p
    front = q[3] > 0
    qw = np.where(front, q[3], 1.0)
    cw = np.where(c[3] == 0, 1.0, c[3])
    dist = np.sqrt(((c[:3] / cw) ** 2).sum(0))
    h, w = poly.shape
    px = (q[0] / qw / 2.0 + 0.5) * (w - 1)
    py = (q[1] / qw / 2.0 + 0.5) * (h - 1)
    on = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    inside = poly[np.clip(py.astype(int), 0, h - 1), np.clip(px.astype(int), 0, w - 1)]
    cut = front & (dist <= depth) & np.where(on, inside, edit_mode == 0)
    part = mask[z0:z1].reshape(-1)
    return np.where((part > 127) & cut, 0, part).reshape(z1 - z0, Y, X)


def _scene_matrices(shape, spacing, az, el, size):
    """(projection, model-view) framing the volume's bounds in the 3D scene,
    built as the viewer server's /api/mask/cut3d builds them."""
    Zs, Ys, Xs = shape
    pts = np.array([[0, 0, 0], [Xs * spacing[0], Ys * spacing[1], Zs * spacing[2]]],
                   np.float32)
    center = (pts.min(0) + pts.max(0)) / 2.0
    vm = render_mesh.view_matrix(az, el)
    proj = (pts - center) @ vm.T
    extent = float(np.abs(proj[:, :2]).max()) * 2.1 + 1e-3
    scale = size / extent
    a = 2.0 * scale / (size - 1)
    b = size / (size - 1.0) - 1.0
    mproj = np.zeros((4, 4), np.float32)
    mproj[0, :3] = a * vm[0]
    mproj[0, 3] = -a * float(vm[0] @ center) + b
    mproj[1, :3] = -a * vm[1]
    mproj[1, 3] = a * float(vm[1] @ center) + b
    mproj[3, 3] = 1.0
    eye = center - vm[2] * extent
    mv = np.eye(4, dtype=np.float32)
    mv[:3, :3] = vm
    mv[:3, 3] = -(vm @ eye)
    return mproj, mv


def _lit(img) -> float:
    return float((np.asarray(img) != np.array([17, 19, 24])).any(-1).mean())


def _frames_close(name, got, want) -> float:
    d = np.abs(_host(got).astype(np.int64) - _host(want).astype(np.int64))
    if d.mean() > 0.1 or (d > 2).mean() > 1e-3:
        raise AssertionError(f"{name}: frames differ by mean {d.mean()}, "
                             f"{(d > 2).mean()} of pixels by more than 2")
    return float(d.mean())


def _sw_frames(slc, dev, image, views, reps, ops=None) -> dict:
    """Shear-warp frames per preset, (image, downsample) and view: the cold
    frame (its cache entries dropped first) and the median of ``reps`` warm
    frames, the cache's entries and the peak memory."""
    out, rows = {}, []
    for name in SW_PRESETS:
        preset = raycast.builtin_preset(name)
        for size, ds in ((image, 1), (image // 2, 2)):
            for az, el in views:
                raycast.drop_shear_cache(slc.matrix)
                _sync(dev)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                times = []
                for _ in range(1 + reps):
                    t0 = time.perf_counter()
                    img = raycast.shear_warp_render(slc.matrix, slc.spacing, preset, az, el,
                                                    image_size=size, downsample=ds)
                    times.append((time.perf_counter() - t0) * 1e3)
                if img.shape != (size, size, 3) or img.dtype != np.uint8:
                    raise AssertionError(f"shear-warp {name}: {img.shape} {img.dtype}")
                out[f"shear_warp {name} {size}/{ds} {az},{el}"] = img
                peak = (torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda"
                        else None)
                rows.append((name, size, ds, az, el, times[0],
                             float(np.median(times[1:])) if reps else None,
                             len(raycast._VOLP_CACHE), peak,
                             float((img.astype(np.int64).sum(-1) > 0).mean())))
    if ops is not None:
        log("    shear_warp_render: preset, image/downsample, (az, el): cold ms, warm "
            "median ms, cache entries, peak GiB, share of non-black pixels")
        for r in rows:
            log(f"      {r[0]:12s} {r[1]}/{r[2]} ({r[3]:4d},{r[4]:3d}): {r[5]:9.2f} "
                f"{r[6]:9.2f} {r[7]:3d} " + (f"{r[8]:.2f}" if r[8] is not None else "n/a")
                + f" {r[9]:.3f}")
            ops.stats[f"shear_warp {r[0]} {r[1]}/{r[2]} {r[3]},{r[4]}"] = {
                "ms": r[6], "first_ms": r[5], "checks": [r[7]], "peak_gib": r[8]}
    raycast.drop_shear_cache(slc.matrix)
    return out


def viewer_sequence(dev, n: int, timed=_untimed, oracle: bool = False,
                    surf_n: int = 128, views=VIEWS, reps: int = 0, ops=None) -> dict:
    """Phase 11's calls on a Slice of ``make_ct(n)`` on ``dev``, as the
    viewer server's endpoints make them (/api/image/reorient, /api/render,
    /api/render_scene, /api/surface/remove_non_visible, /api/mask/cut3d).
    ``timed(name, fn)`` runs each op; ``oracle`` holds the results to numpy
    oracles on the host.  Returns every result by name."""
    out = {}
    ct = pipeline.make_ct(n)
    spacing = pipeline.SPACING
    slc = Slice(Volume.from_numpy(ct, spacing=spacing, device=dev))
    bone = const.THRESHOLD_PRESETS_CT["Bone"]
    image = n
    shape = ct.shape

    # 1. oblique reslicing, each method
    m20 = _oblique(shape, spacing)
    cval = float(ct.min())
    rs = np.random.default_rng(0)
    idx = rs.integers(0, ct.size, 10_000)
    for method, mname in METHOD_NAMES.items():
        res = timed(f"apply_view_matrix_transform[{mname}]",
                    lambda ch, method=method: reslice.apply_view_matrix_transform(
                        slc.matrix, spacing, m20, 0, "AXIAL", method, cval, shape))
        out[f"reslice {mname}"] = res
        if ops is not None and (ops.stats[f"apply_view_matrix_transform[{mname}]"][
                "peak_gib"] or 0.0) > GIB_LIMIT:
            raise AssertionError(f"reslice {mname}: peak memory over {GIB_LIMIT} GiB")
        if oracle and method in (const.INTERP_NEAREST, const.INTERP_TRILINEAR):
            want, near = _reslice_oracle(ct, spacing, m20, method, idx)
            d = np.abs(_host(res).reshape(-1)[idx].astype(np.float64) - want)
            tol = 0 if method == const.INTERP_NEAREST else 1
            if (d[~near] > tol).any() or near.mean() > 1e-2:
                raise AssertionError(f"reslice {mname}: {int((d[~near] > tol).sum())} sampled "
                                     f"voxels off the float64 oracle by more than {tol}")
            log(f"  reslice {mname}: {len(idx)} sampled voxels within {tol} of the float64 "
                f"oracle but for {int((d > tol).sum())} of the {int(near.sum())} within 1e-3 "
                "voxel of a boundary")
        ident = reslice.apply_view_matrix_transform(
            slc.matrix, spacing, np.eye(4), n // 2, "AXIAL", method, cval,
            (min(32, n // 2 - 1), n, n))
        k = ident.shape[0]
        if not torch.equal(ident[:, :-1, :-1], slc.matrix[n // 2:n // 2 + k, :-1, :-1]):
            raise AssertionError(f"reslice {mname}: the identity changed the interior")
    del res, ident

    # 2. reorientation with an edited and an unedited mask
    mask = slc.create_new_mask(threshold_range=bone)
    mask.colour = (1.0, 0.3, 0.3)  # not the index's colour: runs compare frames
    ball = morphology.brush_element(2.0 * spacing[0], spacing, const.BRUSH_CIRCLE)
    c = n // 2
    stroke = np.array([(c, c, c + k) for k in range(-n // 8, n // 8)], np.int32)
    mask.apply(morphology.paint_brush_trajectory(mask.data, ball, stroke, 254, ball.shape))
    soft = slc.create_new_mask(threshold_range=(-100, 200), show=False)
    edited_before = mask.data.clone()
    angles = (0.2, -0.1, 0.35)
    timed("apply_reorientation", lambda ch: slc.apply_reorientation(angles=angles),
          repeat=False)
    out["reoriented"] = slc.matrix
    out["reoriented bone mask"] = mask.data
    out["reoriented soft mask"] = soft.data
    if not torch.equal(soft.data, thr_ops.threshold_new_mask(slc.matrix, -100, 200)):
        raise AssertionError("the unedited mask is not the threshold of the new matrix")
    if mask.history._undo or soft.history._undo:
        raise AssertionError("apply_reorientation kept a mask's history")
    if oracle:
        ax, ay, az = angles
        q = transforms.quaternion_from_matrix(transforms.euler_matrix(az, ay, ax, axes="sxyz"))
        cz, cy, cx = (s * k / 2.0 for s, k in zip(spacing[::-1], shape))
        M = (transforms.translation_matrix((cz, cy, cx)) @ transforms.quaternion_matrix(q).T
             @ transforms.translation_matrix((-cz, -cy, -cx))).astype(np.float32)
        want = reslice.apply_view_matrix_transform(edited_before, spacing, M, 0, "AXIAL",
                                                   const.INTERP_NEAREST, 0.0, shape)
        if not torch.equal(mask.data, want):
            raise AssertionError("the edited mask is not its nearest resample")
        painted = int((mask.data == 254).sum())
        log(f"  reorientation: the edited mask is its nearest resample ({painted} painted "
            "voxels), the unedited mask the threshold of the new matrix")
    del edited_before

    # 3. resize
    half = (n // 2,) * 3
    for order in (0, 1):
        r = timed(f"resize_volume[order={order}]",
                  lambda ch, order=order: resize.resize_volume(slc.matrix, half, order))
        out[f"resize {order}"] = r
        if r.shape != half or r.dtype != slc.matrix.dtype:
            raise AssertionError(f"resize order {order}: {tuple(r.shape)} {r.dtype}")
    if oracle:
        ax = resize._axis_coords(n, n // 2, "cpu").numpy()
        ii = np.round(ax).astype(int)
        want = _host(slc.matrix)[np.ix_(ii, ii, ii)]
        if not np.array_equal(_host(out["resize 0"]), want):
            raise AssertionError("resize order 0 differs from its index selection")
    r3 = timed("resize_by_spacing_scale(3)",
               lambda ch: resize.resize_by_spacing_scale(slc.matrix, 3))
    out["resize scale 3"] = r3
    if r3.shape != tuple(max(2, s // 3) for s in shape):
        raise AssertionError(f"resize_by_spacing_scale: {tuple(r3.shape)}")

    # 4. shear-warp frames
    out.update(_sw_frames(slc, dev, image, views, reps, ops))
    if oracle:
        for name in SW_PRESETS:
            # JAX's test_shear_warp_matches_gather_raycast bound (mean 0.03,
            # 99th percentile 0.3) for Bone.  The two integrations differ
            # by more for the others, in the JAX package as here (make_ct at
            # 64^3 and 128^3, unshaded, (30, 20): Soft + Skin mean 0.038, its
            # thin translucent skin; MIP mean 0.114, the shear-warp's warp
            # maps rays outside the volume to value 0, the raycaster to
            # lut_min), so those are held to that agreement with a margin.
            bound = {"Bone": 0.03, "Soft + Skin": 0.045, "MIP": 0.13}[name]
            p = dataclasses.replace(raycast.builtin_preset(name), use_shading=False)
            size = max(64, image // 2)
            sw = raycast.shear_warp_render(slc.matrix, spacing, p, 30, 20, image_size=size)
            gt = raycast.render(slc.matrix, spacing, p, 30, 20, image_size=size,
                                n_steps=2 * n)
            d = np.abs(sw.astype(np.float32) - gt.astype(np.float32)) / 255.0
            log(f"  shear-warp {name} (unshaded) against the gather raycaster at {size}: "
                f"mean {d.mean():.5f}, 99th percentile {np.percentile(d, 99):.5f}")
            if d.mean() >= bound or np.percentile(d, 99) >= 0.3:
                raise AssertionError(f"shear-warp {name} differs from the gather raycaster")
        raycast.drop_shear_cache(slc.matrix)

    # 5. the gather raycaster
    plane = np.array([1.0, 0.0, 0.0, -(n // 2)], np.float32)
    for key, name, crop in (("render Bone", "Bone", None), ("render MIP", "MIP", None),
                            ("render Bone crop", "Bone", plane)):
        img = timed(key, lambda ch, name=name, crop=crop: raycast.render(
            slc.matrix, spacing, raycast.builtin_preset(name), 30, 20, image_size=image,
            n_steps=n // 2, crop_plane=crop))
        out[key] = img
        if img.shape != (image, image, 3) or not img.any():
            raise AssertionError(f"{key}: {img.shape}, lit {img.any()}")
    if out["render Bone crop"].astype(np.int64).sum() >= out["render Bone"].astype(np.int64).sum():
        raise AssertionError("the crop plane did not take anything away")

    # 6. the mask preview
    out["mask preview"] = timed("render_mask_preview", lambda ch: raycast.render_mask_preview(
        mask.data, spacing, azimuth=30, elevation=20))
    if not out["mask preview"].any():
        raise AssertionError("the mask preview is empty")
    raycast.drop_shear_cache(mask.data)

    # 7. surfaces: the Bone surface of make_ct(surf_n) at the card's size
    bone_ct = pipeline.make_ct(surf_n) if surf_n != n else ct
    sslc = Slice(Volume.from_numpy(bone_ct, spacing=spacing, device=dev))
    surf = sslc.create_surface_from_mask(sslc.create_new_mask(threshold_range=bone))
    del sslc
    v, f = surf.vertices, surf.faces
    size = min(512, max(64, 2 * n))
    base = (v, f, (0.9, 0.85, 0.75))
    for key, kw in (("render_surfaces", {}), ("render_surfaces ssao", {"ssao": True}),
                    ("render_surfaces alpha 0.5", {})):
        meshes = [base + (0.5,)] if "alpha" in key else [base]
        img = timed(key, lambda ch, meshes=meshes, kw=kw: render_mesh.render_surfaces(
            meshes, 30, 20, size=size, max_triangles=len(f) + 1, device=dev, **kw))
        out[key] = img
        if not 0.05 < _lit(img) < 0.95:
            raise AssertionError(f"{key}: lit share {_lit(img)}")
    centre = (v.min(0) + v.max(0)) / 2.0
    ext = float(np.ptp(v, axis=0).max())

    class _Marker:
        position = tuple(centre + np.array([0.0, 0.0, 0.45 * ext]))
        colour = (1.0, 0.2, 0.2)

    t = np.linspace(0, 4 * np.pi, 80)
    tract = centre + ext * np.stack([0.2 * np.cos(t), 0.2 * np.sin(t), 0.03 * t], 1)
    plane_mesh = render_mesh.slice_plane_mesh(slc, const.AXIAL, n // 2)
    scene_surf = Surface(vertices=v, faces=f, index=0, colour=(0.9, 0.85, 0.75))
    out["render_scene"] = timed("render_scene", lambda ch: render_mesh.render_scene(
        [scene_surf], markers=[_Marker()],
        probe_pose=tuple(centre + [0.6 * ext, 0, 0]) + (0, 90, 0),
        coil_poses=[tuple(centre + [0, -0.6 * ext, 0]) + (90, 0, 0)],
        streamlines=[(tract, (1.0, 0.9, 0.1))], slice_plane=plane_mesh, size=size,
        max_triangles=len(f) + 1, robot_force=2.0, device=dev))
    if _lit(out["render_scene"]) < 0.05 or np.array_equal(out["render_scene"],
                                                          out["render_surfaces"]):
        raise AssertionError("render_scene drew no scene")
    vk, fk, ratio = timed("remove_non_visible_faces",
                          lambda ch: render_mesh.remove_non_visible_faces(v, f, size=size,
                                                                          device=dev))
    out["remove_non_visible_faces"] = (len(fk), ratio)
    if not (0.0 < ratio < 1.0 and len(fk) < len(f) and len(vk) <= len(v)):
        raise AssertionError(f"remove_non_visible_faces kept {len(fk)} of {len(f)}")
    log(f"  surface of make_ct({surf_n}): {len(f)} triangles; remove_non_visible_faces keeps "
        f"{len(fk)} ({ratio:.4f})")
    small_ct = pipeline.make_ct(max(24, surf_n // 4))
    ss = Slice(Volume.from_numpy(small_ct, spacing=spacing, device=dev))
    s2 = ss.create_surface_from_mask(ss.create_new_mask(threshold_range=bone))
    # the default max_triangles where the surface is above it, else half
    kw = {} if len(s2.faces) > 200_000 else {"max_triangles": len(s2.faces) // 2}
    out["render_surfaces decimated"] = timed(
        "render_surfaces (decimating)", lambda ch: render_mesh.render_surfaces(
            [(s2.vertices, s2.faces, (0.9, 0.85, 0.75))], 30, 20, size=size, device=dev,
            **kw))
    log(f"  decimating path: {len(s2.faces)} triangles of make_ct({small_ct.shape[0]}) to "
        f"{kw.get('max_triangles', 200_000)}")
    del surf, v, f, s2, ss

    # 8. the 3D mask cut
    msize = min(512, 2 * n)
    mproj, mv = _scene_matrices(shape, spacing, 30, 20, msize)
    poly = [(0.2 * msize, 0.25 * msize), (0.8 * msize, 0.3 * msize),
            (0.6 * msize, 0.85 * msize), (0.15 * msize, 0.6 * msize)]
    pm = timed("polygon2mask", lambda ch: rasterize.polygon2mask((msize, msize), poly,
                                                                 device=dev)).t()
    out["polygon2mask"] = pm
    visible = mask.visible_array()
    for mode, mname in ((0, "include"), (1, "exclude")):
        for depth in (1e9, 0.6 * n * spacing[0] * 3):
            key = f"mask_cut[{mname}]" + ("" if depth == 1e9 else " depth")
            cut = timed(key, lambda ch, mode=mode, depth=depth: rasterize.mask_cut(
                mask.data, spacing, depth, pm, mproj, mv, mode))
            out[key] = cut
            if ops is not None and (ops.stats[key]["peak_gib"] or 0.0) > GIB_LIMIT:
                raise AssertionError(f"{key}: peak memory over {GIB_LIMIT} GiB")
            zeroed = cut != mask.data
            if not bool(zeroed.any()) or bool((zeroed & ~visible).any()) or bool(
                    (cut[zeroed] != 0).any()):
                raise AssertionError(f"{key}: it zeroed nothing or more than visible voxels")
            if oracle:
                z0 = n // 2 - 8
                want = _cut_oracle(_host(mask.data), spacing, depth, _host(pm), mproj, mv,
                                   mode, z0, z0 + 16)
                bad = (_host(cut[z0:z0 + 16]) != want).mean()
                if bad > 1e-4:
                    raise AssertionError(f"{key}: {bad} of the slab differs from the oracle")
                log(f"  {key}: {int(zeroed.sum())} voxels cut; the oracle slab differs on "
                    f"{bad:.2e} of its voxels")
    del slc, mask, visible
    return out


def _compare_viewer(got: dict, want: dict) -> None:
    """Phase 11's card-against-CPU check within the CPU tests' bounds."""
    for k, w in want.items():
        g = got[k]
        if k.startswith(("shear_warp", "render ", "mask preview")):
            _frames_close(k, g, w)
        elif k.startswith(("render_surfaces", "render_scene")):
            frac = (np.asarray(g) != np.asarray(w)).any(-1).mean()
            if frac > 5e-3:
                raise AssertionError(f"{k}: {frac} of the pixels differ from the CPU's")
        elif k == "remove_non_visible_faces":
            if abs(g[0] - w[0]) > 1e-3 * max(w[0], 1):
                raise AssertionError(f"{k}: kept {g[0]} faces, the CPU {w[0]}")
        elif k.startswith("mask_cut"):
            if (_host(g) != _host(w)).mean() > 1e-4:
                raise AssertionError(f"{k}: differs from the CPU's")
        elif k.startswith(("reslice nearest", "reoriented bone", "resize 0", "polygon2mask")):
            if not np.array_equal(_host(g), _host(w)):
                raise AssertionError(f"{k}: differs from the CPU's")
        else:  # integer resampling, and the masks thresholded from it
            d = np.abs(_host(g).astype(np.int64) - _host(w).astype(np.int64))
            lim = 255 if k == "reoriented soft mask" else 1
            if d.max() > lim or (d > 0).mean() > 1e-2:
                raise AssertionError(f"{k}: differs from the CPU's by {int(d.max())} on "
                                     f"{(d > 0).mean()} of the voxels")


def viewer_3d(dev, n: int = VIEWER_N, small: int = VIEWER_SMALL, surf_n: int = VIEWER_N) -> dict:
    """Phase 11; returns the per-op record of the n^3 run."""
    log(f"[11] the 3D viewer's render and reorientation path at {n}^3")
    if dev.type == "cuda":
        log("  card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    kernels.reset_launches()
    rays.reset_launches()
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    views = [(30, 20), (0, 89), (-90, 0)]
    got = viewer_sequence(dev, small, surf_n=small, views=views)
    want = viewer_sequence(cpu, small, surf_n=small, views=views)
    _compare_viewer(got, want)
    log(f"  {small}^3 on {dev.type} and on the CPU ({time.perf_counter() - t0:.2f} s): "
        f"{len(want)} results within the CPU tests' bounds")
    del got, want
    t0 = time.perf_counter()
    log(f"  per op at {n}^3 (wall ms, device synchronised):")
    ops = OpTimes(dev)
    viewer_sequence(dev, n, ops, oracle=True, surf_n=surf_n, reps=5, ops=ops)
    launches = {"sweeps": dict(kernels.LAUNCHES),
                "rays": {k: dict(v) for k, v in rays.LAUNCHES.items()}}
    log(f"  phase [11]: {time.perf_counter() - t0:.1f} s at {n}^3 with the host checks; "
        f"kernel launches on this path: {launches} (no kernel lies on it)")
    if any(kernels.LAUNCHES.values()) or any(
            v for per_axis in rays.LAUNCHES.values() for v in per_axis.values()):
        raise AssertionError(f"a hot-path kernel launched on the 3D viewer's path: {launches}")
    return ops.stats


# ---------------------------------------------------------------------------
# phase 12: the deep-learning segmentation family
# ---------------------------------------------------------------------------

MODELS_CT_N = 512  # the CT side of phase 12: trachea, mandible (half), implant
MODELS_MRI_N = 256  # its MRI side: brain, FastSurfer at conform 256
BF16_DENSE_TFLOPS = 989.0  # an H100 SXM's dense bf16 tensor-core rate (data sheet, 700 W)
MODEL_ATOL = 2e-2  # the CPU tests' bound on bfloat16 probabilities
# FastSurfer at 64 filters with random weights is chaotic: a 2x2 pooling
# index flips between near-tied bfloat16 values when the convolutions sum
# in another order, and moves the sums near it.  On the CPU alone, summing
# the convolutions in float64 in place of oneDNN's order moved the sums of
# a 64^3 run by up to 7.6% of the largest |sum| (99% of them within 0.44%)
# and changed 0.23% of the labels whose top two differ by more than 0.2%.
# So the card is held to the CPU by the 99th percentile of the sums'
# difference (1% of the largest |sum|) and by the labels on those voxels
# (99% equal).
FS_MARGIN, FS_Q99, FS_SAME = 2e-3, 1e-2, 0.99


def unet3d_flops(p: int, f: int = 8) -> int:
    """Operations (2 a multiply-add) of one p^3 patch through ``Unet3D(f)``:
    the 5^3 convolutions of the nine blocks, the k=4 s=2 up-convolutions
    (4^3 multiply-adds an input voxel and channel pair) and the 1x1 head."""
    n, ops, cin = p ** 3, 0, 1
    for c in (f, 2 * f, 4 * f, 8 * f):
        ops += 2 * 125 * n * (cin * c + c * c)
        cin, n = c, n // 8
    ops += 2 * 125 * n * (cin * 16 * f + (16 * f) ** 2)
    cin = 16 * f
    for c in (8 * f, 4 * f, 2 * f, f):
        ops += 2 * 64 * n * cin * c
        n *= 8
        ops += 2 * 125 * n * (2 * c * c + c * c)
        cin = c
    return ops + 2 * n * f


def unet2d_flops(p: int, f: int = 16) -> int:
    """Operations of one p^2 patch through ``Unet2D(f)``."""
    n = p * p
    return (2 * 9 * n * f + 2 * 9 * (n // 4) * f * 2 * f + 2 * 9 * (n // 16) * 2 * f * 4 * f
            + 2 * 4 * (n // 16) * 4 * f * 2 * f + 2 * 9 * (n // 4) * 4 * f * 2 * f
            + 2 * 4 * (n // 4) * 2 * f * f + 2 * 9 * n * 2 * f * f + 2 * n * f)


def fastsurfer_flops(h: int, w: int, classes: int, f: int = 64) -> int:
    """Operations of one h x w slice through ``FastSurferCNN(classes, f)``:
    three 3x3 convolutions a block (enc1's first from 7 channels), nine
    blocks at halving sizes, the 1x1 classifier."""
    n = h * w
    ops = 2 * 9 * n * (fastsurfer.THICK * f + 2 * f * f)
    ops += sum(2 * 9 * (n >> (2 * lv)) * 3 * f * f for lv in (1, 2, 3, 4))
    ops += sum(2 * 9 * (n >> (2 * lv)) * 3 * f * f for lv in (0, 1, 2, 3))
    return ops + 2 * n * f * classes


def random_state(module: torch.nn.Module, seed: int) -> dict:
    """Seeded weights for ``module`` at its width: ``layers.init_state``'s
    draw, then each batch norm's scale, bias and running statistics drawn
    too, so the norms do work."""
    g = torch.Generator().manual_seed(seed)
    state = mlayers.init_state(module, g)
    for name, m in module.named_modules():
        if isinstance(m, mlayers.BatchNorm):
            n = m.num_features
            state[f"{name}.weight"] = 0.7 + 0.6 * torch.rand(n, generator=g)
            state[f"{name}.bias"] = 0.1 * torch.randn(n, generator=g)
            state[f"{name}.running_mean"] = 0.2 * torch.randn(n, generator=g)
            state[f"{name}.running_var"] = 0.5 + torch.rand(n, generator=g)
    return state


def majority_implant_state(f: int = 16) -> dict:
    """``Unet2D(features=f)`` weights under which the network's mask is the
    3x3 majority vote of its binary input: enc1 passes the bone mask on
    channel 0, dec1 sums it over 3x3 minus 4.5, the head adds -0.25, every
    other weight is 0.  Every value is exact in bfloat16, so no rounding
    order can move a voxel across the threshold (probabilities 0.438 or at
    least 0.562).  (A random 2D U-Net's mask of a CT is speckle whose
    surface would hold some 10^8 triangles.)"""
    state = {k: torch.zeros_like(v) for k, v in unet2d.Unet2D(features=f).state_dict().items()
             if not k.endswith("num_batches_tracked")}
    for b in ("enc1", "enc2", "enc3", "dec2", "dec1"):
        state[f"{b}_norm.weight"] = torch.ones(state[f"{b}_norm.weight"].shape)
        state[f"{b}_norm.running_var"] = torch.ones(state[f"{b}_norm.running_var"].shape)
    state["enc1_conv.weight"][0, 0, 1, 1] = 1.0
    state["dec1_conv.weight"][0, f] = 1.0  # e1's channel 0, after u1's f channels
    state["dec1_conv.bias"][0] = -4.5
    state["conv.weight"][0, 0] = 1.0
    state["conv.bias"][0] = -0.25
    return state


def majority_vote(ct: torch.Tensor) -> torch.Tensor:
    """The uint8 0/255 mask of ``majority_implant_state``'s network on a CT:
    at least 5 of the 3x3 in-plane neighbours >= 300 HU (zero outside)."""
    bone = torch.nn.functional.pad((ct >= 300).to(torch.uint8), (1, 1, 1, 1))
    Y, X = ct.shape[1:]
    votes = sum(bone[:, dy:dy + Y, dx:dx + X] for dy in range(3) for dx in range(3))
    return (votes >= 5).to(torch.uint8) * 255


def _fastsurfer_views() -> dict:
    n_sag = len(fastsurfer.get_labels_from_lut()[1])
    return {"fastsurfer_axial": 79, "fastsurfer_coronal": 79, "fastsurfer_sagittal": n_sag}


def write_checkpoints(root: Path) -> dict:
    """Every phase-12 checkpoint under ``root`` (the models dir) at the
    published widths, under the reference key names: brain and trachea as
    eager state dicts, mandible and cranioplasty as TorchScript archives (as
    published), the FastSurfer views as ONNX initializer graphs.  Returns
    {registry name: the state written}."""
    made = {"brain_mri_t1": random_state(unet3d.Unet3D(), 1),
            "trachea_ct": random_state(unet3d.Unet3D(), 2),
            "mandible_jit_ct": random_state(unet3d.Unet3D(), 3),
            "cranioplasty_jit_ct_binary": majority_implant_state()}
    for i, (name, classes) in enumerate(_fastsurfer_views().items()):
        made[name] = random_state(fastsurfer.FastSurferCNN(num_classes=classes), 4 + i)
    for name, state in made.items():
        path = root / name / download.WEIGHT_REGISTRY[name]["filename"]
        path.parent.mkdir(parents=True, exist_ok=True)
        if name.startswith("fastsurfer"):
            onnx_convert.write_onnx(path, {k: v.numpy() for k, v in state.items()})
        elif "_jit_" in name:
            net = unet3d.Unet3D() if name.startswith("mandible") else unet2d.Unet2D()
            net.load_state_dict(state)
            example = torch.zeros((1, 1) + (16,) * (3 if name.startswith("mandible") else 2))
            torch.jit.save(torch.jit.trace(net.eval(), example), str(path))
        else:
            torch.save(state, path)
    return made


def _no_download(url, *a, **kw):
    raise OSError(f"phase 12 reads its checkpoints from disk; no download of {url}")


def _same_state(name: str, got: dict, want: dict) -> None:
    if sorted(got) != sorted(want) or not all(
            np.array_equal(np.asarray(got[k]), want[k].numpy()) for k in want):
        raise AssertionError(f"{name}: the resolved weights differ from those written")


def _mri(n: int) -> np.ndarray:
    """A synthetic int16 T1 head of side n: a bright ellipsoidal brain with
    darker ventricles inside a dim skull, noise from seed 0."""
    c = (np.arange(n, dtype=np.float32) - n / 2.0) / (n / 2.0)
    zz, yy, xx = c[:, None, None], c[None, :, None], c[None, None, :]
    r = np.sqrt(zz ** 2 + (yy / 0.85) ** 2 + (xx / 0.75) ** 2)
    vol = np.where(r < 0.9, 300.0, 20.0) + np.where(r < 0.75, 500.0, 0.0)
    vol -= np.where((np.abs(xx) < 0.12) & (np.abs(yy) < 0.3) & (np.abs(zz) < 0.2), 450.0, 0.0)
    rng = np.random.default_rng(0)
    return (vol + rng.normal(0.0, 25.0, vol.shape)).astype(np.int16)


def _prob_checks(name: str, prob: np.ndarray, mask: np.ndarray, shape) -> None:
    """The JAX package's result types, probabilities in [0, 1], the mask
    their threshold at 0.5."""
    if prob.shape != tuple(shape) or prob.dtype != np.float32 or mask.dtype != np.uint8 \
            or mask.shape != prob.shape:
        raise AssertionError(f"{name}: {prob.shape} {prob.dtype}, {mask.shape} {mask.dtype}")
    if not np.isfinite(prob).all() or prob.min() < 0.0 or prob.max() > 1.0:
        raise AssertionError(f"{name}: probabilities outside [0, 1]")
    if not np.array_equal(mask, np.where(prob >= 0.5, 255, 0).astype(np.uint8)):
        raise AssertionError(f"{name}: the mask is not prob >= 0.5")


def _agree(name: str, got, want) -> str:
    """Card against CPU within the CPU tests' bounds: probabilities within
    MODEL_ATOL, masks equal where both lie farther than it from the
    threshold, 0.5."""
    (p, m), (pw, mw) = got, want
    err = float(np.abs(p - pw).max())
    far = (np.abs(p - 0.5) > MODEL_ATOL) & (np.abs(pw - 0.5) > MODEL_ATOL)
    if err > MODEL_ATOL or not np.array_equal(m[far], mw[far]):
        raise AssertionError(f"{name}: card against CPU: max |dp| {err}, masks differ on "
                             f"{int((m[far] != mw[far]).sum())} voxels")
    return f"{name}: max |dp| {err:.2e}, masks equal on {far.mean():.1%} of voxels"


def _owned(starts, p: int, start: int, n: int) -> np.ndarray:
    """Along one axis, which positions of the patch at ``start`` it writes
    last (no later start covers them), cut to the axis length n."""
    pos = start + np.arange(min(p, n - start))
    own = np.ones(len(pos), bool)
    for s in starts[starts.index(start) + 1:]:
        own &= ~((pos >= s) & (pos < s + p))
    return own


def _axis_starts(n: int, p: int, overlap: float = 0.5):
    return sorted({o[0] for o in segment.patch_grid((n, p, p), p, overlap)})


def patch_oracle(name: str, seg, image: np.ndarray, prob: np.ndarray) -> float:
    """Eight patches of a 3D segmenter's grid (the first, the last, a
    clamped border patch, five drawn from seed 0) each run alone through the
    model: they must match the assembled volume within MODEL_ATOL on the
    voxels each writes last.  Returns the largest difference."""
    p = seg.patch_size
    norm = seg.normalized(image)
    shape = tuple(norm.shape)
    origins = segment.patch_grid(shape, p, seg.overlap)
    starts = [_axis_starts(n, p, seg.overlap) for n in shape]
    # a patch whose x start was clamped to end at the border
    clamped = next((i for i, o in enumerate(origins)
                    if o[2] == starts[2][-1] and o[2] % (p - int(p * seg.overlap))),
                   len(origins) - 1)
    rng = np.random.default_rng(0)
    picks = [0, len(origins) - 1, clamped] + list(rng.choice(len(origins), min(5, len(origins)), replace=False))
    worst = 0.0
    for i in picks:
        o = origins[i]
        alone = seg.apply(segment.gather_patches(
            norm, torch.tensor([o], device=norm.device), p))[0].cpu().numpy()
        own = [_owned(starts[a], p, o[a], image.shape[a]) for a in range(3)]
        sel = np.ix_(*own)
        region = prob[tuple(slice(o[a], o[a] + p) for a in range(3))]
        if region[sel].size:
            worst = max(worst, float(np.abs(alone[:region.shape[0], :region.shape[1],
                                                  :region.shape[2]][sel] - region[sel]).max()))
    if worst > MODEL_ATOL:
        raise AssertionError(f"{name}: a patch alone differs from the volume by {worst}")
    return worst


class ModelTimes:
    """Phase 12's record per call: wall seconds first and warm (device
    synchronised), peak device memory, items (patches or slices) a second,
    achieved TFLOP/s and the share of the dense bf16 peak."""

    def __init__(self, dev):
        self.dev = dev
        self.rows = {}

    def __call__(self, name: str, fn, items: int, flops: int):
        times = []
        for _ in range(2):
            _sync(self.dev)
            if self.dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn()
            _sync(self.dev)
            times.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() / 2**30 if self.dev.type == "cuda"
                else None)
        warm = times[-1]
        tflops = flops / warm / 1e12
        self.rows[name] = {"first_s": times[0], "warm_s": warm, "peak_gib": peak,
                           "items": items, "items_per_s": items / warm, "tflop": flops / 1e12,
                           "tflops": tflops, "bf16_share": tflops / BF16_DENSE_TFLOPS}
        log(f"    {name}: first {times[0]:.3f} s, warm {warm:.3f} s; peak "
            + (f"{peak:.2f} GiB" if peak is not None else "n/a")
            + f"; {items} items, {items / warm:.1f}/s; {flops / 1e12:.2f} TFLOP, "
            f"{tflops:.2f} TFLOP/s, {tflops / BF16_DENSE_TFLOPS:.2%} of the bf16 peak")
        return out


def memory_formats(dev, made: dict) -> dict:
    """Each network's batch of 8 at its path's size, NCDHW/NCHW against
    channels-last, ms a batch (5 batches between CUDA events, after 2)."""
    cases = [("Unet3D 48^3", unet3d.Unet3D(dtype=torch.bfloat16), made["brain_mri_t1"],
              (8, 1, 48, 48, 48), torch.channels_last_3d),
             ("Unet3D 96^3", unet3d.Unet3D(dtype=torch.bfloat16), made["mandible_jit_ct"],
              (8, 1, 96, 96, 96), torch.channels_last_3d),
             ("Unet2D 480^2", unet2d.Unet2D(), made["cranioplasty_jit_ct_binary"],
              (8, 1, 480, 480), torch.channels_last),
             ("FastSurferCNN 256^2", fastsurfer.FastSurferCNN(), made["fastsurfer_axial"],
              (8, 7, 256, 256), torch.channels_last)]
    out = {}
    for name, net, state, shape, last in cases:
        x = torch.rand(shape, generator=torch.Generator().manual_seed(0)).to(dev)
        for fmt in (torch.contiguous_format, last):
            model = mlayers.load(net, state, dev, fmt)
            xf = x.contiguous(memory_format=fmt)
            with torch.inference_mode():
                for _ in range(2):
                    model(xf)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                for _ in range(5):
                    model(xf)
                end.record()
                torch.cuda.synchronize()
            out[(name, "channels_last" if fmt is last else "contiguous")] = \
                start.elapsed_time(end) / 5
        log(f"    {name} x8: contiguous {out[(name, 'contiguous')]:.2f} ms, channels-last "
            f"{out[(name, 'channels_last')]:.2f} ms a batch")
    return out


def _fs_slice_check(pipe, vol: torch.Tensor, agg: torch.Tensor, picks) -> float:
    """The sum at the voxels picks^3 from its slices: each view's slices at
    ``picks`` through its network in the batch the pipeline ran them in,
    weighted and added in the pipeline's order, must give the sum bit for
    bit; each slice run alone must match its batched logits (99th
    percentile within FS_Q99 of their largest).  Returns that percentile."""
    logits, worst = {}, 0.0
    bs = pipe.batch_size
    for view, axis in pipe.VIEWS:
        batch = fastsurfer.thick_slices(vol, axis)
        w = torch.tensor(pipe.VIEW_WEIGHTS[view], device=vol.device)
        logits[view] = []
        for i in picks:
            b0 = i // bs * bs
            batched = pipe.plane_logits(batch[b0:b0 + bs], view)[i - b0]
            alone = pipe.plane_logits(batch[i:i + 1], view)[0]
            d = ((alone - batched).abs() / batched.abs().max()).flatten()
            worst = max(worst, float(torch.quantile(d[::max(1, d.numel() // 2**24)], 0.99)))
            logits[view].append(batched * w)
    for a, z in enumerate(picks):
        for b, y in enumerate(picks):
            for c, x in enumerate(picks):
                want = (logits["axial"][a][y, x] + logits["coronal"][b][z, x]) \
                    + logits["sagittal"][c][z, y]
                if not torch.equal(agg[z, y, x], want):
                    raise AssertionError(f"FastSurfer: the sum at {(z, y, x)} is not its "
                                         "slices' weighted logits")
    if worst > FS_Q99:
        raise AssertionError(f"FastSurfer: slices alone differ from their batches by {worst}")
    return worst


def models_phase(dev, tmp: Path, ct_n: int = MODELS_CT_N, mri_n: int = MODELS_MRI_N) -> dict:
    """Phase 12; returns the per-call record of the full-width runs."""
    import os

    log(f"[12] the deep-learning segmentation family: CT {ct_n}^3, MRI {mri_n}^3")
    if dev.type == "cuda":
        log("  card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    os.environ["XDG_CONFIG_HOME"] = str(tmp / "config")  # models dir and the app's session
    download.download_url_to_file = _no_download
    kernels.reset_launches()
    rays.reset_launches()
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    t0 = time.perf_counter()
    made = write_checkpoints(paths.models_dir())
    for name, state in made.items():
        if name.startswith("fastsurfer"):
            continue
        loader = unet2d.load_torch_checkpoint if name.startswith("cranio") else None
        _same_state(name, segment._resolve_weights(name, False, loader), state)
    sub = segment.SubpartSegmenter(device=dev, conform_size=mri_n)  # the three views
    for view, name in zip(("axial", "coronal", "sagittal"), _fastsurfer_views()):
        _same_state(name, sub.variables[view], made[name])
    log(f"  checkpoints written and resolved through the models dir "
        f"({time.perf_counter() - t0:.2f} s): {sorted(made)}")

    ct = pipeline.make_ct(ct_n)
    mri = _mri(mri_n)
    # the card against the CPU at small sizes
    t0 = time.perf_counter()
    runs = {"brain 64^3": (segment.BrainSegmenter, {}, _mri(64)),
            "trachea 64^3": (segment.TracheaSegmenter, {}, pipeline.make_ct(64)),
            "mandible 100x96x96": (segment.MandibleSegmenter, {},
                                   pipeline.make_ct(100)[:, 2:98, 2:98]),
            "implant binary 4x512^2": (segment.ImplantSegmenter,
                                       {"variables": random_state(unet2d.Unet2D(), 7)},
                                       ct[ct_n // 2 - 2: ct_n // 2 + 2]),
            "implant gray 4x512^2": (segment.ImplantSegmenter,
                                     {"variables": random_state(unet2d.Unet2D(), 7),
                                      "method": "gray"}, ct[ct_n // 2 - 2: ct_n // 2 + 2])}
    for name, (cls, kw, img) in runs.items():
        seg = cls(device=dev, **kw)
        got = seg.segment(img)
        want = cls(device=cpu, **kw).segment(img)
        _prob_checks(name, *got, img.shape)
        log("  " + _agree(name, got, want))
        if cls is segment.ImplantSegmenter:
            log(f"    eight patches alone: within {implant_oracle(seg, img, got[0]):.2e} "
                "of the volume")
    small_mri = _mri(64)
    sums = []
    for d in (dev, cpu):
        sp = segment.SubpartSegmenter(device=d, conform_size=64)
        labels, mask = sp.segment(small_mri)
        pipe = fastsurfer.FastSurferPipeline(variables=sp.variables, device=d)
        vol = fastsurfer.conform_tensor(torch.from_numpy(small_mri).to(d), 64)
        sums.append((labels, mask, pipe.aggregate(vol).cpu().numpy()))
    (lg, mg, ag), (lw, mw, aw) = sums
    top2 = np.sort(aw, -1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > FS_MARGIN * np.abs(aw).max()
    d = np.abs(ag - aw) / np.abs(aw).max()
    q99, same = float(np.quantile(d, 0.99)), float((lg[decided] == lw[decided]).mean())
    if q99 > FS_Q99 or same < FS_SAME or not np.array_equal(mg, np.where(lg > 0, 255, 0)):
        raise AssertionError(f"subpart 64^3: card against CPU: sums q99 {q99:.2e}, labels "
                             f"equal on {same:.2%} of the decided voxels")
    log(f"  subpart 64^3 (conform 64): sums within {q99:.2e} of the largest at the 99th "
        f"percentile (max {float(d.max()):.2e}); labels equal on {same:.2%} of the "
        f"{decided.mean():.1%} of voxels whose top two differ by more than {FS_MARGIN:.1%}")
    log(f"  card against CPU: {time.perf_counter() - t0:.1f} s")

    if dev.type == "cuda":
        log("  memory formats (cuDNN's choice):")
        memory_formats(dev, made)

    log(f"  per call at full width (wall s, device synchronised; first, warm):")
    times = ModelTimes(dev)
    brain = segment.BrainSegmenter(device=dev)
    n_brain = len(segment.patch_grid(mri.shape, brain.patch_size))
    prob, mask = times(f"BrainSegmenter {mri_n}^3", lambda: brain.segment(mri), n_brain,
                       n_brain * unet3d_flops(brain.patch_size))
    _prob_checks("brain", prob, mask, mri.shape)
    prob4 = brain.segment(mri, batch_size=4)[0]
    d4 = float(np.abs(prob4 - prob).max())
    if d4 > MODEL_ATOL:
        raise AssertionError(f"brain: batch 4 against batch 8: {d4}")
    log(f"    batch 4 against batch 8: max |dp| {d4:.2e}; eight patches alone: within "
        f"{patch_oracle('brain', brain, mri, prob):.2e} of the volume")
    profile_segmenter(dev, brain, mri)
    del prob, prob4, mask

    for name, seg, img in (
            (f"TracheaSegmenter {ct_n}^3", segment.TracheaSegmenter(device=dev), ct),
            (f"MandibleSegmenter {ct_n // 2}x{ct_n}^2", segment.MandibleSegmenter(device=dev),
             ct[: ct_n // 2])):
        n = len(segment.patch_grid(img.shape, seg.patch_size))
        prob, mask = times(name, lambda: seg.segment(img), n,
                           n * unet3d_flops(seg.patch_size))
        _prob_checks(name, prob, mask, img.shape)
        log(f"    eight patches alone: within {patch_oracle(name, seg, img, prob):.2e} "
            "of the volume")
        del prob, mask

    ct_path = tmp / "ct.nii"
    nifti.write_nifti(ct_path, ct, spacing=pipeline.SPACING)
    stl = tmp / "implant.stl"
    argv = ["--cranioplasty", str(ct_path), str(stl)]
    n_imp = ct_n * len(segment.patch_grid((1, max(ct_n, 480), max(ct_n, 480)), 480))
    times(f"app --cranioplasty {ct_n}^3", lambda: app.main(argv, device=dev), n_imp,
          n_imp * unet2d_flops(480))
    m = Mask()
    m.data = majority_vote(torch.from_numpy(ct).to(dev))
    want = create_surface_from_mask(m, pipeline.SPACING, name="implant")
    if stl.read_bytes()[84:] != mesh_io.stl_records(want.vertices, want.faces).tobytes():
        raise AssertionError("--cranioplasty: the STL is not the majority vote's surface")
    log(f"    the STL read back is the surface of the bone mask's 3x3 majority vote "
        f"({len(want.faces)} triangles)")
    del m, want

    n_fs = 3 * mri_n
    flops = mri_n * (2 * fastsurfer_flops(mri_n, mri_n, 79)
                     + fastsurfer_flops(mri_n, mri_n, _fastsurfer_views()["fastsurfer_sagittal"]))
    labels, mask = times(f"SubpartSegmenter {mri_n}^3 (conform {mri_n})",
                         lambda: sub.segment(mri), n_fs, flops)
    if labels.shape != mri.shape or labels.dtype != np.int32 or mask.dtype != np.uint8 \
            or not np.array_equal(mask, np.where(labels > 0, 255, 0)) \
            or not set(np.unique(labels)) <= set(fastsurfer.class_ids().tolist()):
        raise AssertionError("subpart: labels, ids or mask wrong")
    t0 = time.perf_counter()
    qc = fastsurfer.run_quick_qc(labels, 1.0, device=dev)
    if qc["total_volume_liters"] != float((labels > 0).sum()) / 1e6:
        raise AssertionError(f"quick QC: {qc}")
    parts = segment.structure_masks(labels, ["cortical", "subcortical", "ventricles"])
    for _, pm, lid in parts:
        if not np.array_equal(pm, np.where(labels == lid, 255, 0)):
            raise AssertionError(f"structure_masks: label {lid}")
    log(f"    run_quick_qc and structure_masks: {time.perf_counter() - t0:.2f} s; "
        f"{qc['total_volume_liters']:.3f} l segmented, {len(parts)} structures")
    pipe = fastsurfer.FastSurferPipeline(variables=sub.variables, device=dev)
    vol = fastsurfer.conform_tensor(torch.from_numpy(mri).to(dev), mri_n)
    agg = pipe.aggregate(vol)
    worst = _fs_slice_check(pipe, vol, agg, [0, mri_n // 2 - 1, mri_n - 1])
    log(f"    the sum at 27 voxels rebuilt from three slices a view: bit for bit; each "
        f"slice alone within {worst:.2e} of its batch's largest logit (99th percentile)")
    del agg, vol, pipe

    launches = {"sweeps": dict(kernels.LAUNCHES),
                "rays": {k: dict(v) for k, v in rays.LAUNCHES.items()}}
    log(f"  phase [12]: {time.perf_counter() - t_phase:.1f} s; kernel launches on this "
        f"path: {launches} (no kernel lies on it)")
    if any(kernels.LAUNCHES.values()) or any(
            v for per_axis in rays.LAUNCHES.values() for v in per_axis.values()):
        raise AssertionError(f"a hot-path kernel launched on the models' path: {launches}")
    return times.rows


def implant_oracle(seg, image: np.ndarray, prob: np.ndarray) -> float:
    """Eight 2D patches of the implant grid (first, last, a clamped one,
    five drawn) run alone must match the volume on the pixels each writes
    last; returns the largest difference."""
    p = seg.patch_size
    data = seg.slices(image)
    Z, Yp, Xp = data.shape
    origins = [(z, gy, gx) for z in range(Z)
               for (_, gy, gx) in segment.patch_grid((1, Yp, Xp), p, seg.overlap)]
    starts = [_axis_starts(n, p, seg.overlap) for n in (Yp, Xp)]
    rng = np.random.default_rng(0)
    picks = [0, len(origins) - 1, 1] + list(rng.choice(len(origins), min(5, len(origins)), replace=False))
    worst = 0.0
    for i in picks:
        z, gy, gx = origins[i]
        alone = seg.apply(data[z:z + 1, gy:gy + p, gx:gx + p])[0].cpu().numpy()
        own = [_owned(starts[0], p, gy, image.shape[1]), _owned(starts[1], p, gx, image.shape[2])]
        region = prob[z, gy:gy + p, gx:gx + p]
        sel = np.ix_(*own)
        worst = max(worst, float(np.abs(alone[:region.shape[0], :region.shape[1]][sel]
                                        - region[sel]).max()))
    if worst > MODEL_ATOL:
        raise AssertionError(f"implant: a patch alone differs from the volume by {worst}")
    return worst


def profile_segmenter(dev, seg, image) -> None:
    """One warm segmentation under torch.profiler: the device's kernel and
    copy time, its idle share of the wall time, and the largest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        seg.segment(image)
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and not e.key.startswith(("aten::", "cuda"))
            and "Activity Buffer" not in e.key]
    busy = sum(ms for _, ms, _ in rows) / 1e3
    log(f"    profiled BrainSegmenter run: wall {wall:.4f} s, device kernel and copy time "
        f"{busy:.4f} s, idle share {1 - busy / wall:.1%}")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"      {ms:9.3f} ms {count:6d}x  {name[:90]}")


# ---------------------------------------------------------------------------
# phase 13: the study importers
# ---------------------------------------------------------------------------

IMPORT_N = 512  # the DICOM series: make_ct(512) as 512 files of 512^2 (phase 13)
IMPORT_SECOND = 128  # slices of the second, smaller series in the same directory
# name -> (transfer syntax, stored dtype, slices written at n^2); the
# pure-Python codecs (JPEG-LS, 12-bit) take seconds a slice: a few slices
IMPORT_CODECS = {
    "rle": (codecs.RLE_LOSSLESS, np.int16, 32),
    "jpegll-sv1": (codecs.JPEG_LOSSLESS_SV1, np.int16, 32),
    "jpegls": (codecs.JPEG_LS_LOSSLESS, np.int16, 2),
    "jpegls-near": (codecs.JPEG_LS_NEAR, np.uint16, 2),
    "jpeg12": (codecs.JPEG_EXTENDED, np.uint16, 2),
    "jpeg-baseline": (codecs.JPEG_BASELINE, np.uint8, 2),
    "j2k-lossless": (codecs.J2K_LOSSLESS, np.uint16, 2),
    "j2k": (codecs.J2K, np.uint16, 2),
}
PILLOW_SYNTAXES = (codecs.JPEG_BASELINE, codecs.J2K_LOSSLESS, codecs.J2K)
STUDY_UID = "1.2.826.0.1.3680043.8.498.1"
SERIES_UIDS = ("1.2.826.0.1.3680043.8.498.1.10000002",
               "1.2.826.0.1.3680043.8.498.1.20000003")
IMPORT_SPACING = 0.5
TILT_DEGREES = 15.0


def _dicom_tags(k: int, n: int, uid: str, **extra) -> dict:
    """Slice k of an n-slice axial series: positions step along the normal
    about a centred origin; stored values are HU + 1024, rescaled by -1024."""
    c = (n - 1) * IMPORT_SPACING / 2
    tags = {
        "PatientName": "PHANTOM^HEAD", "PatientID": "CHIP-SMOKE-1", "Modality": "CT",
        "StudyInstanceUID": STUDY_UID, "SeriesInstanceUID": uid,
        "SOPInstanceUID": f"{uid}.{k + 1}", "SeriesDescription": "HEAD 0.5 H30s",
        "StudyDate": "20260101", "StudyTime": "083000", "SeriesNumber": 2,
        "InstanceNumber": k + 1,
        "ImagePositionPatient": [-c, -c, -c + IMPORT_SPACING * k],
        "ImageOrientationPatient": [1, 0, 0, 0, 1, 0],
        "PixelSpacing": [IMPORT_SPACING, IMPORT_SPACING], "SliceThickness": IMPORT_SPACING,
        "RescaleSlope": 1.0, "RescaleIntercept": -1024.0,
        "WindowCenter": 40, "WindowWidth": 400}
    tags.update(extra)
    return tags


def _stored(sl: np.ndarray, dtype) -> np.ndarray:
    """A CT slice's stored pixels: HU + 1024 (8 bits: (HU + 1024) / 16)."""
    if dtype == np.uint8:
        return np.clip((sl.astype(np.int32) + 1024) // 16, 0, 255).astype(np.uint8)
    return (sl.astype(np.int32) + 1024).astype(dtype)


def write_series(root: Path, ct: np.ndarray, uid: str, syntax=dicom.EXPLICIT_VR_LE,
                 dtype=np.int16, seed: int = 0, **extra):
    """``ct`` as one DICOM file a slice under shuffled names; returns the
    paths and the stored arrays in slice order."""
    root.mkdir(parents=True, exist_ok=True)
    names = np.random.default_rng(seed).permutation(len(ct))
    if dtype == np.uint8:
        extra.setdefault("RescaleSlope", 16.0)
    paths, stored = [], []
    for k, sl in enumerate(ct):
        px = _stored(sl, dtype)
        paths.append(root / f"IM{names[k]:05d}")
        dicom.write_dicom(paths[-1], px, _dicom_tags(k, len(ct), uid, **extra),
                          transfer_syntax=syntax)
        stored.append(px)
    return paths, stored


def _expected_affine(n: int) -> np.ndarray:
    c = (n - 1) * IMPORT_SPACING / 2
    aff = np.diag([IMPORT_SPACING] * 3 + [1.0])
    aff[:3, 3] = [-c, -c, -c]
    return aff


def _stl_digest(path: Path):
    """(sha256, triangles) of a binary STL with finite vertices; the file
    is then deleted (a 512^3 Bone surface is 462 MB)."""
    import hashlib

    data = path.read_bytes()
    tris = int.from_bytes(data[80:84], "little")
    if len(data) != 84 + 50 * tris or tris == 0:
        raise AssertionError(f"{path.name}: not a binary STL of its header's count")
    rec = np.frombuffer(data[84:], np.dtype([("n", "<f4", 3), ("v", "<f4", 9), ("a", "<u2")]))
    if not np.isfinite(rec["v"]).all():
        raise AssertionError(f"{path.name}: non-finite vertices")
    path.unlink()
    return hashlib.sha256(data).hexdigest(), tris


def _timed_app(dev, argv) -> float:
    _sync(dev)
    t0 = time.perf_counter()
    if app.main([str(a) for a in argv], device=dev) != 0:
        raise AssertionError(f"app.main failed: {argv}")
    _sync(dev)
    return time.perf_counter() - t0


def _decode_series(paths, stored, syntax, plain_every: int = 4) -> dict:
    """Each file read afresh and its pixels decoded (ms a slice), held to
    the stored array: lossless syntaxes equal, lossy ones within the JAX
    tests' bounds; RLE and lossless JPEG every ``plain_every``-th file also
    through the plain Python decoders, which must agree bit for bit."""
    ms, plain_ms, worst = [], [], 0
    for k, (p, want) in enumerate(zip(paths, stored)):
        f = dicom.read_dicom(p)
        t0 = time.perf_counter()
        got = f.pixel_array()
        ms.append((time.perf_counter() - t0) * 1e3)
        err = np.abs(got.astype(np.int64) - want.astype(np.int64))
        worst = max(worst, int(err.max()))
        ok = {codecs.JPEG_EXTENDED: err.mean() < 6.0 and err.max() < 64,
              codecs.JPEG_LS_NEAR: err.max() <= 2,
              codecs.JPEG_BASELINE: err.mean() < 3.0}.get(
            syntax, err.max() == 0 and got.dtype == want.dtype)
        if not ok:
            raise AssertionError(f"{p.name}: pixels off by up to {err.max()} (mean "
                                 f"{err.mean():.3f}) through {syntax}")
        if syntax in (codecs.RLE_LOSSLESS, codecs.JPEG_LOSSLESS_SV1) and k % plain_every == 0:
            frame = codecs.fragments_to_frames(p.read_bytes(), f.fragments, 1)[0]
            t0 = time.perf_counter()
            if syntax == codecs.RLE_LOSSLESS:
                plain = codecs.rle_decode_frame(frame, *want.shape, 16,
                                                packbits=codecs.packbits_decode_ref)
            else:
                plain = codecs.jpegll_decode_ref(frame)
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(plain.view(got.dtype), got):
                raise AssertionError(f"{p.name}: the native and plain decoders differ")
    return {"ms": ms, "plain_ms": plain_ms, "max_err": worst}


def _pillow_version():
    try:
        import PIL
    except ImportError:
        return None
    return PIL.__version__


def study_importers(dev, tmp: Path, n: int = IMPORT_N, second: int = IMPORT_SECOND,
                    codec_slices=None) -> dict:
    """Phase 13: make_ct(n) as a DICOM series through the importers and
    ``app -i`` / ``--import-all``, the gantry tilt at n^3, every transfer
    syntax, a bitmap stack and a PAR/REC pair.  ``codec_slices`` overrides
    IMPORT_CODECS' slice counts.  Returns seconds per step and ms a slice
    per syntax."""
    import os

    from invesalius3_tpu_torch.io import bitmap, parrec

    log(f"[13] the study importers: make_ct({n}) as {n} DICOM files of {n}^2")
    os.environ["XDG_CONFIG_HOME"] = str(tmp / "config")  # the app's session
    kernels.reset_launches()
    rays.reset_launches()
    t_phase = time.perf_counter()
    times, decode = {}, {}
    ct = pipeline.make_ct(n)
    ct_d = torch.from_numpy(ct).to(dev)
    study = tmp / "study"
    t0 = time.perf_counter()
    write_series(study, ct, SERIES_UIDS[0], seed=1)
    first = n // 4
    write_series(study / "second", ct[first:first + second], SERIES_UIDS[1], seed=2)
    times["write"] = time.perf_counter() - t0
    log(f"  wrote {n} + {second} files of {n}^2 (explicit VR LE, int16 HU + 1024, "
        f"names shuffled): {times['write']:.3f} s")

    # 2. the import's steps, timed
    t0 = time.perf_counter()
    groups = dicom.load_dicom_dir(study)
    times["scan_parse"] = time.perf_counter() - t0
    group = max(groups, key=lambda g: len(g.files))
    if sorted(len(g.files) for g in groups) != sorted([n, second]):
        raise AssertionError(f"groups: {[len(g.files) for g in groups]}")
    files = group.sorted_files()
    t0 = time.perf_counter()
    for f in files:
        f.pixel_array()
    times["pixels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for f in files:
        f.rescaled_slice()
    times["rescale"] = time.perf_counter() - t0
    _sync(dev)
    t0 = time.perf_counter()
    data, spacing, affine = dicom.group_to_volume(group, device=dev)
    _sync(dev)
    times["group_to_volume"] = time.perf_counter() - t0
    if data.device.type != dev.type or not torch.equal(data, ct_d):
        raise AssertionError("the DICOM volume differs from make_ct")
    if spacing != (IMPORT_SPACING,) * 3 or not np.array_equal(affine, _expected_affine(n)):
        raise AssertionError(f"spacing {spacing} / affine {affine.tolist()}")
    t0 = time.perf_counter()
    host = torch.from_numpy(ct)
    host.to(dev)
    _sync(dev)
    times["h2d_pageable"] = time.perf_counter() - t0
    if dev.type == "cuda":
        t0 = time.perf_counter()
        pinned = host.pin_memory()
        times["pin"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pinned.to(dev, non_blocking=True)
        _sync(dev)
        times["h2d_pinned"] = time.perf_counter() - t0
        del pinned
    del data
    log(f"  {len(groups)} series found; the {n}-slice volume on {dev.type} equals "
        f"make_ct({n}) bit for bit, spacing {spacing}, affine as written")
    log("  import steps (s): " + ", ".join(
        f"{k} {times[k]:.4f}" for k in ("scan_parse", "pixels", "rescale", "group_to_volume",
                                       "h2d_pageable", "pin", "h2d_pinned") if k in times))

    # 3. the app: -i against the same array as a NIfTI; --import-all
    nii = tmp / "ct.nii"
    nifti.write_nifti(nii, ct, spacing=(IMPORT_SPACING,) * 3)
    flow = ["-t", "Bone", "-e", tmp / "bone.stl", "--algorithm", "ca_smoothing"]
    times["app_nifti"] = _timed_app(dev, ["--import-file", nii, *flow])
    ref, tris = _stl_digest(tmp / "bone.stl")
    times["app_dicom"] = _timed_app(dev, ["-i", study, *flow])
    if _stl_digest(tmp / "bone.stl")[0] != ref:
        raise AssertionError("app -i: the STL differs from the NIfTI flow's")
    log(f"  app -i: {times['app_dicom']:.3f} s (the NIfTI flow {times['app_nifti']:.3f} s); "
        f"STL bytes equal ({tris} triangles)")
    out = tmp / "all"
    out.mkdir()
    times["app_import_all"] = _timed_app(
        dev, ["-i", study, "--import-all", "-t", "Bone", "-e", out / "skull.stl",
              "--algorithm", "ca_smoothing"])
    names = sorted(p.name for p in out.iterdir())
    want = sorted(f"skull_{uid[-8:]}.stl" for uid in SERIES_UIDS)
    if names != want:
        raise AssertionError(f"--import-all wrote {names}, not {want}")
    digests = {name: _stl_digest(out / name) for name in names}
    if digests[f"skull_{SERIES_UIDS[0][-8:]}.stl"][0] != ref:
        raise AssertionError("--import-all: the large series' STL differs from -i's")
    log(f"  app -i --import-all: {times['app_import_all']:.3f} s; "
        + ", ".join(f"{k} ({v[1]} triangles)" for k, v in digests.items()))

    # 4. the gantry tilt at n^3
    tilted = tmp / "tilted"
    write_series(tilted, ct, SERIES_UIDS[0], seed=3, GantryDetectorTilt=TILT_DEGREES)
    tg = dicom.load_dicom_dir(tilted)[0]
    for f in tg.files:
        f.pixel_array()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    _sync(dev)
    t0 = time.perf_counter()
    vol_t, _, _ = dicom.group_to_volume(tg, device=dev)
    _sync(dev)
    times["group_to_volume_tilt"] = time.perf_counter() - t0
    peak = ((torch.cuda.max_memory_allocated() - base) / 2**30 if dev.type == "cuda"
            else None)
    sp = (IMPORT_SPACING,) * 3
    card_ms = []
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        dicom.fix_gantry_tilt(ct_d, sp, TILT_DEGREES, device=dev)
        _sync(dev)
        card_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    want_t = dicom.fix_gantry_tilt(ct, sp, TILT_DEGREES, device="cpu")
    times["tilt_cpu"] = time.perf_counter() - t0
    diff = (vol_t.cpu().int() - want_t.int()).abs()
    same = float((diff == 0).double().mean())
    if int(diff.max()) > 1 or same < 0.999:
        raise AssertionError(f"tilt: card and CPU differ by up to {int(diff.max())}, "
                             f"equal on {same:.6f}")
    moved = float((want_t != torch.from_numpy(ct)).double().mean())
    times["tilt_ms"] = card_ms
    log(f"  {TILT_DEGREES:g} degree tilt at {n}^3: group_to_volume "
        f"{times['group_to_volume_tilt']:.3f} s; fix_gantry_tilt on {dev.type} "
        f"{[round(t, 2) for t in card_ms]} ms, on the CPU {times['tilt_cpu'] * 1e3:.1f} ms; "
        f"equal on {same:.6%} of voxels, largest difference {int(diff.max())} "
        f"({moved:.1%} of voxels moved); peak device memory "
        + (f"{peak:.3f} GiB above the {base / 2**30:.3f} GiB held before"
           if peak is not None else "n/a"))
    del vol_t, want_t, diff, ct_d

    # 5. compressed transfer syntaxes at n^2
    pillow = _pillow_version()
    log(f"pillow: {pillow or 'absent'}")
    mid = n // 2
    for name, (syntax, dtype, count) in IMPORT_CODECS.items():
        if syntax in PILLOW_SYNTAXES and pillow is None:
            continue
        count = (codec_slices or {}).get(name, count)
        sl = ct[mid - count // 2: mid - count // 2 + count]
        t0 = time.perf_counter()
        paths, stored = write_series(tmp / name, sl, f"{STUDY_UID}.3{len(decode)}",
                                     syntax=syntax, dtype=dtype, seed=4)
        enc = (time.perf_counter() - t0) * 1e3 / count
        rec = _decode_series(paths, stored, syntax)
        rec["encode_ms"] = enc
        decode[name] = rec
        extra = ""
        if syntax in (codecs.RLE_LOSSLESS, codecs.JPEG_LOSSLESS_SV1):
            g = dicom.load_dicom_dir(tmp / name)[0]
            vol, _, _ = dicom.group_to_volume(g, device=dev)
            if not torch.equal(vol.cpu(), torch.from_numpy(sl)):
                raise AssertionError(f"{name}: the series' volume differs from make_ct")
            extra = (f"; plain decoder {np.mean(rec['plain_ms']):.1f} ms a slice on "
                     f"{len(rec['plain_ms'])} slices, equal; the series' volume equal")
        log(f"  {name} ({syntax}), {count} slices: decode {np.mean(rec['ms']):.2f} ms a "
            f"slice (encode {enc:.1f}), largest error {rec['max_err']}{extra}")

    # 6. Pillow's paths, the bitmap stack and PAR/REC
    stack = tmp / "stack"
    stack.mkdir()
    if pillow is None:
        (stack / "slice1.tif").write_bytes(b"II*\x00")
        for what, call in (
                ("bitmap.load_bitmap_dir", lambda: bitmap.load_bitmap_dir(stack)),
                ("app --import-folder", lambda: app.main(
                    ["--import-folder", str(stack), "-t", "1250,4095"], device=dev)),
                ("baseline JPEG", lambda: codecs.jpeg_baseline_decode(b"\xff\xd8")),
                ("JPEG 2000", lambda: codecs.j2k_decode(b"\x00")),
                ("write_dicom .4.90", lambda: dicom.write_dicom(
                    tmp / "x.dcm", ct[0], {}, transfer_syntax=codecs.J2K_LOSSLESS))):
            try:
                call()
            except ImportError as e:
                if "Pillow" not in str(e):
                    raise
            else:
                raise AssertionError(f"{what} ran without Pillow")
        log("  without Pillow, the bitmap stack, baseline JPEG and JPEG 2000 raise an "
            "ImportError that names Pillow")
    else:
        from PIL import Image

        t0 = time.perf_counter()
        for k, s in enumerate(ct):
            Image.fromarray(_stored(s, np.uint16)).save(stack / f"slice{k + 1}.tif")
        times["write_stack"] = time.perf_counter() - t0
        times["app_bitmap"] = _timed_app(dev, [
            "--import-folder", stack, "--spacing", ",".join([str(IMPORT_SPACING)] * 3),
            "-t", "1250,4095", "-e", tmp / "bone.stl", "--algorithm", "ca_smoothing"])
        if _stl_digest(tmp / "bone.stl")[0] != ref:
            raise AssertionError("--import-folder: the STL differs from the NIfTI flow's")
        log(f"  app --import-folder --spacing: {n} 16-bit TIFF slices (HU + 1024, "
            f"written in {times['write_stack']:.2f} s), Bone shifted by 1024: "
            f"{times['app_bitmap']:.3f} s, STL bytes equal the NIfTI flow's")
    par = tmp / "ct.PAR"
    rows = [" ".join(f"{v:g}" for v in [
        sl + 1, 1, 1, 1, 0, 0, sl, 16, 100, n, n, 0.0, 1.0, 1.0, 40, 400] + [0.0] * 12
        + [IMPORT_SPACING, IMPORT_SPACING] + [0.0] * 3) for sl in range(n)]
    par.write_text("\n".join([
        "# === DATA DESCRIPTION FILE ======================================",
        "# Research image export tool     V4.2",
        ".    Patient name                       :   PHANTOM",
        f".    Max. number of slices/locations    :   {n}",
        ".    Max. number of dynamics             :   1",
        f".    Recon resolution (x, y)            :   {n}  {n}",
        f".    Slice thickness [mm]               :   {IMPORT_SPACING:.3f}",
        ".    Slice gap [mm]                     :   0.000",
        "# === IMAGE INFORMATION =========================================="] + rows) + "\n")
    ct.astype("<i2").tofile(tmp / "ct.REC")
    t0 = time.perf_counter()
    vol_p, sp_p = parrec.read_par_rec(par)
    times["parrec_read"] = time.perf_counter() - t0
    if vol_p.dtype != np.int16 or not np.array_equal(vol_p, ct) or sp_p != sp:
        raise AssertionError("PAR/REC: the volume or spacing differs")
    times["app_parrec"] = _timed_app(dev, ["--import-file", par, *flow])
    if _stl_digest(tmp / "bone.stl")[0] != ref:
        raise AssertionError("PAR/REC: the STL differs from the NIfTI flow's")
    log(f"  PAR/REC V4.2 {n}x{n}x{n}: read {times['parrec_read']:.3f} s, equal to "
        f"make_ct; app --import-file {times['app_parrec']:.3f} s, STL bytes equal")

    launches = {"sweeps": dict(kernels.LAUNCHES),
                "rays": {k: dict(v) for k, v in rays.LAUNCHES.items()}}
    times["phase"] = time.perf_counter() - t_phase
    log(f"  phase [13]: {times['phase']:.1f} s; kernel launches on this path: "
        f"{launches} (no kernel lies on it)")
    if any(kernels.LAUNCHES.values()) or any(
            v for per_axis in rays.LAUNCHES.values() for v in per_axis.values()):
        raise AssertionError(f"a hot-path kernel launched on the importers' path: {launches}")
    return {"times": times, "decode": decode}


if __name__ == "__main__":
    sys.exit(main())

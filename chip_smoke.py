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
   many tiles long, rays of length 1 and 2, and the sharded watershed's
   ghost-padded slabs (3, 512, 512) and (66, 512, 512));
3. runs the segmentation-to-STL flow at 128^3 through the kernel and
   through the plain sweep, and the two-level multigrid watershed at 128^3
   through both: labels, refine rounds and STL bytes must be identical,
   and the streamed STL (``DeviceFaceStream``) the bytes of ``write_stl``
   of the host mesh;
4. runs the flow at 512^3 (bench.py's phantom and markers, spacing 0.5 mm)
   once to warm up and once timed, with the kernel's launch counts reset
   just before the timed run (the face table streams to the host while the
   mesh is smoothed; its STL time is printed beside PR 3's one-copy
   0.250 s); checks the STL size and counts, the refine
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
   voxels rebuilt bit for bit from its slices.  No sweep or ray kernel
   lies on this path (their counts must stay 0); the competitive dense
   blocks launch ``ops/cdb_epilogue.py``'s kernel, 36 times a network
   call (counted over the timed ``SubpartSegmenter`` calls).
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
14. drives the neuronavigation path (``navigation_phase``): the same
   sequence at small sizes on the card and on the CPU first (three peel
   modes on ``_mri(40)``, JFA at 64^3 and 128^3 bit for bit, ICP's matches
   at every iteration, tracking with the same draws on both, e-field and
   MEP); then ``Brain(n_peels=5, peel_depth_mm=1.0)`` in every mode on the
   256^3 T1 phantom of phase 12 and its bright ellipsoid (every peel closed
   and oriented, intensities finite and inside the image's range; stage
   times), ``jump_flooding`` at 512^3 with 64 sites (on 10^5 sampled
   voxels: every distance the owner site's, and owners the exact nearest
   site on all but 0.1% of the strictly decided ones, those at most a voxel
   farther: JFA is approximate),
   ``jump_flooding_normalized`` and both ``floodfill_voronoi`` distances at
   256^3, ICP of 1000 points moved by a known 1 degree, 1.35 mm transform
   onto 10^6 vertices of the T1 phantom's scalp and brain surfaces, 150
   iterations (recovered within 0.2 mm), deterministic and probabilistic tracking on a seeded lmax 8 FOD
   at the HCP grid 145x174x145 (64 tracts x 120 steps a pose; a bundle of
   10^4 seeds x 200 steps x 16 candidates), e-field norms over 10^5 ROI
   vertices, the MEP field of peel 0 from 200 markers; per op the wall time
   (first and warm, device synchronised) and the peak memory; then
   ``Navigation`` with the debug-approach tracker at 120 Hz for 5 s with the
   tract and e-field workers on the card: at least 100 scene updates and a
   tract and an e-field message of the expected shapes, with the counts and
   the median and p95 latency from a pose's timestamp to its publication.
   No kernel lies on this path (the counts must stay 0).
15. drives the viewer server (``viewer_server_phase``): the port's
   ``ViewerServer`` over ``make_ct(512)`` on the card (int16, 0.5 mm), over
   HTTP on 127.0.0.1 as the web client drives it: the page (the port's
   ``index.html`` byte for byte), the status and window, frames in three
   orientations (Normal, and MaxIP, LMIP, MIDA at slab 64) each equal to
   ``Slice.get_rendered_slice`` called directly (MIDA within 2 levels),
   the Bone threshold (its voxel count the direct threshold's), a
   floodfill, a brush stroke and the mask statistics, the watershed from
   the bench's three markers (its mask the direct ``watershed``'s), the
   ca_smoothing surface (its STL bytes the direct surface's), the Bone
   render at 512 and the scene on an imported sphere shell's surface below
   the renderer's 200k-triangle decimation threshold (the large surface
   hidden meanwhile), linear, angular and density measures, a pick, the histogram (its counts numpy's on the same edges), a navigation
   round with the pedal and mTMS, a trachea DL job (its mask the direct
   segmenter's, same seeded weights), the language round trip, events and
   log.  Each endpoint's wall ms (a GET the
   median of 5, the STL and the scene once, a POST as sent), the peak
   memory and the launch counts below the server (oracle calls
   uncounted), beside the card's name and power limit; the sweep and ray
   counts must be above 0, and the shear-cache warm-up must log no
   failure.
16. drives the network and the hardware trackers
   (``network_and_trackers_phase``): ``make_ct(512)`` as 512 DICOM files of
   512^2 beside a 128-slice series of the same study on a mini-PACS on
   127.0.0.1 (``MiniPACS``: C-ECHO, study-root C-FIND, C-MOVE by the port's
   ``send_c_store``); the port's ``ViewerServer`` on the card over HTTP:
   ``/api/pacs/echo`` (true; a dead port false), ``/api/pacs/find`` (the
   study's row as written), ``/api/pacs/move`` with import (640 files, each
   dataset byte for byte the sent one; the larger series imported, equal to
   ``group_to_volume`` of the source voxel for voxel), then the Bone
   threshold and ``/api/watershed`` from the bench's markers (the direct
   watershed's mask) and LMIP and MIDA frames in three orientations (the
   direct frames, MIDA within 2 levels), the sweep and ray launches below
   the server above 0, the shear-cache warm-up without failure; echo,
   find and move ms (transfer and import, MB/s); then the four hardware
   trackers (Polhemus ISOTRAK transcript, Polaris with its ROM upload,
   OptiTrack NatNet datagrams, a MicronTracker replay) through
   ``Tracker.connect``, each feeding a ``Navigation`` with the tract worker
   and the e-field worker through ``NeuronavigationApi`` for 2 s, the TTL
   ``SerialPortConnection`` on a fake port beside it: every coordinate read
   equal to ``vendor_coords``' conversion of its replayed pose, counts and
   pose-to-publish median and p95; the 9x9 and 4-ring x 12 grids on the
   256^3 T1 phantom's scalp (every target on a scalp vertex, coil axes the
   unit normals, the labels and counts); ``app.main --remote-host``
   against a ``RemoteEventServer`` (its topics in order those a local hook
   recorded, an injected event on the app's bus) and a 2 s ``Navigation``
   with the mirror on, its scene rate beside phase [14]'s; the peak memory
   beside the card's name and power limit.
17. drives the sharded flow over a shard list (``sharded_phase``) on
   ``make_mesh(8)`` (8 shards on the one card): the small cases of
   tests/test_parallel.py (the 64^3 two-basin watershed at levels 2 with
   both stopping rules, the rod floodfill, dilation in 6 and 26
   connectivity, the active-cell count, a sphere shell's surface uniform
   and balanced, raw and smoothed, its ``write_stl_sharded`` bytes) on the
   card and the CPU, equal (smoothed vertices within 1e-4 mm); the sharded
   watershed at 128^3 with 3 levels through the kernel and through the
   plain sweep (labels and rounds identical); then ``pipeline.run(
   make_ct(512), bench_markers(512), out, shards=mesh)`` once to warm up
   and once timed, the sweep counts reset just before it: labels against
   the single-device watershed (every differing voxel a cost tie, found by
   the sweeps iterated to each marker's minimax costs; under 1% differ),
   3 levels (4 refines), the balanced cuts, the vertex and triangle counts
   of ``mask_to_surface_device`` on the same mask, the smoothed vertices
   within 1e-4 mm of ``ca_smoothing_device``, the face set, the STL bytes
   of ``write_stl`` of the assembled mesh, the sweep launches per shard
   and axis above 0; it prints the stage times beside phase [4]'s, the
   peak, the rounds and halo bytes per level and the cuts.  With more than
   one card it runs the flow once more on one shard a card;
18. runs the same 512^3 flow across processes (``cross_process_phase``):
   two ranks on the one card over gloo (their card planes staged through
   pinned host buffers), each joining the group from torch's launcher
   variables and calling ``pipeline.run(ct, markers, out,
   shards=distributed.global_mesh(shape=(8,)))`` with 4 of the 8 shards,
   once to warm up and once timed (sweep counts reset just before it);
   with two or more cards once more over NCCL, one rank a card.  The ranks
   load the kernels phase [1] built.  Every rank's labels (by shard),
   rounds, halo bytes, cuts and checks and rank 0's STL bytes must equal
   phase [17]'s, and every rank's sweeps must launch on every axis; any
   rank's non-zero exit or a collective's timeout fails the phase.  It
   prints the backend, the per-rank stage times, the bytes that crossed
   between the ranks and each rank's peak device memory.
19. trains the U-Net (``training_phase``): ``Unet3D(init_features=8,
   dtype=bfloat16)`` from seeded Flax-style weights on a global batch of 8
   patches of 96^3 (``make_ct(192)``'s 2x2x2 grid, windowed and rescaled as
   ``TracheaSegmenter`` does; the targets their Bone threshold),
   ``train.train_step`` (train-mode batch norms, BCE, Adam at 1e-3): (a)
   five steps in one process, every loss finite and the fifth below the
   first, the median step ms of steps 2-5, the peak memory, the share of
   the dense bf16 peak (3 x ``unet3d_flops(96)`` x 8 a step) and a
   profiled step's idle share, then the first two steps in float32; (b)
   two ranks on the one card over gloo (card tensors staged through
   pinned host buffers), 4 patches each, the batch norms' statistics and
   the gradients summed over the group, in bfloat16 and float32: each
   rank's losses, running statistics, gradients and parameters equal
   (a)'s (``BF16_TOL`` on the first step and every loss; ``CARD_DP_TOL``
   in float32); (c) one float32 step at 48^3, batch 2, on the card and on
   the CPU, equal within ``CARD_TOL``.  No kernel lies
   on this path (the counts must stay 0).
20. times the competitive dense block's fused transition
   (``cdb_epilogue_phase``, ``ops/cdb_epilogue.py``) at a middle
   transition of FastSurferCNN's first level, 8 x 64 x 256^2 (bf16
   convolution output, float32 partner, norm, maxout, PReLU, float32 and
   bf16 results): the kernel's ms between CUDA events against its byte
   bound (12 B an element over 3.35 TB/s) and against the plain version's
   ms; the two equal bit for bit, as they do in the first block's entry
   (8 x 7 x 256^2, bf16 out) and after its last convolution (float32 out
   only).

It prints the card's name and power limit first, the whole run's seconds
and a JSON line of the kernels before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits with status 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
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
from invesalius3_tpu_torch.models import fastsurfer, onnx_convert, segment, train, unet2d, unet3d
from invesalius3_tpu_torch.models import layers as mlayers
from invesalius3_tpu_torch.navigation.tracker import TrackerCoordinates
from invesalius3_tpu_torch.net import download
from invesalius3_tpu_torch.ops import (connected, floodfill, kernels, mesh, morphology,
                                       rasterize, raycast, render_mesh, reslice, resize,
                                       transforms, watershed)
from invesalius3_tpu_torch.ops import cdb_epilogue, conv_wgrad, marching
from invesalius3_tpu_torch.ops import projection_kernels as rays
from invesalius3_tpu_torch.ops import threshold as thr_ops
from invesalius3_tpu_torch.parallel import collectives, distributed, sharded_ops
from invesalius3_tpu_torch.parallel.mesh_utils import make_mesh
from invesalius3_tpu_torch.utils import paths

import time_rays as time_rays_lib

KERNEL_SOURCE = "invesalius3_tpu_torch/csrc/watershed_sweep.cu"
REPLACES = {  # sweep axis -> the TPU kernel it replaces
    0: "invesalius3_tpu/ops/pallas_kernels.py:259",  # watershed_sweep_z
    1: "invesalius3_tpu/ops/pallas_kernels.py:289",  # watershed_sweep_y
    2: "invesalius3_tpu/ops/pallas_kernels.py:289",  # y kernel on swapped axes
}
RAY_SOURCE = "invesalius3_tpu_torch/csrc/ray_projections.cu"
# replaces no TPU kernel (the JAX package leaves the gradient to XLA)
CONV_WGRAD_SOURCE = "invesalius3_tpu_torch/csrc/conv_wgrad.cu"
CDB_EPILOGUE_SOURCE = "invesalius3_tpu_torch/csrc/cdb_epilogue.cu"  # replaces none either
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

    t_run = time.perf_counter()
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
        launches, times, times_4 = run_flows(dev, Path(d))

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
        models = models_phase(dev, Path(d))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as d:
        study_importers(dev, Path(d))
    torch.cuda.empty_cache()
    nav = navigation_phase(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_server_") as d:
        viewer_server_phase(dev, Path(d))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_net_") as d:
        network_and_trackers_phase(dev, Path(d), scene_hz_14=nav["session"][
            "navigation.update_scene"]["count"] / nav["session"]["seconds"])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as d:
        sharded = sharded_phase(dev, Path(d), times_4=times_4)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_procs_") as d:
        procs = cross_process_phase(dev, Path(d), sharded)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        trained = training_phase(dev, Path(d))

    # the sweeps' launches on the main paths: the single-device flow of
    # phase [4], the sharded flow of phase [17] and its ranks' in phase
    # [18] (summed over the ranks), each counted from 0
    entries = [
        {"name": f"watershed_sweep[axis={axis}]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES[axis],
         "launches": launches[axis] + sharded["launches"][axis] + procs["launches"][axis],
         "launches_by_phase": {"4": launches[axis], "17": sharded["launches"][axis],
                               "18": procs["launches"][axis]},
         **times[axis]}
        for axis in (0, 1, 2)]
    entries += [
        {"name": f"{k}_axis0[axis={axis}]", "route": "cuda", "source": RAY_SOURCE,
         "replaces": RAY_REPLACES[k], "launches": ray_launches[k][axis],
         "max_abs_err": errs[(k, axis)], **ray_times[(k, axis)]}
        for k in RAY_FNS for axis in (0, 1, 2)]
    entries += conv_wgrad_entries(trained)
    entries.append(cdb_epilogue_phase(dev, models["cdb_epilogue_launches"]))
    log(f"phases [1]-[20]: {time.perf_counter() - t_run:.1f} s ({smi})")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_flows(dev, tmp: Path):
    """Phases 3 to 5; returns (launch counts of the timed 512^3 run, sweep
    timings per axis, that run's stage seconds)."""
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
    # the streamed export (DeviceFaceStream) writes the one-copy path's bytes
    mesh_io.write_stl(tmp / "copy128.stl", *marching.mesh_to_host(mk))
    if (tmp / "k128.stl").read_bytes() != (tmp / "copy128.stl").read_bytes():
        raise AssertionError("the streamed STL differs from write_stl of the host mesh")
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
    log(f"  STL through DeviceFaceStream (faces copied while smoothing): "
        f"{res.times['stl']:.4f} s (PR 3's one-copy path: 0.250 s)")
    times_4 = dict(res.times)
    log(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("  export of the timed run's mesh, in turns (s): " + ", ".join(
        f"{k} {v}" for k, v in export_turns(res.mesh, tmp).items()))
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
    return launches, times, times_4


def export_turns(dm, tmp: Path, pairs: int = 3) -> dict:
    """Seconds of the two STL exports of one device mesh, in turns (the
    first of each pair alternates): the streamed ``write_stl_from_device``
    (faces and vertices copied on threads, records packed as they come; its
    stream started at the call, so nothing overlaps smoothing here) and the
    one-copy path (``mesh_to_host``, then ``write_stl``).  Their bytes must
    be equal."""
    paths = {"stream": tmp / "stream.stl", "one-copy": tmp / "copy.stl"}
    runs = {"stream": lambda: mesh_io.write_stl_from_device(paths["stream"], dm),
            "one-copy": lambda: mesh_io.write_stl(paths["one-copy"], *marching.mesh_to_host(dm))}
    times = {k: [] for k in runs}
    for i in range(pairs):
        for k in (("stream", "one-copy") if i % 2 == 0 else ("one-copy", "stream")):
            t0 = time.perf_counter()
            runs[k]()
            times[k].append(round(time.perf_counter() - t0, 4))
    if paths["stream"].read_bytes() != paths["one-copy"].read_bytes():
        raise AssertionError("the streamed STL differs from the one-copy path's")
    for path in paths.values():
        path.unlink()
    return times


def _profiled(dev, fn):
    """``fn()`` under torch.profiler: (its wall seconds, the device's kernel
    and copy seconds, rows (name, device ms, count) of those kernels and
    copies)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    # the device's own events (kernels and copies): a host op's row, an
    # aten op or an autograd node, repeats its kernels' time, and so does
    # the program's span (``invesalius.*``) on the device's timeline
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU and e.device_time_total > 0
            and "Activity Buffer" not in e.key and not e.key.startswith("invesalius.")]
    return wall, sum(ms for _, ms, _ in rows) / 1e3, rows


def profile_flow(dev, ct, markers, out: Path) -> None:
    """One warm flow under torch.profiler: the device's kernel and copy
    time, its idle share of the run's wall time, and the largest kernels."""
    wall, busy, rows = _profiled(dev, lambda: pipeline.run(ct, markers, out, device=dev))
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
    """Phase 12; returns the per-call record of the full-width runs
    (``rows``) and the dense blocks' kernel launches in the timed
    ``SubpartSegmenter`` calls (``cdb_epilogue_launches``)."""
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
    cdb_epilogue.reset_launches()
    labels, mask = times(f"SubpartSegmenter {mri_n}^3 (conform {mri_n})",
                         lambda: sub.segment(mri), n_fs, flops)
    # ``times`` calls twice; each call runs three views of batches of 8
    fused = cdb_epilogue.LAUNCHES["cdb_epilogue" if dev.type == "cuda" else "ref"]
    want = 2 * 36 * 3 * -(-mri_n // 8)
    log(f"    the dense blocks' kernel: {fused} launches in the two calls ({want} expected, "
        f"36 a network call)")
    if fused != want or (dev.type == "cuda" and cdb_epilogue.LAUNCHES["ref"]):
        raise AssertionError(f"subpart: the dense blocks' transitions {cdb_epilogue.LAUNCHES}, "
                             f"{want} launches expected")
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
    log(f"  phase [12]: {time.perf_counter() - t_phase:.1f} s; sweep and ray launches on "
        f"this path: {launches} (none lies on it); the dense blocks' kernel: {fused}")
    if any(kernels.LAUNCHES.values()) or any(
            v for per_axis in rays.LAUNCHES.values() for v in per_axis.values()):
        raise AssertionError(f"a hot-path kernel launched on the models' path: {launches}")
    return {"rows": times.rows, "cdb_epilogue_launches": fused}


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
    wall, busy, rows = _profiled(dev, lambda: seg.segment(image))
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



# ---------------------------------------------------------------------------
# phase 14: the neuronavigation path
# ---------------------------------------------------------------------------

NAV_MRI_N = 256  # the brain peel's T1 phantom (phase 12's _mri), 1 mm
NAV_PEEL_THRESHOLD = 550  # the phantom's bright ellipsoid (800 +- 25; around it 300)
NAV_JFA_N = 512  # JFA with 64 sites: owners int32 and distances float32, 512 MiB each
NAV_JFA_SITES = 64
NAV_VORONOI_N = 256  # jump_flooding_normalized and floodfill_voronoi
NAV_ICP_SOURCE = 1000
NAV_ICP_TARGETS = 10 ** 6  # vertices sampled from the T1 phantom's scalp and brain surfaces
# the known transform: 1.0 degree about one axis and 1.35 mm (twice that
# falls into a local minimum 1.95 mm off on these smooth surfaces); ICP runs
# a fixed 150 iterations, since its stopping test (the RMS error changing by
# under 1e-5 mm) meets plateaus before convergence and float32 noise of
# about 1e-3 mm after it
NAV_ICP_ROTATION = (0.01, -0.0075, 0.0125)  # radians
NAV_ICP_SHIFT = (1.0, -0.75, 0.5)  # mm
NAV_ICP_ITERATIONS = 150
NAV_FOD_SHAPE = (145, 174, 145)  # the HCP 1.25 mm grid
NAV_FOD_MM = 1.25
NAV_LMAX = 8  # 45 coefficients: the FOD takes 658 MiB of float32
NAV_BUNDLE = (10 ** 4, 200, 16)  # seeds, steps, candidates of the throughput run
NAV_ROI = 10 ** 5  # e-field ROI vertices a pose
NAV_MARKERS = 200  # MEP markers over peel 0
NAV_SESSION_S = 5.0
NAV_PATH_ATOL = 1e-4  # card against CPU tract paths, voxels (sin, cos, atan2 differ by ulps)


def _oriented_share(faces: np.ndarray, n_verts: int) -> float:
    """The share of directed edges that occur once and whose reverse occurs
    once: 1.0 on a closed, consistently oriented mesh."""
    f = np.asarray(faces, np.int64)
    a = np.concatenate([f[:, 0], f[:, 1], f[:, 2]])
    b = np.concatenate([f[:, 1], f[:, 2], f[:, 0]])
    keys, counts = np.unique(a * n_verts + b, return_counts=True)
    once = counts[np.searchsorted(keys, a * n_verts + b)] == 1
    rev = b * n_verts + a
    pos = np.clip(np.searchsorted(keys, rev), 0, len(keys) - 1)
    rev_once = (keys[pos] == rev) & (counts[pos] == 1)
    return float((once & rev_once).mean())


def _peel_checks(name: str, brain, image: np.ndarray, n_peels: int) -> str:
    """Every peel closed and oriented (all of its edges; the remesh chain's
    clustering may pinch 1%, the JAX package's test bound), finite, its
    intensities inside the image's range."""
    if len(brain.peels) != n_peels:
        raise AssertionError(f"{name}: {len(brain.peels)} peels, not {n_peels}")
    need = 0.99 if brain.regularize == "remesh" else 1.0
    lo, hi = float(image.min()) - 1.0, float(image.max()) + 1.0
    shares = []
    for k, p in enumerate(brain.peels):
        v, f, it = p["verts"], p["faces"], p["intensity"]
        share = _oriented_share(f, len(v))
        shares.append(share)
        if len(f) == 0 or not np.isfinite(v).all() or share < need:
            raise AssertionError(f"{name} peel {k}: {len(f)} faces, oriented share {share}")
        if it.shape != (len(v),) or not np.isfinite(it).all() or it.min() < lo or it.max() > hi:
            raise AssertionError(f"{name} peel {k}: intensities outside [{lo}, {hi}]")
    return (f"{[len(p['faces']) for p in brain.peels]} triangles, oriented edge share "
            f"{min(shares):.4f}-{max(shares):.4f}")


def _hausdorff(a: np.ndarray, b: np.ndarray) -> float:
    from scipy.spatial import cKDTree

    return float(max(cKDTree(b).query(a)[0].max(), cKDTree(a).query(b)[0].max()))


def _fod_coefficients(lmax: int, dev) -> torch.Tensor:
    """SH coefficients of an FOD peaked along +/-z: exp(8 (z^2 - 1))
    projected on the basis over a 4096-direction Fibonacci sphere."""
    from invesalius3_tpu_torch.navigation import tractography

    i = np.arange(4096)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1.0 - 2.0 * (i + 0.5) / 4096
    r = np.sqrt(1.0 - z * z)
    dirs = torch.as_tensor(np.stack([z, r * np.sin(phi), r * np.cos(phi)], -1),
                           dtype=torch.float32, device=dev)
    B = tractography.sh_basis(dirs, lmax)
    f = torch.exp(8.0 * (dirs[:, 0] ** 2 - 1.0))
    return (B.t() @ f) * (4 * np.pi / 4096)


def head_surfaces(image: np.ndarray, dev) -> torch.Tensor:
    """(3, V) vertices (world mm at 1 mm) of the T1 phantom's scalp (above
    150) and brain (above NAV_PEEL_THRESHOLD) surfaces, the surfaces that
    navigation's ICP registers probe points to.  (The CT phantom's skull is
    a sphere about the volume's centre, on which a rotation about the centre
    cannot be seen.)"""
    from invesalius3_tpu_torch.ops import marching

    img = torch.as_tensor(image, device=dev)
    return torch.cat([marching.mask_to_surface_device((img > t).to(torch.uint8) * 255).verts3v
                      for t in (150, NAV_PEEL_THRESHOLD)], dim=1)


def nav_fields(dev, shape, lmax: int, seed: int = 0):
    """(FOD (Z, Y, X, C), direction field (Z, Y, X, 3), white-matter mask)
    made on ``dev`` from a seed: a z-peaked FOD with seeded noise on its
    coefficients, unit directions near +z with a seeded wobble, and an
    ellipsoid filling most of the grid."""
    g = torch.Generator(device=dev).manual_seed(seed)
    coef = _fod_coefficients(lmax, dev)
    fod = torch.randn(shape + (len(coef),), generator=g, device=dev) * 0.05 + coef
    field = torch.randn(shape + (3,), generator=g, device=dev) * 0.3
    field[..., 0] += 1.0
    field /= torch.linalg.vector_norm(field, dim=-1, keepdim=True)
    axes = [(torch.arange(n, dtype=torch.float32, device=dev) - (n - 1) / 2) / (0.45 * n)
            for n in shape]
    mask = (axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2
            + axes[2][None, None, :] ** 2) < 1.0
    return fod, field, mask


def nav_sequence(dev, n: int = 40, jfa_sizes=(64, 128), icp_targets: int = 20000) -> dict:
    """Phase 14's sequence at small sizes on ``dev``, every result on the
    host: the three peel modes on _mri(n), JFA at ``jfa_sizes``, ICP on a
    small Bone surface, deterministic and probabilistic tracking (the
    probabilistic draws made on the CPU and handed in), e-field norms and
    the MEP field."""
    from invesalius3_tpu_torch.navigation import efield, mep, tractography
    from invesalius3_tpu_torch.ops import brain_peel, registration, voronoi

    out = {}
    image = _mri(n)
    mask = np.where(image > NAV_PEEL_THRESHOLD, 255, 0).astype(np.uint8)
    for mode in ("remesh", "volume", "none"):
        b = brain_peel.Brain(image, mask, n_peels=3, peel_depth_mm=1.0, regularize=mode,
                             device=dev)
        out[f"peel {mode}"] = [(p["verts"], p["faces"], p["intensity"]) for p in b.peels]
    rng = np.random.default_rng(1)
    for m in jfa_sizes:
        sites = rng.integers(0, m, (NAV_JFA_SITES, 3)).astype(np.int32)
        owners, dist = voronoi.jump_flooding((m, m, m), sites, device=dev)
        out[f"jfa {m}"] = (owners.cpu().numpy(), dist.cpu().numpy())
    verts = head_surfaces(image, dev).t().cpu().numpy()
    target = verts[rng.choice(len(verts), min(icp_targets, len(verts)), replace=False)]
    m_true = transforms.euler_matrix(*NAV_ICP_ROTATION)
    m_true[:3, 3] = NAV_ICP_SHIFT
    source = (np.c_[target[:300], np.ones(300)] @ np.linalg.inv(m_true).T)[:, :3]
    hist = []
    m_icp, _ = registration.icp(source, target, device=dev, history=hist)
    out["icp"] = (m_icp, hist)
    shape = (40, 36, 32)
    fod, field, wm = nav_fields(torch.device("cpu"), shape, NAV_LMAX)
    seeds = (np.array(shape, np.float32) / 2
             + rng.uniform(-4, 4, (48, 3))).astype(np.float32)
    paths, valid = tractography.track_streamlines(field, wm, seeds, 0.5, 30, device=dev)
    out["tracts"] = (paths.cpu().numpy(), valid.cpu().numpy())
    draws = tractography.TrackDraws.sample(torch.Generator().manual_seed(2), 48, 30, 16,
                                           torch.device("cpu"))
    paths, valid = tractography.track_streamlines_probabilistic(
        fod, wm, seeds, n_steps=30, lmax=NAV_LMAX, draws=draws, device=dev)
    out["tracts probabilistic"] = (paths.cpu().numpy(), valid.cpu().numpy())
    roi = rng.uniform(0, 80, (5000, 3)).astype(np.float32)
    pos, axis = (torch.tensor(v, dtype=torch.float32, device=dev)
                 for v in ([40.0, 30.0, 50.0], [0.0, 0.6, 0.8]))
    out["efield"] = efield.debug_efield_norms(torch.from_numpy(roi).to(dev), pos,
                                              axis).cpu().numpy()
    out["mep"] = mep.interpolate_mep_surface(
        roi, roi[:NAV_MARKERS], rng.uniform(50, 1000, NAV_MARKERS), {"gaussian_radius": 6.0},
        device=dev)
    return out


def _compare_nav(got: dict, want: dict) -> list:
    """Card against CPU: peels equal (else triangle counts within 1% and a
    symmetric Hausdorff distance under half a millimetre, said so), JFA bit
    for bit, ICP's matches at every iteration and its matrix within 1e-5,
    tract validity equal and paths within NAV_PATH_ATOL, e-field and MEP
    within a relative 1e-5.  Returns a note per comparison."""
    notes = []
    for mode in ("remesh", "volume", "none"):
        g, w = got[f"peel {mode}"], want[f"peel {mode}"]
        if len(g) != len(w):
            raise AssertionError(f"peel {mode}: {len(g)} peels against the CPU's {len(w)}")
        exact = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                    for a, b in zip(g, w))
        if exact:
            for a, b in zip(g, w):
                if not np.allclose(a[2], b[2], rtol=1e-6, atol=1e-3):
                    raise AssertionError(f"peel {mode}: intensities differ from the CPU's")
            notes.append(f"peel {mode} equal")
            continue
        worst = 0.0
        for k, (a, b) in enumerate(zip(g, w)):
            h = _hausdorff(a[0], b[0])
            worst = max(worst, h)
            if abs(len(a[1]) - len(b[1])) > 0.01 * len(b[1]) or h > 0.5:
                raise AssertionError(f"peel {mode} {k}: {len(a[1])} against {len(b[1])} "
                                     f"triangles, Hausdorff {h:.3f} mm")
        notes.append(f"peel {mode} within bounds (Hausdorff {worst:.4f} mm)")
    for k in [k for k in want if k.startswith("jfa")]:
        (go, gd), (wo, wd) = got[k], want[k]
        if not (np.array_equal(go, wo) and np.array_equal(gd, wd)):
            raise AssertionError(f"{k}: {int((go != wo).sum())} owners differ from the CPU's, "
                                 f"distances by up to {np.abs(gd - wd).max()}")
        notes.append(f"{k}^3 bit for bit")
    (gm, gh), (wm, wh) = got["icp"], want["icp"]
    if len(gh) != len(wh) or not all(np.array_equal(a, b) for a, b in zip(gh, wh)) \
            or np.abs(gm - wm).max() > 1e-5:
        raise AssertionError(
            f"icp: {len(gh)} iterations against the CPU's {len(wh)}, matches differ in "
            f"{[int((a != b).sum()) for a, b in zip(gh, wh)]}, matrices by "
            f"{np.abs(gm - wm).max():.2e}")
    notes.append(f"icp: {len(wh)} iterations, same matches")
    for k in ("tracts", "tracts probabilistic"):
        (gp, gv), (wp, wv) = got[k], want[k]
        if not np.array_equal(gv, wv) or np.abs(gp - wp).max() > NAV_PATH_ATOL:
            raise AssertionError(f"{k}: validity differs in {int((gv != wv).sum())} entries, "
                                 f"paths by up to {np.abs(gp - wp).max()}")
        notes.append(f"{k}: {int(wv[-1].sum())} of {wv.shape[1]} alive, paths within "
                     f"{np.abs(gp - wp).max():.2e}")
    for k in ("efield", "mep"):
        if not np.allclose(got[k], want[k], rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{k}: differs from the CPU's")
    return notes


def _session(dev, fod, wm, roi: np.ndarray, seconds: float, tracker_id: str = None,
             tracker_kw: dict = None, bus=None, efield_api=None, coordinates=None,
             during=None, tracts=(64, 120)) -> dict:
    """``Navigation`` with a tracker at NAV_POLL_HZ (the debug-approach one
    unless ``tracker_id`` and ``tracker_kw`` name another), the
    probabilistic tract worker on ``fod`` and the e-field worker on ``roi``
    (through ``efield_api`` when given; ``tracts`` a pose: streamlines and
    steps), for ``seconds``: counts, shapes and
    latencies from a pose's timestamp to its publication.  ``bus`` is the
    session's bus (a new one by default), ``coordinates`` replaces the
    tracker's ``TrackerCoordinates`` before it connects, and ``during(bus)``
    runs while the session does."""
    from invesalius3_tpu_torch import events
    from invesalius3_tpu_torch.navigation import navigation
    from invesalius3_tpu_torch.navigation.tracker import TRACKER_DEBUG_APPROACH

    bus = bus if bus is not None else events.Publisher()
    nav = navigation.Navigation(bus=bus, device=dev)
    if coordinates is not None:
        nav.tracker.coordinates = coordinates
    if not nav.tracker.connect(tracker_id or TRACKER_DEBUG_APPROACH,
                               poll_hz=const.NAV_POLL_HZ, **(tracker_kw or {})):
        raise AssertionError(f"the tracker {tracker_id} did not connect")
    while not nav.tracker.get_coordinates()[0].any():
        time.sleep(0.01)
    for i in range(3):
        time.sleep(0.1)
        nav.tracker.set_tracker_fiducial(i)
    m_true = transforms.euler_matrix(0.05, -0.03, 0.02)
    m_true[:3, 3] = [4.0, -3.0, 2.0]
    trk = nav.tracker.tracker_fiducials[:, :3]
    for i, p in enumerate((np.c_[trk, np.ones(3)] @ m_true.T)[:, :3]):
        nav.image.set(i, p)
    fre = nav.estimate_tracker_to_image_transform()
    hi = np.array(fod.shape[:3]) - 1
    nav.tract_params = {
        "fod_sh": fod, "stop_mask": wm, "n_tracts_total": tracts[0], "n_steps": tracts[1],
        "world_to_vox": lambda p: np.clip(np.asarray(p)[::-1] / NAV_FOD_MM, 0, hi)}
    nav.efield_params = {"roi_vertices": roi, "roi_ids": np.arange(len(roi)),
                         "debug": efield_api is None, "api": efield_api}
    seen = {"navigation.update_scene": [], "navigation.tracts": [], "navigation.efield": []}
    shapes = {"navigation.tracts": set(), "navigation.efield": set()}

    def listener(topic):
        def on(**kw):
            seen[topic].append(time.monotonic() - kw["timestamp"])
            if topic == "navigation.tracts":
                shapes[topic].add(kw["paths"].shape)
            elif topic == "navigation.efield":
                shapes[topic].add(kw["enorms"].shape)
        return on

    listeners = [(listener(topic), topic) for topic in seen]
    for fn, topic in listeners:
        bus.subscribe(fn, topic)
    nav.start_navigation(poll_hz=const.NAV_POLL_HZ)
    threads = [nav._coreg, nav._updater, nav._tract_thread, nav._efield_thread]
    try:
        t_end = time.monotonic() + seconds
        if during is not None:
            during(bus)
        time.sleep(max(0.0, t_end - time.monotonic()))
    finally:
        nav.stop_navigation()
        nav.tracker.disconnect()
        for fn, topic in listeners:
            bus.unsubscribe(fn, topic)
    if any(th.is_alive() for th in threads):
        raise AssertionError("a navigation thread outlived stop_navigation")
    out = {"fre": fre, "seconds": seconds}
    for topic, lat in seen.items():
        lat_ms = np.array(lat) * 1e3
        out[topic] = {"count": len(lat),
                      "median_ms": float(np.median(lat_ms)) if len(lat) else None,
                      "p95_ms": float(np.percentile(lat_ms, 95)) if len(lat) else None}
    out["shapes"] = {k: sorted(v) for k, v in shapes.items()}
    return out


def navigation_phase(dev, n: int = NAV_MRI_N, jfa_n: int = NAV_JFA_N,
                     voronoi_n: int = NAV_VORONOI_N, icp_targets: int = NAV_ICP_TARGETS,
                     fod_shape=NAV_FOD_SHAPE, bundle=NAV_BUNDLE, roi_n: int = NAV_ROI,
                     session_s: float = NAV_SESSION_S, small: dict = None) -> dict:
    """Phase 14: the neuronavigation path.  The small sequence on the card
    and the CPU first (``small`` overrides ``nav_sequence``'s sizes), then
    every op at full width, timed; then the navigation session.  Returns
    the per-op record and the session's counts."""
    from invesalius3_tpu_torch.navigation import efield, mep, tractography
    from invesalius3_tpu_torch.ops import brain_peel, registration, voronoi

    log(f"[14] the neuronavigation path (peel {n}^3, JFA {jfa_n}^3, ICP "
        f"{NAV_ICP_SOURCE} x {icp_targets}, FOD {fod_shape} lmax {NAV_LMAX}, session "
        f"{session_s:.0f} s)")
    if dev.type == "cuda":
        log("  card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    kernels.reset_launches()
    rays.reset_launches()
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    got = nav_sequence(dev, **(small or {}))
    want = nav_sequence(cpu, **(small or {}))
    notes = _compare_nav(got, want)
    log(f"  small sizes on {dev.type} and on the CPU ({time.perf_counter() - t_phase:.1f} s): "
        + "; ".join(notes))
    del got, want

    log("  per op at full width (wall ms, device synchronised):")
    ops = OpTimes(dev)
    image = _mri(n)
    mask = np.where(image > NAV_PEEL_THRESHOLD, 255, 0).astype(np.uint8)
    brains = {}
    for mode in ("remesh", "volume", "none"):
        brains[mode] = ops(f"Brain {mode}", lambda ch, mode=mode: brain_peel.Brain(
            image, mask, n_peels=5, peel_depth_mm=1.0, regularize=mode, device=dev))
        log(f"      {_peel_checks(mode, brains[mode], image, 5)}; stages (s): "
            + ", ".join(f"{k} {v:.3f}" for k, v in brains[mode].times.items()))

    rng = np.random.default_rng(3)
    sites = rng.integers(0, jfa_n, (NAV_JFA_SITES, 3)).astype(np.int32)
    owners, dist = ops("jump_flooding", lambda ch: voronoi.jump_flooding(
        (jfa_n,) * 3, sites, device=dev))
    flat = torch.as_tensor(rng.choice(jfa_n ** 3, min(10 ** 5, jfa_n ** 3), replace=False),
                           device=dev)
    zyx = np.stack(np.unravel_index(flat.cpu().numpy(), (jfa_n,) * 3), axis=1)
    d2 = ((zyx[:, None, :].astype(np.int64) - sites[None].astype(np.int64)) ** 2).sum(-1)
    order = np.sort(d2, axis=1)
    decided = order[:, 0] != order[:, 1]
    own = owners.reshape(-1)[flat].cpu().numpy()
    own_d2 = d2[np.arange(len(own)), own - 1]
    wrong = decided & (own != np.argmin(d2, axis=1) + 1)
    excess = float((np.sqrt(own_d2) - np.sqrt(order[:, 0]))[wrong].max()) if wrong.any() else 0.0
    # JFA is approximate (the JAX package's algorithm, which the port keeps
    # bit for bit): a rare voxel keeps a site slightly farther than the
    # nearest one
    if wrong.sum() > 1e-3 * decided.sum() or excess > 1.0 or not np.array_equal(
            dist.reshape(-1)[flat].cpu().numpy(), np.sqrt(own_d2).astype(np.float32)):
        raise AssertionError(f"jump_flooding: {int(wrong.sum())} owners not the nearest site "
                             f"(at most {excess:.3f} voxel farther), or a distance differs")
    log(f"      {int(decided.sum())} strictly decided voxels of {len(own)} sampled: "
        f"{int(wrong.sum())} owners not the exact nearest site (at most {excess:.3f} voxel "
        "farther); every distance the owner's site's")
    del owners, dist, flat
    v_sites = rng.integers(0, voronoi_n, (NAV_JFA_SITES, 3)).astype(np.int32)
    ops("jump_flooding_normalized", lambda ch: voronoi.jump_flooding_normalized(
        (voronoi_n,) * 3, v_sites, device=dev), repeat=False)
    for fn in (0, 1):
        ops(f"floodfill_voronoi d{fn}", lambda ch, fn=fn: voronoi.floodfill_voronoi(
            (voronoi_n,) * 3, v_sites, fn, device=dev))
    _sync(dev)

    surf = head_surfaces(image, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    n_surf = surf.shape[1]
    target = surf[:, torch.randperm(n_surf, generator=g, device=dev)[:icp_targets]].t()
    target = target.contiguous()
    del surf
    pick = torch.randperm(target.shape[0], generator=g, device=dev)[:NAV_ICP_SOURCE]
    m_true = transforms.euler_matrix(*NAV_ICP_ROTATION)
    m_true[:3, 3] = NAV_ICP_SHIFT
    truth = target[pick].cpu().numpy().astype(np.float64)
    source = (np.c_[truth, np.ones(len(truth))] @ np.linalg.inv(m_true).T)[:, :3]
    m_icp, err = ops("icp", lambda ch: registration.icp(
        source, target, max_iterations=NAV_ICP_ITERATIONS, tolerance=0.0, device=dev))
    moved = (np.c_[source, np.ones(len(source))] @ m_icp.T)[:, :3]
    miss = float(np.abs(moved - truth).max())
    if miss > 0.2:
        raise AssertionError(f"icp: the known transform recovered within {miss:.3f} mm")
    log(f"      {n_surf} surface vertices, {target.shape[0]} sampled; recovered within "
        f"{miss:.4f} mm, RMS {err:.4f} mm")
    del target

    fod, field, wm = nav_fields(dev, tuple(fod_shape), NAV_LMAX)
    centre = np.array(fod_shape, np.float32) / 2
    pose_seeds = tractography.seed_grid(centre, 64).astype(np.float32)
    ops("track_streamlines 64 x 120", lambda ch: tractography.track_streamlines(
        field, wm, pose_seeds, 0.5, 120, device=dev))
    gen = torch.Generator(device=dev).manual_seed(5)
    ops("probabilistic 64 x 120 x 16", lambda ch: tractography.track_streamlines_probabilistic(
        fod, wm, pose_seeds, gen, n_steps=120, lmax=NAV_LMAX, device=dev))
    n_seeds, n_steps, k = bundle
    bundle_seeds = (centre + rng.uniform(-20, 20, (n_seeds, 3))).astype(np.float32)
    paths, valid = ops(f"probabilistic bundle {n_seeds} x {n_steps} x {k}",
                       lambda ch: tractography.track_streamlines_probabilistic(
                           fod, wm, bundle_seeds, gen, n_steps=n_steps, k_candidates=k,
                           lmax=NAV_LMAX, device=dev))
    if not torch.isfinite(paths).all() or not bool(valid[0].any()):
        raise AssertionError("the tract bundle is not finite or starts dead")
    rate = n_seeds * n_steps / (ops.stats[f"probabilistic bundle {n_seeds} x {n_steps} x {k}"]
                                ["ms"] / 1e3)
    log(f"      {rate:.3e} streamline steps/s; {int(valid[-1].sum())} of {n_seeds} alive "
        f"after {n_steps} steps")
    del paths, valid

    roi = (rng.uniform(-60, 60, (roi_n, 3)) + 120).astype(np.float32)
    roi_d = torch.from_numpy(roi).to(dev)
    pos = torch.tensor([120.0, 120.0, 180.0], device=dev)
    axis = torch.tensor([0.0, 0.0, -1.0], device=dev)
    norms = ops(f"debug_efield_norms {roi_n}", lambda ch: efield.debug_efield_norms(
        roi_d, pos, axis))
    if tuple(norms.shape) != (roi_n,) or not torch.isfinite(norms).all():
        raise AssertionError("e-field norms: wrong shape or not finite")
    peel0 = brains["remesh"].peels[0]["verts"]
    marker_pos = peel0[rng.choice(len(peel0), NAV_MARKERS, replace=False)]
    field_uv = ops(f"interpolate_mep_surface {len(peel0)} x {NAV_MARKERS}",
                   lambda ch: mep.interpolate_mep_surface(
                       peel0, marker_pos, rng.uniform(50, 1000, NAV_MARKERS), device=dev))
    if field_uv.shape != (len(peel0),) or not np.isfinite(field_uv).all() or \
            field_uv.max() <= 0:
        raise AssertionError("MEP field: wrong shape, not finite or empty")

    t0 = time.perf_counter()
    sess = _session(dev, fod, wm, roi, session_s)
    scene, tracts, ef = (sess[k] for k in ("navigation.update_scene", "navigation.tracts",
                                           "navigation.efield"))
    log(f"  session ({time.perf_counter() - t0:.1f} s, FRE {sess['fre']:.2e} mm): " + "; ".join(
        f"{k.split('.')[1]} {v['count']} (pose to publish median {v['median_ms'] or 0:.3f} ms, "
        f"p95 {v['p95_ms'] or 0:.3f} ms)" for k, v in sess.items() if k.startswith("navigation.")))
    log(f"    shapes: {sess['shapes']}")
    if scene["count"] < 100 or tracts["count"] < 1 or ef["count"] < 1 or \
            sess["shapes"]["navigation.tracts"] != [(121, 64, 3)] or \
            sess["shapes"]["navigation.efield"] != [(roi_n,)]:
        raise AssertionError(f"session: {sess}")
    del fod, field, wm

    launches = {"sweeps": dict(kernels.LAUNCHES),
                "rays": {k: dict(v) for k, v in rays.LAUNCHES.items()}}
    seconds = time.perf_counter() - t_phase
    log(f"  phase [14]: {seconds:.1f} s; kernel launches on this path: {launches} "
        "(no kernel lies on it)")
    if any(kernels.LAUNCHES.values()) or any(
            v for per_axis in rays.LAUNCHES.values() for v in per_axis.values()):
        raise AssertionError(f"a hot-path kernel launched on the navigation path: {launches}")
    return {"ops": ops.stats, "session": sess, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 15: the viewer server
# ---------------------------------------------------------------------------

SERVER_N = 512  # make_ct(512), int16 at 0.5 mm: 256 MiB on the card
SCENE_SHELL_N = 64  # the scene's surface: a sphere shell's mask at 64^3, spread over the CT
SCENE_MAX_TRIANGLES = 200_000  # the scene renderer decimates a surface above this
SERVER_REPS = 5  # each GET's wall time is the median of this many
# the projection types phase 15 drives, and their RGB tolerance against the
# direct frame (tests/test_torch_slab_viewer.py:7-8: MIDA within 1 on the
# plane, at most 2 levels at WW 400; the others exact)
SERVER_FRAMES = {const.PROJECTION_NORMAL: 0, const.PROJECTION_MaxIP: 0,
                 const.PROJECTION_LMIP: 0, const.PROJECTION_MIDA: 2}


class _Client:
    """The phase's HTTP client: every call's wall ms, by endpoint (a GET
    called ``reps`` times in a row; a POST each time it is sent)."""

    def __init__(self, port: int, reps: int):
        self.base = f"http://127.0.0.1:{port}"
        self.reps = reps
        self.calls = {}

    @property
    def ms(self) -> dict:
        """Endpoint -> (median wall ms, calls)."""
        return {k: (float(np.median(v)), len(v)) for k, v in self.calls.items()}

    def _open(self, req):
        import urllib.request

        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            out = (r.status, r.headers.get("Content-Type"), r.read())
        return (time.perf_counter() - t0) * 1e3, out

    def get(self, path: str, reps: int = None, name: str = None):
        """GET ``path``; its wall ms is the median of ``reps`` calls."""
        out = None
        for _ in range(reps or self.reps):
            ms, out = self._open(self.base + path)
            self.calls.setdefault(name or "GET " + path, []).append(ms)
        return out

    def post(self, path: str, body: dict, name: str = None):
        import urllib.request

        req = urllib.request.Request(self.base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        ms, (code, _, data) = self._open(req)
        self.calls.setdefault(name or "POST " + path, []).append(ms)
        return code, json.loads(data)


class _Uncounted:
    """Calls made to check the server (direct oracles) launch kernels too;
    the launch counts are put back as they were after such a call, so the
    counts read at the end are the server's alone."""

    def __enter__(self):
        self.saved = (dict(kernels.LAUNCHES), {k: dict(v) for k, v in rays.LAUNCHES.items()})

    def __exit__(self, *exc):
        kernels.LAUNCHES.update(self.saved[0])
        for k, v in self.saved[1].items():
            rays.LAUNCHES[k].update(v)
        return False


def _png_rgb(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def _ok(code, out, what: str):
    if code != 200:
        raise AssertionError(f"{what}: HTTP {code} {out}")
    return out


def _host_histogram(ct: np.ndarray, edges) -> np.ndarray:
    """numpy's histogram of an int16 volume on explicit float32 edges (the
    bin whose left edge is the last one <= the value, the last edge in the
    last bin), by value: each of the 65536 values binned once."""
    e = np.asarray(edges, np.float32)
    per_value = np.bincount((ct.astype(np.int32) + 32768).ravel(), minlength=65536)
    values = (np.arange(65536) - 32768).astype(np.float32)
    idx = np.searchsorted(e, values, side="right")
    idx[values == e[-1]] = len(e) - 1
    keep = (idx >= 1) & (idx <= len(e) - 1) & (per_value > 0)
    return np.bincount(idx[keep] - 1, weights=per_value[keep],
                       minlength=len(e) - 1).astype(np.int64)


def viewer_server_phase(dev, tmp: Path, n: int = SERVER_N, reps: int = SERVER_REPS) -> dict:
    """Phase 15: the port's ViewerServer over make_ct(n) on ``dev``, driven
    over HTTP as the web client drives it; each result held to the direct
    call on the same device.  The STL (300 MB at 512^3) is fetched once,
    and the scene once, on a sphere shell's surface imported through the
    server below the renderer's 200k-triangle decimation threshold (the
    renderer decimates a larger surface by QEM on every call, about a
    minute at 512^3, as the JAX renderer does), the large surface hidden
    meanwhile.  Returns the wall ms per endpoint, the launch counts and the
    peak memory."""
    import os

    from invesalius3_tpu_torch import server as server_mod
    from invesalius3_tpu_torch.models import segment as seg_mod
    from invesalius3_tpu_torch.utils import logging as ilog

    log(f"[15] the viewer server at {n}^3")
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"  card: {card}")
    os.environ["XDG_CONFIG_HOME"] = str(tmp / "config")  # session, presets, language
    os.environ.pop("INV3_LANGUAGE", None)
    download.download_url_to_file = _no_download
    t_phase = time.perf_counter()
    ct = pipeline.make_ct(n)
    slc = Slice(Volume.from_numpy(ct, spacing=pipeline.SPACING, device=dev))
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    rays.reset_launches()
    srv = server_mod.ViewerServer(slc).start()
    cl = _Client(srv.port, reps)
    try:
        # 1-2: the page, the status and the window
        _, ctype, page = cl.get("/")
        if page != (server_mod.VIEWER_ROOT / "index.html").read_bytes() or "html" not in ctype:
            raise AssertionError("GET / is not the port's index.html")
        st = json.loads(cl.get("/api/status")[2])
        if st["volume_shape"] != [n, n, n]:
            raise AssertionError(f"status: {st}")
        _ok(*cl.post("/api/window", {"ww": 400.0, "wl": 40.0}), "window")

        # 3: frames, each against the direct frame on the same device
        mid = n // 2
        slab = max(1, n // 8)
        for o in ORIENTATIONS:
            for p, atol in SERVER_FRAMES.items():
                q = "" if p == const.PROJECTION_NORMAL else f"?projection={p}&slabs={slab}"
                name = f"GET /api/slice/{o}/{mid} {const.PROJECTION_NAMES[p]}"
                got = _png_rgb(cl.get(f"/api/slice/{o}/{mid}{q}", name=name)[2])
                with _Uncounted():
                    want = slc.get_rendered_slice(
                        o, mid, projection=None if p == const.PROJECTION_NORMAL else p,
                        slabs=None if p == const.PROJECTION_NORMAL else slab,
                        measures=srv.state.measures)
                d = int(np.abs(got.astype(int) - want.astype(int)).max())
                if got.shape != want.shape or d > atol:
                    raise AssertionError(f"{name}: the server's frame differs by {d}")

        # 4: threshold
        lo, hi = const.THRESHOLD_PRESETS_CT["Bone"]
        out = _ok(*cl.post("/api/threshold", {"tmin": lo, "tmax": hi}), "threshold")
        with _Uncounted():
            want = int((thr_ops.threshold_new_mask(slc.matrix, lo, hi) >= 127).sum())
        if out["voxels"] != want or want == 0:
            raise AssertionError(f"threshold: {out['voxels']} voxels, direct {want}")

        # 5: floodfill (threshold method) from a bone voxel, a brush stroke, stats
        seed = [int(v) for v in np.unravel_index(
            int(torch.argmax(slc.current_mask.data.reshape(-1).to(torch.int16))), (n,) * 3)]
        out = _ok(*cl.post("/api/floodfill", {"seed": seed, "tmin": lo, "tmax": hi}),
                  "floodfill")
        if out["voxels"] <= 0:
            raise AssertionError(f"floodfill: {out}")
        stroke = [[mid, mid, x] for x in range(mid - 40, mid + 40, 4)]
        out = _ok(*cl.post("/api/brush", {"strokes": stroke, "radius_mm": 3.0}), "brush")
        if out["stamps"] != len(stroke):
            raise AssertionError(f"brush: {out}")
        stats = _ok(*cl.post("/api/mask/stats", {}), "mask stats")
        if stats["voxels"] != out["voxels"] or not stats["area_mm2"] > 0:
            raise AssertionError(f"mask stats: {stats}")

        # 6: watershed from three markers (the sweep kernels)
        marks = np.argwhere(pipeline.bench_markers(n))
        labels_at = pipeline.bench_markers(n)[tuple(marks.T)]
        body = {"markers": [{"position": [int(c) for c in m], "label": int(lb)}
                            for m, lb in zip(marks, labels_at)]}
        out = _ok(*cl.post("/api/watershed", body), "watershed")
        with _Uncounted():
            ref = watershed.watershed(slc.matrix, torch.from_numpy(
                pipeline.bench_markers(n)).to(dev), algorithm="Watershed")
            same = bool(torch.equal((ref == 1).to(torch.uint8) * 253,
                                    slc.current_mask.data))
            n_ref = int((ref == 1).sum())
            del ref
        if not same or out["voxels"] != n_ref:
            raise AssertionError(f"watershed: {out['voxels']} voxels, direct {n_ref}, "
                                 f"mask equal {same}")

        # 7: the surface (context-aware smoothing) and its STL
        surf = _ok(*cl.post("/api/surface", {"algorithm": "ca_smoothing"}), "surface")
        stl = cl.get(f"/api/surface/{surf['index']}.stl", reps=1,
                     name="GET /api/surface/{i}.stl")[2]
        with _Uncounted():
            direct = create_surface_from_mask(slc.current_mask, slc.spacing,
                                              algorithm="ca_smoothing")
            direct.export(str(tmp / "direct.stl"))
        if stl != (tmp / "direct.stl").read_bytes():
            raise AssertionError("surface: the server's STL differs from the direct one")
        log(f"  surface: {surf['triangles']} triangles, STL {len(stl)} bytes (equal)")
        del stl, direct

        # 8: volume render and the surface scene.  The scene shows a surface
        # below the renderer's 200k-triangle decimation threshold (a sphere
        # shell imported through the server), the large one hidden meanwhile:
        # QEM decimation stays driven by phase [9]
        img = _png_rgb(cl.get("/api/render?preset=Bone&size=512")[2])
        sv, sf = marching.mask_to_surface(_shell(SCENE_SHELL_N, 0.3 * SCENE_SHELL_N,
                                                 0.4 * SCENE_SHELL_N),
                                          (n * float(pipeline.SPACING[0]) / SCENE_SHELL_N,) * 3,
                                          device=dev)
        mesh_io.write_stl(tmp / "shell.stl", sv, sf)
        small = _ok(*cl.post("/api/surface/import", {"path": str(tmp / "shell.stl")}),
                    "surface import")
        if not 0 < small["triangles"] < SCENE_MAX_TRIANGLES:
            raise AssertionError(f"scene surface: {small['triangles']} triangles")
        _ok(*cl.post("/api/surface/props", {"index": surf["index"], "visible": False}), "hide")
        scene = _png_rgb(cl.get("/api/render_scene?size=256", reps=1)[2])
        _ok(*cl.post("/api/surface/props", {"index": surf["index"], "visible": True}), "show")
        _ok(*cl.post("/api/surface/remove", {"index": small["index"]}), "surface remove")
        if img.shape != (512, 512, 3) or scene.shape != (256, 256, 3) or img.max() == 0 \
                or len(np.unique(scene.reshape(-1, 3), axis=0)) < 2:
            raise AssertionError("render: empty frames")
        log(f"  scene: a {small['triangles']}-triangle surface, the {surf['triangles']}-triangle "
            "one hidden")

        # 9: measures, a pick, the histogram
        for body in ({"kind": "linear", "p1": [10.0, 20.0, 30.0], "p2": [100.0, 120.0, 30.0]},
                     {"kind": "angular", "p0": [1, 0, 0], "p1": [0, 0, 0], "p2": [0, 1, 0]},
                     {"kind": "density_ellipse", "location": "AXIAL", "slice_number": mid,
                      "center": [mid, mid], "ry": n / 8, "rx": n / 6}):
            dens = _ok(*cl.post("/api/measures", body,
                                name=f"POST /api/measures {body['kind']}"), body["kind"])
        plane = slc.matrix[mid].cpu().numpy()
        yy, xx = np.mgrid[:n, :n]
        inside = ((yy - mid) / (n / 8)) ** 2 + ((xx - mid) / (n / 6)) ** 2 <= 1.0
        if abs(dens["value"] - float(plane[inside].mean())) > 1e-6 * max(1.0, abs(dens["value"])):
            raise AssertionError(f"density: {dens['value']}")
        c = n * float(pipeline.SPACING[0]) / 2
        hit = _ok(*cl.post("/api/surface/pick", {"origin": [c, c, 10 * c],
                                                 "dir": [0.0, 0.0, -1.0]}), "pick")
        if not hit["hit"]:
            raise AssertionError(f"pick: {hit}")
        h = json.loads(cl.get("/api/histogram?bins=128")[2])
        if not np.array_equal(np.asarray(h["counts"]), _host_histogram(ct, h["edges"])) \
                or sum(h["counts"]) != n ** 3:
            raise AssertionError("histogram: counts differ from numpy's on the same edges")

        # 10: a navigation round with the pedal and mTMS
        _ok(*cl.post("/api/nav/connect", {"tracker_id": "debug_random", "poll_hz": 200}),
            "nav connect")
        time.sleep(0.05)
        for i in range(3):
            cl.post("/api/nav/fiducial/tracker", {"index": i})
            time.sleep(0.02)
            cl.post("/api/nav/fiducial/image", {"index": i, "position": [i * 10.0, 0.0, 5.0]})
        _ok(*cl.post("/api/nav/register", {}), "register")
        _ok(*cl.post("/api/nav/start", {"poll_hz": 100}), "nav start")
        deadline, pedal = time.monotonic() + 10, {}
        while "marker_id" not in pedal and time.monotonic() < deadline:
            time.sleep(0.05)
            pedal = _ok(*cl.post("/api/pedal", {"pressed": True}, name="POST /api/pedal"),
                        "pedal")
        if "marker_id" not in pedal:
            raise AssertionError("pedal: no marker dropped while navigating")
        pp = tmp / "pulses.txt"
        pp.write_text("\n".join([f"# header {i}" for i in range(18)] + [
            f"{x}_{y}_0\tc1\tc2" for x in range(-3, 4) for y in range(-3, 4)]) + "\n")
        if _ok(*cl.post("/api/nav/mtms/load", {"path": str(pp)}), "mtms")["n_keys"] != 49:
            raise AssertionError("mtms: parameter table")
        tgt = _ok(*cl.post("/api/nav/mtms/target", {
            "coil_pose": [10.0, 20.0, 30.0, 0, 0, 0],
            "brain_target": [11.0, 22.0, 30.0, 0, 0, 0]}), "mtms target")
        if not tgt["fired"]:
            raise AssertionError(f"mtms: {tgt}")
        _ok(*cl.post("/api/nav/stop", {}), "nav stop")
        _ok(*cl.post("/api/nav/disconnect", {}), "nav disconnect")

        # 11: a DL job (the trachea CT model, seeded random weights)
        _ok(*cl.post("/api/segment/dl", {"model": "trachea", "allow_random_init": True,
                                         "batch_size": 4}), "dl start")
        t0, st = time.perf_counter(), {}
        while not st.get("done"):
            time.sleep(0.2)
            st = _ok(*cl.post("/api/segment/dl/status", {},
                              name="POST /api/segment/dl/status"), "dl status")
        cl.calls["DL job, start to landed mask"] = [(time.perf_counter() - t0) * 1e3]
        if st["error"] is not None or "mask_index" not in st:
            raise AssertionError(f"dl job: {st}")
        with _Uncounted():
            _, mask = seg_mod.TracheaSegmenter(allow_random_init=True, device=dev).segment(
                slc.matrix, 0.5, 4)
        landed = slc.masks[st["mask_index"]].data.cpu().numpy()
        if not np.array_equal(landed, (mask > 0).astype(np.uint8) * 255):
            raise AssertionError("dl job: the landed mask differs from the direct one")

        # 12: language, events, log
        cat = _ok(*cl.post("/api/i18n", {"language": "pt_BR"}), "i18n")
        back = _ok(*cl.post("/api/i18n", {"language": "en"}), "i18n back")
        if cat["current"] != "pt_BR" or back["current"] != "en" or not cat["catalog"]:
            raise AssertionError("i18n round trip")
        evs = json.loads(cl.get("/api/events")[2])
        logs = json.loads(cl.get("/api/log")[2])
        if not evs or "/api/watershed" not in [e["message"] for e in logs]:
            raise AssertionError("events / log")
    finally:
        srv.stop()
    thread = getattr(srv.state, "warm_thread", None)
    if thread is not None:
        thread.join()
    warm_fail = ilog.query_log(search="warm-up failed")
    if warm_fail:
        raise AssertionError(f"the shear-cache warm-up failed: {warm_fail}")
    launches = {"sweeps": dict(kernels.LAUNCHES),
                "rays": {k: dict(v) for k, v in rays.LAUNCHES.items()}}
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    seconds = time.perf_counter() - t_phase
    log(f"  wall ms per endpoint, the median of its calls ({card}; a GET {reps} calls, "
        "the STL and the scene one; a POST once unless repeated):")
    for k, (v, calls) in cl.ms.items():
        log(f"    {k}: {v:.3f}" + (f" ({calls} calls)" if calls > 1 else ""))
    log(f"  launches by the server: {launches}; peak device memory {peak:.2f} GiB; "
        f"phase [15]: {seconds:.1f} s ({card})")
    if dev.type == "cuda" and (min(launches["sweeps"].values()) <= 0 or any(
            launches["rays"][k][a] <= 0 for k in RAY_FNS for a in (0, 1, 2))):
        raise AssertionError(f"a kernel never launched below the server: {launches}")
    return {"ms": cl.ms, "launches": launches, "peak_gib": peak, "seconds": seconds}



# ---------------------------------------------------------------------------
# phase 16: the network and the hardware trackers
# ---------------------------------------------------------------------------

NET_N = 512  # make_ct(512) as 512 DICOM files of 512^2 on the mini-PACS
NET_SECOND = 128  # the study's second, smaller series
NET_POSES = 300  # replayed poses a tracker (2.5 s at 120 Hz, then looped)
NET_TRACKER_S = 2.0  # the Navigation session of each tracker
NET_GRID_N = 256  # the T1 phantom (phase 14's) whose scalp the grids snap to
NET_MIRROR_S = 2.0  # the Navigation session with the remote mirror on
NET_STUDY_DESCRIPTION = "HEAD CT"  # the mini-PACS's catalogue entry
NET_HARDWARE = ("polhemus_serial", "polaris_ndi", "optitrack", "claron_mtc")


def _free_port() -> int:
    """A port of 127.0.0.1 nothing listens on now (picked ahead of a C-MOVE,
    whose destination a PACS must know)."""
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _implicit_text(group: int, elem: int, text: str) -> bytes:
    import struct

    b = text.encode("ascii")
    if len(b) % 2:
        b += b"\x00" if group == 0x0020 else b" "
    return struct.pack("<HHI", group, elem, len(b)) + b


class MiniPACS:
    """A PACS on 127.0.0.1 to check the port's client against (scaffolding
    of the check, not a feature of the port).  It answers C-ECHO, a
    study-root C-FIND that lists its one study when the patient name
    matches, and a C-MOVE of that study: every instance C-STOREd with the
    port's ``send_c_store`` to 127.0.0.1 at ``store_port``.  ``instances``
    is [(SOP instance UID, explicit VR LE dataset bytes)]; ``row`` the
    study's identifier (tag name -> text).  ``move_s`` holds the seconds
    from each C-MOVE-RQ's identifier to its final response, ``moved_bytes``
    the datasets' bytes C-STOREd."""

    def __init__(self, instances, row: dict, store_port: int, timeout: float = 120.0):
        import socket
        import socketserver

        from invesalius3_tpu_torch.net import dicom_net

        self.instances = list(instances)
        self.row = dict(row)
        self.store_port = store_port
        self.timeout = timeout
        self.move_s, self.moved_bytes = [], 0
        pacs = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                self.request.settimeout(pacs.timeout)
                self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    pacs._serve(self.request, dicom_net)
                except OSError:
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        self._thread = None

    def start(self) -> "MiniPACS":
        import threading

        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={"poll_interval": 0.05}, name="mini-pacs",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _serve(self, s, dn) -> None:
        import fnmatch
        import struct

        def recv_pdu():
            head = dn._recv_exact(s, 6)
            if head is None:
                return None, b""
            body = dn._recv_exact(s, struct.unpack(">I", head[2:6])[0])
            if body is None:
                return None, b""
            return head[0], body

        def el(elem, payload):
            return struct.pack("<HHI", 0x0000, elem, len(payload)) + payload

        def send(ctx, field, msg_id, status, sop_class, dataset=None):
            body = b"".join([
                el(0x0002, dn._uid(sop_class)), el(0x0100, struct.pack("<H", field)),
                el(0x0120, struct.pack("<H", msg_id)),
                el(0x0800, struct.pack("<H", 0x0101 if dataset is None else 0x0000)),
                el(0x0900, struct.pack("<H", status))])
            body = el(0x0000, struct.pack("<I", len(body))) + body
            out = dn._pdu(0x04, struct.pack(">IB", len(body) + 2, ctx) + b"\x03" + body)
            if dataset is not None:
                out += dn._pdu(0x04, struct.pack(">IB", len(dataset) + 2, ctx) + b"\x02"
                               + dataset)
            s.sendall(out)

        kind, body = recv_pdu()
        if kind != 0x01:
            return
        ac = body[:68] + dn._item(0x10, dn._uid("1.2.840.10008.3.1.1.1"))
        for ctx_id, _, _ in dn._parse_associate_rq(body):
            ac += dn._item(0x21, struct.pack(">BBBB", ctx_id, 0, 0, 0)
                           + dn._item(0x40, dn._uid(dn.IMPLICIT_VR_LE)))
        s.sendall(dn._pdu(0x02, ac + dn._item(0x50, dn._item(0x51, struct.pack(">I", 16384)))))
        cmd, ident, field, msg_id, sop_class = bytearray(), bytearray(), None, 1, ""
        while True:
            kind, body = recv_pdu()
            if kind == 0x05:  # A-RELEASE-RQ
                s.sendall(dn._pdu(0x06, b"\x00" * 4))
                return
            if kind != 0x04:
                return
            pos = 0
            while pos + 6 <= len(body):
                (ln,) = struct.unpack_from(">I", body, pos)
                ctx, mch, data = body[pos + 4], body[pos + 5], body[pos + 6:pos + 4 + ln]
                pos += 4 + ln
                if mch & 0x01:
                    cmd += data
                    if not mch & 0x02:
                        continue
                    field = dn._read_implicit_tag(cmd, 0x0000, 0x0100)
                    msg_id = dn._read_implicit_tag(cmd, 0x0000, 0x0110) or 1
                    sop_class = dn._read_implicit_text(cmd, 0x0000, 0x0002) or ""
                    cmd = bytearray()
                    if field == 0x0030:  # C-ECHO-RQ
                        send(ctx, 0x8030, msg_id, 0, sop_class)
                    continue
                ident += data
                if not mch & 0x02:
                    continue
                if field == 0x0020:  # C-FIND-RQ: the study if the name matches
                    pattern = dn._read_implicit_text(ident, 0x0010, 0x0010) or "*"
                    if fnmatch.fnmatchcase(self.row["PatientName"], pattern):
                        tags = [(0x0008, 0x0020, "StudyDate"), (0x0008, 0x0052, None),
                                (0x0008, 0x1030, "StudyDescription"),
                                (0x0010, 0x0010, "PatientName"), (0x0010, 0x0020, "PatientID"),
                                (0x0020, 0x000D, "StudyInstanceUID")]
                        match = b"".join(_implicit_text(g, e, "STUDY" if k is None
                                                        else self.row[k]) for g, e, k in tags)
                        send(ctx, 0x8020, msg_id, 0xFF00, sop_class, match)
                    send(ctx, 0x8020, msg_id, 0x0000, sop_class)
                elif field == 0x0021:  # C-MOVE-RQ: C-STORE the study
                    uid = dn._read_implicit_text(ident, 0x0020, 0x000D)
                    t0 = time.perf_counter()
                    sent = 0
                    if uid == self.row["StudyInstanceUID"]:
                        sent = dn.send_c_store("127.0.0.1", self.store_port, self.instances,
                                               sop_class=dn.CT_STORAGE,
                                               transfer_syntax=dn.EXPLICIT_VR_LE,
                                               timeout=self.timeout)
                        self.moved_bytes += sum(len(d) for _, d in self.instances)
                    self.move_s.append(time.perf_counter() - t0)
                    ok = uid == self.row["StudyInstanceUID"] and sent == len(self.instances)
                    send(ctx, 0x8021, msg_id, 0x0000 if ok else 0xA701, sop_class)
                ident = bytearray()


def pacs_instances(paths) -> dict:
    """SOP instance UID -> the dataset of each Part-10 file (after its meta
    group), as a C-STORE sends it."""
    out = {}
    for p in paths:
        raw = Path(p).read_bytes()
        meta, _, _ = dicom._parse_file_meta(raw, 132)
        tags, _, _ = dicom._parse_elements(raw, meta["_end"], True, False)
        out[tags["SOPInstanceUID"]] = raw[meta["_end"]:]
    return out


def _replay_poses(n: int) -> np.ndarray:
    """(n, 3, 6) probe, reference and coil poses (mm, degrees) along a
    closed path, distinct from pose to pose: the probe on a tilted circle
    of radius 40 mm, the reference swaying, the coil beside the probe."""
    t = 2 * np.pi * np.arange(n) / n
    out = np.zeros((n, 3, 6))
    out[:, 0, :3] = np.c_[40 * np.cos(t), 40 * np.sin(t), 60 + 10 * np.sin(2 * t)]
    out[:, 0, 3:] = np.c_[10 * np.sin(t), 5 * np.cos(t), 3 * np.sin(3 * t)]
    out[:, 1, :3] = np.c_[2 * np.sin(t), -1.5 * np.cos(t), 0.5 * np.sin(t)]
    out[:, 1, 3:] = np.c_[1.5 * np.cos(t), 2 * np.sin(t), -np.sin(2 * t)]
    out[:, 2] = out[:, 0] + [5.0, -5.0, 2.0, 1.0, -1.0, 0.5]
    return out


def hardware_replays(n: int) -> dict:
    """tracker id -> (connect kwargs, [(coords (3, 6), flags (3,))] expected
    from ``vendor_coords`` for each replayed pose, in replay order): each
    vendor's raw payload of ``_replay_poses(n)`` (an ISOTRAK transcript in
    cm, a Polaris transcript with its ROM upload and the reference out of
    view every 50th frame, NatNet datagrams in metres with the coil
    untracked every 40th, MicronTracker poses)."""
    import struct

    from invesalius3_tpu_torch.navigation import serial_drivers as sd
    from invesalius3_tpu_torch.navigation import vendor_coords as vc

    poses = _replay_poses(n)
    out = {}

    # Polhemus ISOTRAK: probe and reference in cm as the device prints them
    # (two decimals); the driver refers the probe to the reference
    cm = [(tuple(p[0, :3] / 10) + tuple(p[0, 3:]), tuple(p[1, :3] / 10) + tuple(p[1, 3:]))
          for p in poses]
    want = []
    for probe, ref in cm:
        pr, rf = ([float(f"{v:.2f}") for v in x] for x in (probe, ref))
        row_p = np.array([pr[0] * 10.0, pr[1] * 10.0, pr[2] * 10.0, pr[3], pr[4], pr[5]])
        row_r = np.array([rf[0] * 10.0, rf[1] * 10.0, rf[2] * 10.0, rf[3], rf[4], rf[5]])
        coords = np.zeros((3, 6))
        coords[0] = vc.polhemus_dynamic_pose(row_p, row_r)
        coords[1] = row_r
        want.append((coords, np.array([True, True, False])))
    out["polhemus_serial"] = ({"transcript": sd.make_isotrak_transcript(cm)}, want)

    # NDI Polaris: unit quaternions and mm, quantised as the device reports
    frames, want = [], []
    for k, p in enumerate(poses):
        tools, coords, flags = [], np.zeros((3, 6)), np.zeros(3, bool)
        for i in range(3):
            q = transforms.quaternion_from_matrix(
                transforms.euler_matrix(*np.radians(p[i, 3:]), axes="rzyx"))
            if i == 1 and k % 50 == 49:
                tools.append(None)
                continue
            tools.append((tuple(q), tuple(p[i, :3])))
            coords[i] = vc.quaternion_pose([int(round(v * 10000)) * 0.0001 for v in q],
                                           [int(round(v * 100)) * 0.01 for v in p[i, :3]])
            flags[i] = True
        frames.append(tools)
        want.append((coords, flags))
    roms = [bytes(range(256)) + bytes([i]) * 100 for i in range(3)]
    out["polaris_ndi"] = ({"transcript": sd.make_polaris_transcript(frames, rom_files=roms),
                           "rom_files": roms}, want)

    # OptiTrack NatNet: rigid bodies 1-3 in metres, (qx, qy, qz, qw) float32
    datagrams, want = [], []
    for k, p in enumerate(poses):
        bodies, coords, flags = [], np.zeros((3, 6)), np.zeros(3, bool)
        for i in range(3):
            q = transforms.quaternion_from_matrix(
                transforms.euler_matrix(*np.radians(p[i, 3:]), axes="rzyx"))
            body = {"id": i + 1, "pos": tuple(p[i, :3] / 1000.0),
                    "quat": (q[1], q[2], q[3], q[0]), "tracked": not (i == 2 and k % 40 == 39)}
            bodies.append(body)
            qx, qy, qz, qw, px, py, pz = struct.unpack("<7f", struct.pack(
                "<7f", *body["quat"], *body["pos"]))
            coords[i] = vc.optitrack_pose(qw, qx, qy, qz, px, py, pz)
            flags[i] = body["tracked"]
        datagrams.append(sd.make_natnet_frame(bodies))
        want.append((coords, flags))
    out["optitrack"] = ({"frames": datagrams}, want)

    # Claron MicronTracker: mm and (z, y, x) angles through its SDK surface
    mtc = [[list(p[i]) for i in range(3)] for p in poses]
    want = [(np.array([vc.claron_pose(*row) for row in pose]), np.ones(3, bool))
            for pose in mtc]
    out["claron_mtc"] = ({"poses": mtc}, want)
    return out


class _RecordedCoordinates(TrackerCoordinates):
    """A ``TrackerCoordinates`` that keeps every read the poll thread hands
    it, in order."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def set_coordinates(self, coords, flags):
        self.reads.append((np.array(coords, copy=True), np.array(flags, copy=True)))
        super().set_coordinates(coords, flags)


class _FakeTTL:
    """A serial port for the TTL line: records RTS and reports a trigger
    byte on every 12th read."""

    def __init__(self):
        self.rts, self.reads = [], 0

    def setRTS(self, v):
        self.rts.append(bool(v))

    def read(self, n):
        self.reads += 1
        return b"\x01" if self.reads % 12 == 0 else b""

    def close(self):
        pass


class _SolverConnection:
    """The external e-field solver behind ``NeuronavigationApi``: the debug
    norms on the card for each pose it is asked about."""

    def __init__(self, roi: np.ndarray, dev):
        from invesalius3_tpu_torch.navigation import efield

        self._norms = efield.debug_efield_norms
        self.roi = torch.from_numpy(np.asarray(roi, np.float32)).to(dev)
        self.dev = dev
        self.calls = 0

    def update_efield_vectorROIMax(self, position, orientation, T_rot, id_list):
        self.calls += 1
        return self._norms(self.roi, torch.tensor(position, device=self.dev),
                           torch.tensor(orientation, device=self.dev)).cpu().numpy()


def _pacs_path(dev, tmp: Path, n: int, second: int, cl_reps: int, times: dict) -> dict:
    """Phase 16's PACS part: the study on the mini-PACS, the port's server
    on ``dev`` driven over HTTP (echo, a dead echo, find, move with import),
    the volume, the watershed and the LMIP and MIDA frames held to direct
    calls.  Returns the server's launch counts."""
    from invesalius3_tpu_torch import server as server_mod
    from invesalius3_tpu_torch.utils import logging as ilog

    ct = pipeline.make_ct(n)
    src = tmp / "pacs"
    t0 = time.perf_counter()
    paths, _ = write_series(src, ct, SERIES_UIDS[0], seed=1)
    first = n // 4
    paths2, _ = write_series(src / "second", ct[first:first + second], SERIES_UIDS[1], seed=2)
    times["write"] = time.perf_counter() - t0
    sent = pacs_instances(paths + paths2)
    f0 = dicom.read_dicom(paths[0])
    row = {k: f0.get(k) for k in ("StudyDate", "PatientName", "PatientID", "StudyInstanceUID")}
    row["StudyDescription"] = NET_STUDY_DESCRIPTION
    store_port = _free_port()
    pacs = MiniPACS(list(sent.items()), row, store_port).start()
    slc = Slice(Volume.from_numpy(pipeline.make_ct(64), spacing=pipeline.SPACING, device=dev))
    srv = server_mod.ViewerServer(slc).start()
    cl = _Client(srv.port, cl_reps)
    pacs_body = {"host": "127.0.0.1", "port": pacs.port}
    try:
        out = _ok(*cl.post("/api/pacs/echo", pacs_body), "echo")
        if out != {"ok": True}:
            raise AssertionError(f"echo: {out}")
        out = _ok(*cl.post("/api/pacs/echo", {"host": "127.0.0.1", "port": _free_port(),
                                              "timeout": 2.0}, name="POST /api/pacs/echo dead"),
                  "dead echo")
        if out != {"ok": False}:
            raise AssertionError(f"echo to a dead port: {out}")
        found = _ok(*cl.post("/api/pacs/find", {**pacs_body, "patient_name": "PHANTOM*"}),
                    "find")
        if found != [row]:
            raise AssertionError(f"find: {found}, written {row}")
        kernels.reset_launches()
        rays.reset_launches()
        dest = tmp / "moved"
        t_move = time.perf_counter()
        moved = _ok(*cl.post("/api/pacs/move", {**pacs_body, "study_uid": row["StudyInstanceUID"],
                                                "dest": str(dest), "listen_port": store_port,
                                                "timeout": 300.0}), "move")
        times["move_ms"] = (time.perf_counter() - t_move) * 1e3
        times["transfer_ms"] = pacs.move_s[-1] * 1e3
        times["import_ms"] = times["move_ms"] - times["transfer_ms"]
        times["mb_per_s"] = pacs.moved_bytes / 1e6 / pacs.move_s[-1]
        if len(moved["files"]) != n + second or moved["shape"] != [n, n, n]:
            raise AssertionError(f"move: {len(moved['files'])} files, shape {moved['shape']}")
        got = pacs_instances(moved["files"])
        if got.keys() != sent.keys() or any(got[k] != sent[k] for k in sent):
            raise AssertionError("move: a received dataset differs from the one sent")
        with _Uncounted():
            g = max(dicom.load_dicom_dir(src), key=lambda g: len(g.files))
            want, _, _ = dicom.group_to_volume(g, device=dev)
            same = bool(torch.equal(want, srv.state.slice.matrix))
            del want
        if not same:
            raise AssertionError("move: the imported volume differs from group_to_volume's")
        log(f"  C-MOVE: {len(moved['files'])} files, {pacs.moved_bytes} dataset bytes, "
            "every one equal to the sent dataset; the volume equal to group_to_volume's")

        slc = srv.state.slice
        _ok(*cl.post("/api/window", {"ww": 400.0, "wl": 40.0}), "window")
        lo, hi = const.THRESHOLD_PRESETS_CT["Bone"]
        _ok(*cl.post("/api/threshold", {"tmin": lo, "tmax": hi}), "threshold")
        marks = np.argwhere(pipeline.bench_markers(n))
        labels_at = pipeline.bench_markers(n)[tuple(marks.T)]
        body = {"markers": [{"position": [int(c) for c in m], "label": int(lb)}
                            for m, lb in zip(marks, labels_at)]}
        out = _ok(*cl.post("/api/watershed", body), "watershed")
        with _Uncounted():
            ref = watershed.watershed(slc.matrix, torch.from_numpy(
                pipeline.bench_markers(n)).to(dev), algorithm="Watershed")
            same = bool(torch.equal((ref == 1).to(torch.uint8) * 253, slc.current_mask.data))
            n_ref = int((ref == 1).sum())
            del ref
        if not same or out["voxels"] != n_ref:
            raise AssertionError(f"watershed: {out['voxels']} voxels, direct {n_ref}, "
                                 f"mask equal {same}")
        mid, slab = n // 2, max(1, n // 8)
        for o in ORIENTATIONS:
            for p in (const.PROJECTION_LMIP, const.PROJECTION_MIDA):
                name = f"GET /api/slice/{o}/{mid} {const.PROJECTION_NAMES[p]}"
                img = _png_rgb(cl.get(f"/api/slice/{o}/{mid}?projection={p}&slabs={slab}",
                                      name=name)[2])
                with _Uncounted():
                    direct = slc.get_rendered_slice(o, mid, projection=p, slabs=slab,
                                                    measures=srv.state.measures)
                d = int(np.abs(img.astype(int) - direct.astype(int)).max())
                if img.shape != direct.shape or d > SERVER_FRAMES[p]:
                    raise AssertionError(f"{name}: the server's frame differs by {d}")
    finally:
        srv.stop()
        pacs.stop()
    thread = getattr(srv.state, "warm_thread", None)
    if thread is not None:
        thread.join()
    warm_fail = ilog.query_log(search="warm-up failed")
    if warm_fail:
        raise AssertionError(f"the shear-cache warm-up failed: {warm_fail}")
    times["ms"] = cl.ms
    return {"sweeps": dict(kernels.LAUNCHES),
            "rays": {k: dict(v) for k, v in rays.LAUNCHES.items()}}


def _tracker_sessions(dev, poses: int, seconds: float, fod_shape, roi_n: int,
                      tracts) -> dict:
    """Phase 16's trackers: each hardware driver through ``Tracker.connect``
    on its replay, feeding a ``Navigation`` session with the tract worker
    and the e-field worker (through ``NeuronavigationApi``), the TTL port
    pulsing beside it; every read held to ``vendor_coords``' conversion."""
    from invesalius3_tpu_torch.navigation.serial_port import SerialPortConnection
    from invesalius3_tpu_torch.net.neuronavigation_api import NeuronavigationApi

    fod, _, wm = nav_fields(dev, tuple(fod_shape), NAV_LMAX)
    roi = (np.random.default_rng(7).uniform(-60, 60, (roi_n, 3)) + 120).astype(np.float32)
    out = {}
    for tracker_id, (kw, want) in hardware_replays(poses).items():
        solver = _SolverConnection(roi, dev)
        api = NeuronavigationApi(connection=solver)
        coords = _RecordedCoordinates()
        ttl_port = _FakeTTL()
        ttl_seen = {"serial.pulse_sent": 0, "serial.trigger_received": 0}

        def during(bus, ttl_port=ttl_port, seconds=seconds):
            ttl = SerialPortConnection(serial_port=ttl_port, bus=bus, poll_hz=const.NAV_POLL_HZ)
            for topic in ttl_seen:
                bus.subscribe(lambda topic=topic, **kw: ttl_seen.__setitem__(
                    topic, ttl_seen[topic] + 1), topic)
            ttl.start()
            try:
                t_end = time.monotonic() + seconds
                while time.monotonic() < t_end:
                    ttl.send_pulse()
                    time.sleep(0.1)
            finally:
                ttl.stop()
                ttl.join(timeout=5.0)
            if ttl.is_alive():
                raise AssertionError("the TTL thread outlived its stop")

        t0 = time.perf_counter()
        sess = _session(dev, fod, wm, roi, seconds, tracker_id=tracker_id, tracker_kw=kw,
                        efield_api=api, coordinates=coords, during=during, tracts=tracts)
        reads = coords.reads
        bad = [k for k, (c, f) in enumerate(reads)
               if not (np.array_equal(c, want[k % len(want)][0])
                       and np.array_equal(f, want[k % len(want)][1]))]
        if not reads or bad:
            raise AssertionError(f"{tracker_id}: {len(bad)} of {len(reads)} reads differ from "
                                 f"vendor_coords' conversion (first at read {bad[:1]})")
        scene, tract_msgs, ef = (sess[k] for k in ("navigation.update_scene",
                                                   "navigation.tracts", "navigation.efield"))
        if scene["count"] < 1 or tract_msgs["count"] < 1 or ef["count"] < 1 or solver.calls < 1 \
                or sess["shapes"]["navigation.efield"] != [(roi_n,)] \
                or min(ttl_seen.values()) < 1 or True not in ttl_port.rts:
            raise AssertionError(f"{tracker_id}: session {sess}, solver calls {solver.calls}, "
                                 f"TTL {ttl_seen}")
        log(f"  {tracker_id} ({time.perf_counter() - t0:.1f} s): {len(reads)} reads equal to "
            f"vendor_coords' conversion; " + "; ".join(
                f"{k.split('.')[1]} {v['count']} (pose to publish median "
                f"{v['median_ms'] or 0:.3f} ms, p95 {v['p95_ms'] or 0:.3f} ms)"
                for k, v in sess.items() if k.startswith("navigation."))
            + f"; solver calls {solver.calls}; TTL {ttl_seen}")
        out[tracker_id] = {"reads": len(reads), **sess, "solver_calls": solver.calls,
                           "ttl": dict(ttl_seen)}
    del fod, wm
    return out


def _grid_path(dev, n: int) -> dict:
    """Phase 16's stimulation grids: a 9x9 rectangular and a 4-ring x 12
    circular grid about the top of the T1 phantom's scalp surface (above
    150), brought to the host."""
    from invesalius3_tpu_torch.navigation.grid import GridGenerator, ScalpGeometry
    from invesalius3_tpu_torch.navigation.markers import Marker, MarkerType
    from invesalius3_tpu_torch.ops import marching

    image = _mri(n)
    img = torch.as_tensor(image, device=dev)
    dm = marching.mask_to_surface_device((img > 150).to(torch.uint8) * 255)
    verts = dm.verts3v.t().double().cpu().numpy()
    faces = dm.faces3t.t().cpu().numpy()
    del dm, img
    ms = {}
    t0 = time.perf_counter()
    scalp = ScalpGeometry(verts, faces)
    ms["normals"] = (time.perf_counter() - t0) * 1e3
    top = verts[int(np.argmax(verts[:, 2]))]
    ref = Marker(marker_type=MarkerType.COIL_TARGET, position=(top[0], -top[1], top[2]),
                 label="G", z_rotation=15.0)
    gg = GridGenerator(scalp)
    grids = {}
    t0 = time.perf_counter()
    grids["rectangular"] = gg.generate_rectangular_grid(ref, 9, 9, 5.0)
    ms["rectangular 9x9"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    grids["circular"] = gg.generate_circular_grid(ref, 4, 12, 6.0)
    ms["circular 4x12"] = (time.perf_counter() - t0) * 1e3
    want = {"rectangular": {f"G {r}_{c}" for r in range(1, 10) for c in range(1, 10)}
            - {"G 5_5"},
            "circular": {f"G {r}_{k}" for r in range(1, 5) for k in range(1, 13)}}
    on_scalp = {tuple(v) for v in verts}
    for kind, grid in grids.items():
        pos = np.array([m.position for m in grid]) * [1, -1, 1]
        if len(grid) != len(want[kind]) or {m.label for m in grid} != want[kind] \
                or not all(tuple(p) in on_scalp for p in pos):
            raise AssertionError(f"{kind} grid: {len(grid)} targets, labels or positions off "
                                 "the scalp's vertices")
        _, normals = scalp.project(pos)
        zhat = np.array([transforms.euler_matrix(*np.radians(m.orientation),
                                                 axes="sxyz")[:3, 2] for m in grid])
        if np.abs(np.linalg.norm(normals, axis=1) - 1).max() > 1e-12 \
                or np.abs(zhat - normals).max() > 1e-9 \
                or any(m.marker_type != MarkerType.COIL_TARGET or m.z_rotation != 15.0
                       for m in grid):
            raise AssertionError(f"{kind} grid: a coil axis is not its unit scalp normal")
    log(f"  grids on a {len(verts)}-vertex, {len(faces)}-face scalp ({n}^3 T1 phantom): "
        f"{len(grids['rectangular'])} + {len(grids['circular'])} targets on scalp vertices, "
        "coil axes the unit normals; ms " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    return {"verts": len(verts), "ms": ms}


def _mirror_path(dev, tmp: Path, n: int, fod_shape, roi_n: int, seconds: float,
                 tracts) -> dict:
    """Phase 16's remote mirror: ``app.main --remote-host`` against a
    ``RemoteEventServer``, its mirrored topics against a local hook's, an
    injected event on the app's bus; then a Navigation session with the
    mirror on."""
    import threading

    from invesalius3_tpu_torch import events
    from invesalius3_tpu_torch.net.remote_control import RemoteControl
    from invesalius3_tpu_torch.net.remote_server import RemoteEventServer

    nii = tmp / "ct.nii"
    nifti.write_nifti(nii, pipeline.make_ct(n), spacing=pipeline.SPACING)
    srv = RemoteEventServer().start()
    local, injected, arrived = [], [], threading.Event()
    add_hook = events.bus.add_send_message_hook

    def recording(hook):
        def both(topic, kw):
            local.append(topic)
            if len(local) == 1:  # the app is connected: inject one event
                deadline = time.monotonic() + 10
                while not srv._clients and time.monotonic() < deadline:
                    time.sleep(0.005)  # the server's handler registers the client
                if srv.send("remote.probe", value=7) != 1 or not arrived.wait(10.0):
                    raise AssertionError("the injected event did not reach the app's bus")
            hook(topic, kw)
        add_hook(both)

    def on_probe(**kw):
        injected.append(kw)
        arrived.set()

    events.bus.add_send_message_hook = recording
    events.subscribe(on_probe, "remote.probe")
    try:
        t0 = time.perf_counter()
        rc = app.main(["--import-file", str(nii), "-t", "Bone", "-e", str(tmp / "bone.stl"),
                       "--remote-host", f"127.0.0.1:{srv.port}"], device=dev)
        app_s = time.perf_counter() - t0
        if rc != 0 or events.bus._hook is not None:
            raise AssertionError(f"app --remote-host: status {rc}, hook left {events.bus._hook}")
        deadline = time.monotonic() + 30
        while len(srv.received) < len(local) and time.monotonic() < deadline:
            time.sleep(0.02)
        got = [m["topic"] for m in srv.received]
        if not local or got != local or injected != [{"value": 7}]:
            raise AssertionError(f"mirror: server {got}, local {local}, injected {injected}")
        log(f"  app --remote-host ({app_s:.1f} s): {len(got)} events mirrored in order "
            f"({', '.join(dict.fromkeys(got))}); the injected event reached the app's bus")

        fod, _, wm = nav_fields(dev, tuple(fod_shape), NAV_LMAX)
        roi = (np.random.default_rng(7).uniform(-60, 60, (roi_n, 3)) + 120).astype(np.float32)
        srv.received.clear()
        rc_nav = RemoteControl("127.0.0.1", srv.port)
        rc_nav.connect()
        try:
            sess = _session(dev, fod, wm, roi, seconds, bus=events.bus, tracts=tracts)
        finally:
            rc_nav.disconnect()
        deadline = time.monotonic() + 30
        scene = sess["navigation.update_scene"]["count"]
        while time.monotonic() < deadline and sum(
                m["topic"] == "navigation.update_scene" for m in srv.received) < scene:
            time.sleep(0.05)
        mirrored = sum(m["topic"] == "navigation.update_scene" for m in srv.received)
        if mirrored != scene or scene < 1:
            raise AssertionError(f"mirror session: {scene} scene updates, {mirrored} mirrored")
        del fod, wm
    finally:
        events.bus.add_send_message_hook = add_hook
        events.unsubscribe(on_probe, "remote.probe")
        srv.stop()
    return {"app_s": app_s, "topics": len(got), "session": sess}


def network_and_trackers_phase(dev, tmp: Path, n: int = NET_N, second: int = NET_SECOND,
                               poses: int = NET_POSES, tracker_s: float = NET_TRACKER_S,
                               grid_n: int = NET_GRID_N, mirror_s: float = NET_MIRROR_S,
                               fod_shape=NAV_FOD_SHAPE, roi_n: int = NAV_ROI,
                               tracts=(64, 120), reps: int = SERVER_REPS,
                               scene_hz_14: float = None) -> dict:
    """Phase 16: the PACS retrieve to the watershed through the server, the
    four hardware trackers feeding Navigation sessions (phase 14's workers:
    ``tracts`` streamlines x steps a pose, ``roi_n`` e-field vertices), the
    stimulation grids on a scalp, and the remote mirror.  ``scene_hz_14`` is
    phase 14's scene rate, printed beside the mirrored session's."""
    import os

    log(f"[16] the network and the hardware trackers: a C-MOVE of make_ct({n}) as {n} + "
        f"{second} files, {len(NET_HARDWARE)} trackers x {tracker_s:g} s, grids on the "
        f"{grid_n}^3 T1 scalp, the remote mirror")
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        torch.cuda.reset_peak_memory_stats()
    log(f"  card: {card}")
    os.environ["XDG_CONFIG_HOME"] = str(tmp / "config")
    os.environ.pop("INV3_LANGUAGE", None)
    t_phase = time.perf_counter()
    pacs_times = {}
    launches = _pacs_path(dev, tmp, n, second, reps, pacs_times)
    ms = pacs_times["ms"]
    log(f"  PACS ({card}; wall ms over HTTP): echo {ms['POST /api/pacs/echo'][0]:.3f}, "
        f"dead echo {ms['POST /api/pacs/echo dead'][0]:.3f}, find "
        f"{ms['POST /api/pacs/find'][0]:.3f}, move {pacs_times['move_ms']:.3f} (transfer "
        f"{pacs_times['transfer_ms']:.3f} at {pacs_times['mb_per_s']:.1f} MB/s, import "
        f"{pacs_times['import_ms']:.3f}); the study written in {pacs_times['write']:.1f} s")
    log(f"  after the import: watershed {ms['POST /api/watershed'][0]:.3f} ms; frames "
        + ", ".join(f"{k.split(' ', 2)[2]} {v[0]:.3f}" for k, v in ms.items()
                    if k.startswith("GET /api/slice")))
    log(f"  launches below the server after the C-MOVE'd import: {launches}")
    if dev.type == "cuda" and (min(launches["sweeps"].values()) <= 0 or any(
            launches["rays"][k][a] <= 0 for k in RAY_FNS for a in (0, 1, 2))):
        raise AssertionError(f"a kernel never launched below the server: {launches}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    trackers = _tracker_sessions(dev, poses, tracker_s, fod_shape, roi_n, tracts)
    grid = _grid_path(dev, grid_n)
    mirror = _mirror_path(dev, tmp, n, fod_shape, roi_n, mirror_s, tracts)
    scene = mirror["session"]["navigation.update_scene"]["count"] / mirror_s
    log(f"  Navigation with the mirror on ({mirror_s:g} s): {scene:.1f} scene updates a "
        "second" + (f" against phase [14]'s {scene_hz_14:.1f} without it"
                    if scene_hz_14 is not None else "") + "; " + "; ".join(
            f"{k.split('.')[1]} {v['count']} (median {v['median_ms'] or 0:.3f} ms, p95 "
            f"{v['p95_ms'] or 0:.3f} ms)" for k, v in mirror["session"].items()
            if k.startswith("navigation.")))
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    seconds = time.perf_counter() - t_phase
    log(f"  peak device memory {peak:.2f} GiB; phase [16]: {seconds:.1f} s ({card})")
    return {"pacs": pacs_times, "launches": launches, "trackers": trackers, "grid": grid,
            "mirror": mirror, "peak_gib": peak, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 17: the sharded flow over a shard list
# ---------------------------------------------------------------------------

SHARDED_N = 512  # the sharded flow's CT side (phase 17)
N_SHARDS = 8  # bench.py's sharded branch: 8 Z-slabs (on one card, 8 shards on it)
SMOOTH_TOL = 1e-4  # mm, smoothed vertices against the single-device smoothing
SMALL_SMOOTH = {"t": 0.7, "tmax": 3.0, "bmin": 0.5, "n_iters": 4}


def ws_volume(n: int = 64, seed: int = 3):
    """Two basins separated by a bright ridge over a noise floor
    (tests/test_parallel.py's watershed volume)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float32)
    ridge = np.exp(-((xx - n / 2) ** 2) / 8.0) * 900
    bowl = ((zz - n / 2) ** 2 + (yy - n / 2) ** 2) / n
    vol = (ridge + bowl + rng.integers(0, 5, (n, n, n))).astype(np.int16)
    markers = np.zeros((n, n, n), np.int16)
    markers[n // 2, n // 2, n // 6] = 1
    markers[n // 2, n // 2, 5 * n // 6] = 2
    return vol, markers


def _shell(n: int, r_in: float, r_out: float, cut=None) -> np.ndarray:
    zz, yy, xx = np.mgrid[:n, :n, :n]
    c = n / 2
    r = np.sqrt((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2)
    m = ((r < r_out) & (r > r_in)).astype(np.uint8) * 255
    if cut is not None:
        m[cut:] = 0
    return m


def parallel_sequence(shards, tmp: Path, n: int = 64) -> dict:
    """The small cases of tests/test_parallel.py through the port's sharded
    ops on ``shards`` (a mesh): host results by case (labels and rounds, masks,
    counts, cuts, vertices, faces and STL bytes)."""
    out = {}
    vol, markers = ws_volume(n)
    for alg, stop in (("Watershed", "rank"), ("Watershed (IFT)", "label")):
        lab, rounds = sharded_ops.sharded_watershed(
            shards, levels=2, stop=stop, quiet_rounds=1 if stop == "rank" else 2)(
            vol, markers, algorithm=alg, debug_rounds=True)
        out[f"watershed {alg} {stop}"] = (lab.gather().cpu().numpy(), rounds)
    rod = np.full((4 * shards.size, 8, 8), -1000, np.int16)
    rod[:, 4, 4] = 1500
    seeds = np.zeros(rod.shape, bool)
    seeds[0, 4, 4] = True
    reached = sharded_ops.sharded_floodfill_threshold(shards, morphology.structure_3d(6))(
        rod, seeds, 1200, 3000).gather().cpu().numpy()
    if not (reached[:, 4, 4].all() and reached.sum() == rod.shape[0]):
        raise AssertionError("the rod's floodfill did not cross every shard")
    out["floodfill rod"] = reached
    for conn, shape, seed, p in ((6, (16, 16, 16), 0, 0.8), (26, (16, 12, 12), 1, 0.85)):
        x = np.random.default_rng(seed).random(shape) > p
        out[f"dilation {conn}"] = sharded_ops.sharded_binary_dilation(
            shards, morphology.structure_3d(conn))(x).gather().cpu().numpy()
    block = np.zeros((32, 16, 16), bool)
    block[10:20, 4:10, 4:10] = True
    out["active cells"] = sharded_ops.sharded_active_cell_count(shards)(block)
    shell = _shell(32, 6, 11)
    dev = shards.devices.ravel()[0]
    for balance in (False, True):
        for smooth in (None, SMALL_SMOOTH):
            key = f"surface {'balanced' if balance else 'uniform'} " + (
                "smoothed" if smooth else "raw")
            spacing = (0.5, 0.7, 1.1)  # the JAX tests' anisotropic spacing
            v, f, st = sharded_ops.sharded_mask_to_surface(
                shards, shell, spacing=spacing, smooth=smooth, balance=balance,
                return_stats=True)
            vsh, fsh, _, _ = sharded_ops.sharded_mask_to_surface(
                shards, shell, spacing=spacing, smooth=smooth, balance=balance,
                return_parts=True)
            if smooth:  # the single-device smoothing on the same device
                dm = marching.mask_to_surface_device(torch.from_numpy(shell).to(dev),
                                                     spacing=spacing)
                want = mesh.ca_smoothing_device(dm, **smooth).t().cpu().numpy()
                err = float(np.abs(v - want).max())
                if err >= SMOOTH_TOL:
                    raise AssertionError(f"{key}: {err} mm from ca_smoothing_device on {dev}")
            path = tmp / f"{key.replace(' ', '_')}.stl"
            mesh_io.write_stl_sharded(path, vsh, fsh)
            ref = tmp / "ref.stl"
            mesh_io.write_stl(ref, v, f)
            if path.read_bytes() != ref.read_bytes():
                raise AssertionError(f"{key}: write_stl_sharded's bytes are not write_stl's")
            out[key] = (v, f, st["cuts"], st["tri_hist"], path.read_bytes())
    return out


def _compare_parallel(got: dict, want: dict) -> None:
    """Card against CPU: everything equal but smoothed vertices, within
    ``SMOOTH_TOL``."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"cases differ: {sorted(got)} vs {sorted(want)}")
    for k in got:
        g, w = got[k], want[k]
        if k.startswith("surface"):
            smoothed = k.endswith("smoothed")
            err = float(np.abs(g[0] - w[0]).max()) if g[0].shape == w[0].shape else np.inf
            if not ((err < SMOOTH_TOL if smoothed else err == 0.0)
                    and np.array_equal(g[1], w[1]) and g[2:4] == w[2:4]
                    and (smoothed or g[4] == w[4])):
                raise AssertionError(
                    f"{k}: the card and the CPU differ (vertices {err} mm, faces "
                    f"{np.array_equal(g[1], w[1])}, cuts {g[2]} vs {w[2]}, histogram "
                    f"{g[3] == w[3]}, STL {g[4] == w[4]})")
        elif k.startswith("watershed"):
            if not (np.array_equal(g[0], w[0]) and g[1] == w[1]):
                raise AssertionError(f"{k}: labels or rounds {g[1]} vs {w[1]} differ")
        elif not np.array_equal(g, w):
            raise AssertionError(f"{k}: the card and the CPU differ")


def cost_maps(f: torch.Tensor, markers: torch.Tensor, labels) -> torch.Tensor:
    """(labels, Z, Y, X) minimax path cost from each label's seeds over
    ``f``: the sweeps iterated to the rank fixpoint, one label at a time
    (a voxel's label is optimal when its label's cost is the least)."""
    out = []
    for a in labels:
        rank = torch.where(markers == a, 0, torch.full_like(f, kernels.INF_RANK))
        lab = torch.zeros(f.shape, dtype=torch.int16, device=f.device)
        while True:
            prev = rank.clone()
            for axis in range(3):
                kernels.watershed_sweep(rank, lab, f, axis)
            if torch.equal(prev, rank):
                break
        out.append(rank >> kernels.DIST_BITS)
    return torch.stack(out)


def label_agreement(got: torch.Tensor, want: torch.Tensor, ct: torch.Tensor,
                    markers: torch.Tensor) -> dict:
    """How the sharded labels ``got`` differ from the single-device
    ``want``: the share of voxels, and whether each differing voxel is a
    cost tie (its two labels reach it at the same minimax cost over the
    flow's gradient, so either is a watershed of the image and the choice
    is the solver's schedule)."""
    img = (ct - torch.min(ct)).to(torch.int32)
    f = torch.clamp(morphology.morphological_gradient(img, (3, 3, 3)), 0, 2**16 - 2)
    ids = sorted(int(v) for v in torch.unique(markers) if int(v) > 0)
    costs = cost_maps(f.contiguous(), markers, ids)
    index = {a: i for i, a in enumerate(ids)}
    lut = torch.full((max(ids) + 1,), -1, dtype=torch.int64, device=got.device)
    for a, i in index.items():
        lut[a] = i
    diff = got != want
    cg = costs.gather(0, lut[got.long()][None])[0][diff]
    cw = costs.gather(0, lut[want.long()][None])[0][diff]
    best = costs.min(dim=0).values[diff]
    return {"differ": int(diff.sum()), "share": float(diff.float().mean()),
            "untied": int(((cg != cw) | (cg != best)).sum())}


def _faces_sorted(faces3t: torch.Tensor) -> torch.Tensor:
    """(F, 3) faces, each rotated to its smallest id, rows sorted: the face
    set as one tensor (winding kept)."""
    f = faces3t.t().long()
    r = torch.argmin(f, dim=1)
    ar = torch.arange(len(f), device=f.device)
    f = torch.stack([f[ar, (r + k) % 3] for k in range(3)], dim=1)
    for col in (2, 1, 0):
        f = f[torch.sort(f[:, col], stable=True).indices]
    return f


def check_sharded_flow(dev, res, ct, markers, single_labels, tmp: Path, out: Path,
                       share_limit: float) -> dict:
    """Holds a sharded flow's result against the single-device path: labels
    (every differing voxel a cost tie, fewer than ``share_limit`` of them),
    the surface of the same mask, the smoothed vertices, the face set, the
    STL bytes, the sweep launches per shard and axis."""
    agree = label_agreement(res.labels.gather(dev), single_labels,
                            torch.from_numpy(ct).to(dev), torch.from_numpy(markers).to(dev))
    if agree["untied"] or agree["share"] >= share_limit:
        raise AssertionError(f"sharded labels against the single device's: {agree}")
    mask = torch.where(res.labels.gather(dev) == 1, 255, 0).to(torch.uint8)
    dm = marching.mask_to_surface_device(mask, spacing=pipeline.SPACING)
    want3v = mesh.ca_smoothing_device(dm, **pipeline.CA_PARAMS)
    vsh, fsh, checks, meta = res.parts
    got3v = torch.cat([v.to(dev) for v in vsh], dim=1)
    got_f = torch.cat([f.to(dev) for f in fsh], dim=1)
    if (got3v.shape[1], got_f.shape[1]) != (dm.n_verts, dm.n_tris):
        raise AssertionError(f"sharded mesh {got3v.shape[1]} verts {got_f.shape[1]} tris, "
                             f"single device {dm.n_verts}, {dm.n_tris}")
    used = torch.zeros(dm.n_verts, dtype=torch.bool, device=dev)
    used[got_f.reshape(-1).long()] = True
    err = float((got3v - want3v).abs().amax(dim=0)[used].max())
    if err >= SMOOTH_TOL:
        raise AssertionError(f"smoothed vertices {err} mm from the single device's")
    if not torch.equal(_faces_sorted(got_f), _faces_sorted(dm.faces3t)):
        raise AssertionError("the sharded face set is not the single device's")
    check_closed(got3v, got_f)
    ref = tmp / "assembled.stl"
    mesh_io.write_stl(ref, got3v.t().cpu().numpy(), got_f.t().cpu().numpy())
    if out.read_bytes() != ref.read_bytes():
        raise AssertionError("write_stl_sharded's bytes are not write_stl's of the mesh")
    launches = res.watershed_stats["launches"]
    if dev.type == "cuda" and min(min(a) for a in launches) <= 0:
        raise AssertionError(f"a shard's sweep never launched: {launches}")
    cuts = res.cuts
    lens = np.diff(cuts)
    if cuts[0] != 0 or cuts[-1] != ct.shape[0] or (lens < 1).any():
        raise AssertionError(f"cuts {cuts}")
    return {"labels": agree, "n_verts": dm.n_verts, "n_tris": dm.n_tris, "max_err_mm": err,
            "cuts": cuts, "checks": checks.tolist()}


def sharded_phase(dev, tmp: Path, n: int = SHARDED_N, small: int = 64, ws_n: int = 128,
                  times_4=None, n_shards: int = N_SHARDS, share_limit: float = 0.01) -> dict:
    """Phase 17: the port's parallel/ package on the card.  ``share_limit``
    bounds the share of voxels whose sharded label differs from the
    single device's (the JAX test's 1%; make_ct's plateaus tie more voxels
    below 192^3, where the flow runs without multigrid).  With several
    cards the ``n_shards`` shards cycle over them, and the flow runs once
    more with one shard a card."""
    t_phase = time.perf_counter()
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        card = "; ".join(card.splitlines())
    log(f"[17] the sharded flow over a shard list at {n}^3 ({card})")
    mesh_dev = make_mesh(n_shards, device=dev)
    log(f"  mesh: {mesh_dev}")

    # the small cases on the card and on the CPU
    t0 = time.perf_counter()
    (tmp / "dev").mkdir(exist_ok=True)
    (tmp / "cpu").mkdir(exist_ok=True)
    got = parallel_sequence(mesh_dev, tmp / "dev", small)
    want = parallel_sequence(make_mesh(n_shards, device="cpu"), tmp / "cpu", small)
    _compare_parallel(got, want)
    log(f"  small cases on the card and the CPU equal ({len(got)} cases, "
        f"{time.perf_counter() - t0:.1f} s): " + "; ".join(
            f"{k} rounds {v[1]}" for k, v in got.items() if k.startswith("watershed")))

    # the sharded watershed at ws_n^3, kernel against plain (3 levels: at
    # 128^3 the coarsest slabs are 4 planes with their ghosts)
    ct, markers = pipeline.make_ct(ws_n), pipeline.bench_markers(ws_n)
    run = sharded_ops.sharded_watershed(mesh_dev, levels=3, stop="label", quiet_rounds=2)
    st_k, st_p = {}, {}
    t0 = time.perf_counter()
    lab_k = run(ct, markers, stats=st_k)
    _sync(dev)
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    lab_p = run(ct, markers, sweep=kernels.watershed_sweep_ref, stats=st_p)
    _sync(dev)
    t_p = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(lab_k.shards, lab_p.shards)):
        raise AssertionError(f"{ws_n}^3 sharded labels differ between kernel and plain")
    if st_k["rounds"] != st_p["rounds"]:
        raise AssertionError(f"{ws_n}^3 sharded rounds: kernel {st_k['rounds']}, plain "
                             f"{st_p['rounds']}")
    log(f"  {ws_n}^3 sharded watershed, 3 levels: labels bitwise equal, rounds "
        f"{st_k['rounds']} equal; kernel {t_k:.3f} s, plain {t_p:.3f} s")

    # the flow at n^3 through the entry point
    ct, markers = pipeline.make_ct(n), pipeline.bench_markers(n)
    out = tmp / f"sharded{n}.stl"
    t0 = time.perf_counter()
    pipeline.run(ct, markers, out, device=dev, shards=mesh_dev)
    log(f"  warm-up run: {time.perf_counter() - t0:.3f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rounds = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = pipeline.run(ct, markers, out, device=dev, shards=mesh_dev, rounds=rounds)
    total = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    stats = res.watershed_stats
    log(f"  timed run: {total:.3f} s; stages (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in res.times.items()))
    if times_4:
        log("  phase [4]'s single-device stages in this run (s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in times_4.items()))
    log(f"  peak device memory: {peak:.2f} GiB")
    log(f"  rounds per level (coarse to fine, {stats['levels']} levels): {rounds}")
    log("  halo bytes per level: " + ", ".join(str(b) for b in stats["halo_bytes"]))
    log(f"  sweep launches: {launches}; per shard (axis 0/1/2): "
        + ", ".join("/".join(str(x) for x in a) for a in stats["launches"]))
    log(f"  cuts: {res.cuts}")
    if n >= 192 and (stats["levels"] != 3 or len(rounds) != 4):
        raise AssertionError(f"levels {stats['levels']}, rounds {rounds}: want 3 levels")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"a sweep axis never launched: {launches}")
    single = watershed.watershed(torch.from_numpy(ct).to(dev), torch.from_numpy(markers).to(dev))
    with _Uncounted():
        check = check_sharded_flow(dev, res, ct, markers, single, tmp, out, share_limit)
    log(f"  against the single device: labels {check['labels']}; {check['n_verts']} verts, "
        f"{check['n_tris']} tris equal; smoothed vertices within {check['max_err_mm']:.3g} mm; "
        "face set equal; STL bytes write_stl's; per shard (own verts, tris, cut-plane "
        f"verts, duplicates, local verts): {check['checks']}")
    result = {"times": dict(res.times), "total": total, "peak_gib": peak, "rounds": rounds,
              "halo_bytes": stats["halo_bytes"], "launches": launches,
              "launches_per_shard": stats["launches"], "cuts": res.cuts, "check": check,
              "digests": {"labels": shard_digests(res.labels),
                          "stl": hashlib.sha256(out.read_bytes()).hexdigest()}}
    del res, single

    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        mesh_all = make_mesh(device=dev)
        out_k = tmp / f"sharded{n}_cards.stl"
        pipeline.run(ct, markers, out_k, device=dev, shards=mesh_all)
        t0 = time.perf_counter()
        res = pipeline.run(ct, markers, out_k, device=dev, shards=mesh_all)
        total_k = time.perf_counter() - t0
        single = watershed.watershed(torch.from_numpy(ct).to(dev),
                                     torch.from_numpy(markers).to(dev))
        with _Uncounted():
            check_k = check_sharded_flow(dev, res, ct, markers, single, tmp, out_k,
                                         share_limit)
        log(f"  one shard a card ({mesh_all.size} cards): {total_k:.3f} s; stages (s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in res.times.items())
            + f"; labels {check_k['labels']}; cuts {res.cuts}")
        result["cards"] = {"times": dict(res.times), "total": total_k, "check": check_k}
        del res
    seconds = time.perf_counter() - t_phase
    log(f"  phase [17]: {seconds:.1f} s ({card})")
    result["seconds"] = seconds
    return result


# ---------------------------------------------------------------------------
# Phase 18: the shard list across processes
# ---------------------------------------------------------------------------

PROC_SPACING = (0.5, 0.7, 1.1)  # the JAX tests' anisotropic spacing
PROC_TIMEOUT_S = 120.0  # a collective waiting longer ends its rank


def shard_digests(x) -> dict:
    """sha256 of each held shard's bytes, by shard index."""
    return {s: hashlib.sha256(x.shards[s].contiguous().cpu().numpy().tobytes()).hexdigest()
            for s in x.local}


def process_cases(mesh, tmp: Path, n: int = 64) -> dict:
    """The shard list's cases on ``mesh`` at n^3 (``make_ct``, seed 0), as
    host results by case: the bone mask's 26-connected dilation, the
    floodfill from a skull seed (the shell crosses every shard), the
    active-cell count, the watershed at 2 levels with both stopping rules
    (labels, rounds, halo and wire bytes, launches; ranks at "rank"), the
    balanced surface of its label-1 mask raw and smoothed at
    ``PROC_SPACING`` (vertices, faces, cuts, checks, histogram) and
    ``pipeline.run``'s STL bytes (the writing rank's).  Across processes
    every rank returns the same results but the STL's."""
    ct, markers = pipeline.make_ct(n), pipeline.bench_markers(n)
    dev = mesh.devices.ravel()[mesh.ranks.ravel() == mesh.rank][0]
    bone = ct >= 226
    host = lambda t: t.gather().cpu().numpy()  # noqa: E731
    out = {"dilation": host(sharded_ops.sharded_binary_dilation(
        mesh, morphology.structure_3d(26))(bone))}
    seeds = np.zeros(ct.shape, bool)
    seeds[n // 2, n // 2, n // 2 + int(0.39 * n)] = True
    out["floodfill"] = host(sharded_ops.sharded_floodfill_threshold(
        mesh, morphology.structure_3d(6))(ct, seeds, 226, 3071))
    out["active cells"] = sharded_ops.sharded_active_cell_count(mesh)(bone)
    for stop, quiet in (("label", 2), ("rank", 1)):
        stats = {}
        run = sharded_ops.sharded_watershed(mesh, levels=2, stop=stop, quiet_rounds=quiet)
        got = run(ct, markers, debug_rank=stop == "rank", stats=stats)
        lab, rank = got if stop == "rank" else (got, None)
        out[f"watershed {stop}"] = {
            "labels": host(lab), "rank": None if rank is None else host(rank),
            "rounds": stats["rounds"], "halo_bytes": stats["halo_bytes"],
            "launches": stats["launches"], "wire_bytes": stats["wire_bytes"]}
    mask = np.where(out["watershed label"]["labels"] == 1, 255, 0).astype(np.uint8)
    for smooth in (None, pipeline.CA_PARAMS):
        v, f, st = sharded_ops.sharded_mask_to_surface(
            mesh, mask, spacing=PROC_SPACING, smooth=smooth, balance=True, return_stats=True)
        out["surface " + ("smoothed" if smooth else "raw")] = {
            "verts": v, "faces": f, "cuts": st["cuts"], "checks": st["checks"],
            "tri_hist": st["tri_hist"]}
    path = tmp / f"flow_rank{mesh.rank}.stl"
    res = pipeline.run(ct, markers, path, device=dev, shards=mesh)
    out["flow"] = {"stl": path.read_bytes() if res.stl else None, "cuts": res.cuts,
                   "rounds": res.watershed_stats["rounds"],
                   "halo_bytes": res.watershed_stats["halo_bytes"],
                   "labels": host(res.labels)}
    return out


def _flow_rank(mesh, dev, tmp: Path, n: int) -> dict:
    """Phase [18] in one rank: ``pipeline.run`` at n^3 on its shards once
    to warm up and once timed (sweep counts reset just before it)."""
    ct, markers = pipeline.make_ct(n), pipeline.bench_markers(n)
    out = tmp / f"flow_rank{mesh.rank}.stl"
    t0 = time.perf_counter()
    pipeline.run(ct, markers, out, device=dev, shards=mesh)
    warm = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    torch.distributed.barrier(group=mesh.host_group)
    t0 = time.perf_counter()
    res = pipeline.run(ct, markers, out, device=dev, shards=mesh)
    total = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    st = res.watershed_stats
    _, _, checks, meta = res.parts
    times = dict(res.times)
    times.update(meta["rank_times"][mesh.rank])  # this rank's, not the slowest's
    return {
        "rank": mesh.rank, "backend": collectives.backend(mesh),
        "built_s": {k: v["seconds"] for k, v in _build.BUILD_LOG.items()},
        "staged": collectives.staged(mesh, dev), "device": str(dev), "warm": warm,
        "total": total, "times": times,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if dev.type == "cuda" else 0.0),
        "rounds": st["rounds"], "halo_bytes": st["halo_bytes"],
        "wire_bytes": st["wire_bytes"], "surface_wire_bytes": meta["wire_bytes"],
        "launches": launches, "launches_per_shard": st["launches"], "cuts": res.cuts,
        "checks": checks.tolist(), "labels": shard_digests(res.labels),
        "stl": hashlib.sha256(out.read_bytes()).hexdigest() if res.stl else None}


def rank_main(kind: str, out_dir: str, n: int, device: str, n_shards: int,
              backend=None, fail_rank: int = -1, job=None) -> None:
    """One rank of a group launched by ``spawn_ranks`` (torch's launcher
    variables in the environment): joins the group, lays ``n_shards``
    shards over the ranks (a group of one is the one-process shard list)
    and runs ``kind``: "cases" (``process_cases``, pickled), "flow"
    (``_flow_rank``, JSON) or "fail" (the watershed, whose sweep raises on
    ``fail_rank`` in its second round).  "train" lays no shards: for each
    dtype name and step count of ``job["runs"]`` it runs ``train_run(p=n,
    batch=n_shards, steps, dtype, f=job["f"])`` on this rank's rows of the
    batch, the batch norms and gradients over the group (pickled by dtype
    name)."""
    import pickle

    out = Path(out_dir)
    if device == "cpu":  # several ranks share the host's cores
        torch.set_num_threads(1)
    distributed.initialize(device=device, backend=backend, timeout=PROC_TIMEOUT_S)
    if kind == "train":
        rank, _ = distributed.process_info()
        dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
               else torch.device("cpu"))
        group = torch.distributed.group.WORLD if torch.distributed.is_initialized() else None
        recs = {name: train_run(dev, n, n_shards, steps, getattr(torch, name), job["f"],
                                group, distributed.local_data_slice(n_shards))[0]
                for name, steps in job["runs"].items()}
        (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(recs))
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        return
    mesh = distributed.global_mesh(shape=(n_shards,), device=device)
    dev = mesh.devices.ravel()[mesh.ranks.ravel() == mesh.rank][0]
    if kind == "cases":
        (out / f"rank{mesh.rank}.pkl").write_bytes(pickle.dumps(process_cases(mesh, out, n)))
    elif kind == "flow":
        (out / f"rank{mesh.rank}.json").write_text(json.dumps(_flow_rank(mesh, dev, out, n)))
    elif kind == "fail":
        calls = [0]

        def sweep(*a):
            calls[0] += 1
            if mesh.rank == fail_rank and calls[0] > 6:
                raise RuntimeError(f"rank {mesh.rank} fails on purpose")
            return kernels.watershed_sweep(*a)

        ct, markers = pipeline.make_ct(n), pipeline.bench_markers(n)
        sharded_ops.sharded_watershed(mesh, levels=0, stop="rank")(ct, markers, sweep=sweep)
    else:
        raise ValueError(f"unknown rank job {kind!r}")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def spawn_ranks(kind: str, world: int, out_dir: Path, n: int, device: str, n_shards: int,
                backend=None, timeout: float = 300.0, fail_rank: int = -1,
                kill_on_failure: bool = True, env=None, job=None) -> list:
    """Start ``world`` ranks of ``rank_main`` on this host (torch's launcher
    variables, a free port on 127.0.0.1, and ``env`` on top; ``job`` is
    "train"'s keyword arguments, Python literals) and wait for
    them: on the first rank that exits non-zero the others are killed
    (unless ``kill_on_failure`` is False), and every rank is killed at
    ``timeout``.  Returns each rank's (exit code, stdout, stderr, seconds
    to its exit or None); stops every process it started."""
    out_dir.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    root = str(Path(__file__).resolve().parent)
    code = (f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
            f"chip_smoke.rank_main({kind!r}, {str(out_dir)!r}, {n}, {device!r}, {n_shards}, "
            f"{backend!r}, {fail_rank}, {job!r})")
    procs = []
    ended = [None] * world
    t0 = time.perf_counter()
    with contextlib.ExitStack() as files:
        logs = [(files.enter_context(open(out_dir / f"rank{r}.out", "w+")),
                 files.enter_context(open(out_dir / f"rank{r}.err", "w+"))) for r in range(world)]
        try:
            for rank, (so, se) in enumerate(logs):
                rank_env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                                LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                rank_env.update(env or {})
                procs.append(subprocess.Popen([sys.executable, "-c", code], env=rank_env,
                                              stdout=so, stderr=se, cwd=root))
            while any(e is None for e in ended):
                for r, p in enumerate(procs):
                    if ended[r] is None and p.poll() is not None:
                        ended[r] = time.perf_counter() - t0
                failed = any(p.returncode not in (None, 0) for p in procs)
                if (failed and kill_on_failure) or time.perf_counter() - t0 > timeout:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=30)
        out = []
        for p, (so, se), seconds in zip(procs, logs, ended):
            so.seek(0)
            se.seek(0)
            out.append((p.returncode, so.read(), se.read(), seconds))
    return out


def _check_ranks(runs: list, what: str) -> None:
    for r, (rc, _, err, _) in enumerate(runs):
        if rc != 0:
            raise AssertionError(f"{what}: rank {r} exited {rc}:\n{err[-4000:]}")


def cross_process_phase(dev, tmp: Path, ref: dict, n: int = SHARDED_N,
                        n_shards: int = N_SHARDS, world: int = 2) -> dict:
    """Phase 18: ``pipeline.run(..., shards=distributed.global_mesh())`` in
    ``world`` ranks on one card over gloo (card planes staged through
    pinned host buffers), ``n_shards`` shards over them; with two or more
    cards once more over NCCL, one rank a card.  Every rank's labels,
    rounds, halo bytes, cuts, checks and the STL must equal phase [17]'s
    one-process run (``ref``), and every rank's sweeps must launch on
    every axis.  Returns the sweep launches of the timed runs, summed over
    the ranks."""
    t_phase = time.perf_counter()
    card = "cpu"
    if dev.type == "cuda":
        card = "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines())
    log(f"[18] the sharded flow across processes at {n}^3 ({card})")
    # the gloo ranks all see only this process's first card
    one_card = {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]}
    groups = [("gloo", world, "gloo", one_card if dev.type == "cuda" else None)]
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        groups.append(("nccl", torch.cuda.device_count(), "nccl", None))
    launches = {0: 0, 1: 0, 2: 0}
    result = {}
    for name, ranks, backend, env in groups:
        t0 = time.perf_counter()
        runs = spawn_ranks("flow", ranks, tmp / name, n, dev.type, n_shards, backend=backend,
                           timeout=600.0, env=env)
        _check_ranks(runs, f"[18] {name}")
        got = [json.loads((tmp / name / f"rank{r}.json").read_text()) for r in range(ranks)]
        log(f"  {name}: {ranks} ranks, {n_shards} shards, backend {got[0]['backend']}, "
            f"staged through host buffers {got[0]['staged']} "
            f"({time.perf_counter() - t0:.1f} s with start-up)")
        digests = {}
        for g in got:
            digests.update({int(s): d for s, d in g["labels"].items()})
            for key in ("rounds", "halo_bytes", "cuts"):
                if g[key] != ref[key]:
                    raise AssertionError(f"[18] {name} rank {g['rank']}: {key} {g[key]}, "
                                         f"one process {ref[key]}")
            if g["checks"] != ref["check"]["checks"]:
                raise AssertionError(f"[18] {name} rank {g['rank']}: checks differ")
            if any(t > 0 for t in g["built_s"].values()):
                raise AssertionError(f"[18] {name} rank {g['rank']} compiled a kernel: "
                                     f"{g['built_s']}")
            if dev.type == "cuda" and min(g["launches"].values()) <= 0:
                raise AssertionError(f"[18] {name} rank {g['rank']}: a sweep axis never "
                                     f"launched: {g['launches']}")
            for axis in (0, 1, 2):
                launches[axis] += g["launches"][str(axis)]
            log(f"  rank {g['rank']} on {g['device']}: timed {g['total']:.3f} s (warm-up "
                f"{g['warm']:.3f} s); stages (s): "
                + ", ".join(f"{k} {v:.4f}" for k, v in g["times"].items())
                + f"; peak {g['peak_gib']:.2f} GiB (one process: {ref['peak_gib']:.2f} GiB); "
                f"sweep launches {g['launches']}")
        if digests != {int(s): d for s, d in ref["digests"]["labels"].items()}:
            raise AssertionError(f"[18] {name}: labels differ from the one-process run's")
        stl = [g["stl"] for g in got if g["stl"]]
        if stl != [ref["digests"]["stl"]]:
            raise AssertionError(f"[18] {name}: STL {stl}, one process "
                                 f"{ref['digests']['stl']}")
        log(f"  {name}: labels, rounds {got[0]['rounds']}, halo bytes, cuts {got[0]['cuts']}, "
            f"checks and STL bytes equal phase [17]'s; wire bytes per level "
            f"{got[0]['wire_bytes']} (watershed), {got[0]['surface_wire_bytes']} (surface)")
        result[name] = got
    seconds = time.perf_counter() - t_phase
    log(f"  phase [18]: {seconds:.1f} s ({card})")
    result.update(launches=launches, seconds=seconds)
    return result


# ---------------------------------------------------------------------------
# phase 19: training
# ---------------------------------------------------------------------------

TRAIN_P = 96  # the trachea and mandible patch side
TRAIN_BATCH = 8  # the global batch: make_ct(2 * TRAIN_P)'s 2x2x2 grid of patches
TRAIN_STEPS = 5
TRAIN_F32_STEPS = 2  # the float32 runs (a step takes 1.6 s at 96^3 on an H100, 6x bf16's)
TRAIN_F = 8  # the published init_features
TRAIN_SEED = 19  # the weights' generator
TRAIN_CHECK = (48, 2)  # (c): patch side and batch of the float32 step, card against CPU
TRAIN_WORLD = 2  # (b): ranks on the one card over gloo
TRAIN_WW_WL = (2000.0, -500.0)  # TracheaSegmenter's window, applied before the [0, 1] rescale
# bounds of ``compare_training`` (their measured values in PERF.md, §6).
# DP_TOL: ranks against one process in float32 on the CPU
# (tests/test_torch_train_procs.py).  On the card cuDNN's float32
# algorithms, chosen per shape, round otherwise at a batch of 4 and of 8 and
# than oneDNN, and the deep layers' gradients carry that rounding at a few
# 1e-3 of their norm (later steps more, through Adam): CARD_DP_TOL for the
# float32 ranks against one process, CARD_TOL for a float32 step on the
# card against the CPU (its first Adam step is about -lr sign(g), so it is
# held by the gradients, not by the parameters).  BF16_TOL: bfloat16 ranks
# against one process, bounded on the first step and every loss (every
# bfloat16 gradient carries rounding noise of 10-30% of its norm, which
# Adam carries into later steps: their statistics and parameters are
# measured, inf, not bounded).  A data-parallel fault moves the first
# step's statistics by 0.2 or its gradients by 0.9 (per-rank statistics,
# unsummed gradients; mutation checks on the CPU).
DP_TOL = {"loss": 1e-5, "stats1": 1e-5, "stats": 1e-2, "grads": 1e-3, "params": 0.15}
CARD_DP_TOL = {"loss": 1e-4, "stats1": 1e-5, "stats": 0.15, "grads": 1e-2, "params": 0.15}
CARD_TOL = {"loss": 1e-5, "stats1": 1e-4, "grads": 1e-2}
BF16_TOL = {"loss": 1e-2, "stats1": 1e-2, "grads": 3e-2, "stats": float("inf"),
            "params": float("inf")}


def train_batch(p: int, batch: int, dev):
    """(x, y) of the training runs: ``make_ct(2 p)`` windowed and rescaled
    to [0, 1] as ``TracheaSegmenter`` does, cut into its 2x2x2 grid of p^3
    patches, the first ``batch`` of them as (batch, 1, p, p, p) float32;
    the targets are the Bone threshold of the same patches (0 or 1)."""
    from invesalius3_tpu_torch.ops.windowing import get_lut_value_255

    img = torch.from_numpy(pipeline.make_ct(2 * p)).to(dev)
    norm = segment.image_normalize(get_lut_value_255(img, *TRAIN_WW_WL))
    lo, hi = const.THRESHOLD_PRESETS_CT["Bone"]
    bone = ((img >= lo) & (img <= hi)).to(torch.float32)
    corners = [(z, yy, xx) for z in (0, p) for yy in (0, p) for xx in (0, p)][:batch]
    cut = lambda v: torch.stack([v[z:z + p, yy:yy + p, xx:xx + p]  # noqa: E731
                                 for z, yy, xx in corners])[:, None].contiguous()
    return cut(norm), cut(bone)


def pre_norm_bias(name: str) -> bool:
    """A conv bias that feeds a train-mode batch norm.  The norm subtracts
    the batch's mean, so the bias's gradient is zero and what autograd
    computes for it is rounding noise, which Adam's first steps scale to
    +-lr: the comparisons leave such parameters out."""
    return re.search(r"_conv\d?\.bias$", name) is not None


def train_run(dev, p: int, batch: int, steps: int, dtype=torch.bfloat16, f: int = TRAIN_F,
              group=None, rows: slice = slice(None), seed: int = TRAIN_SEED):
    """``steps`` of ``train.train_step`` on ``dev``: ``Unet3D(init_features=f,
    dtype)`` from ``layers.init_state`` of a generator seeded ``seed``,
    ``optax.adam(1e-3)``'s step, on ``rows`` of ``train_batch(p, batch)``
    with the batch norms' statistics over ``group``.  Returns (the host
    record: each step's loss and wall ms, the first step's gradients and
    running statistics, the last step's statistics, the parameters before
    and after, the peak device memory; (model, optimizer, x, y))."""
    x, y = train_batch(p, batch, dev)
    x, y = x[rows], y[rows]
    model = unet3d.Unet3D(init_features=f, dtype=dtype)
    model.load_state_dict(mlayers.init_state(model, torch.Generator().manual_seed(seed)))
    model.to(dev)
    params = lambda: {k: v.detach().cpu().clone() for k, v in model.named_parameters()}  # noqa: E731
    stats = lambda: {k: v.cpu().clone() for k, v in model.state_dict().items()  # noqa: E731
                     if "running" in k}
    opt = train.adam(model.parameters())
    out = {"losses": [], "ms": [], "params0": params()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        out["losses"].append(float(train.train_step(model, opt, x, y, group)))
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["grads"] = {k: v.grad.cpu().clone() for k, v in model.named_parameters()}
            out["stats1"] = stats()
    out.update(stats=stats(), params=params(), peak_gib=(
        torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0))
    return out, (model, opt, x, y)


def _norm_rel(got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()).clamp_min(1e-30))


def compare_training(got: dict, want: dict, tol: dict, what: str) -> dict:
    """``got``'s training record (``train_run``) held to ``want``'s on the
    entries of ``tol``: "loss" each step's loss (relative), "stats1" and
    "stats" the running statistics after the first and the last step
    (each difference over |w| plus the tensor's largest |w|), "grads" the
    first step's gradients (the norm of each difference over the larger of
    the reference's norm and 1% of the whole gradient's: a gradient that
    is small against the whole sums terms that cancel) and "params" each
    parameter's change over the run (the norm of the difference over the
    reference's); the parameters ``pre_norm_bias`` names are left out of
    both.  Returns the worst error of each; raises past a bound."""
    if len(got["losses"]) != len(want["losses"]):
        raise AssertionError(f"{what}: {len(got['losses'])} steps, want {len(want['losses'])}")
    kept = [n for n in want["params"] if not pre_norm_bias(n)]
    whole = float(torch.linalg.vector_norm(torch.cat(
        [want["grads"][n].reshape(-1).double() for n in kept])))
    measure = {
        "loss": lambda: max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])),
        "grads": lambda: max(float(torch.linalg.vector_norm((got["grads"][n] - want["grads"][n])
                                                            .double())) / max(float(
            torch.linalg.vector_norm(want["grads"][n].double())), 0.01 * whole) for n in kept),
        "params": lambda: max(_norm_rel(got["params"][n] - got["params0"][n],
                                        want["params"][n] - want["params0"][n]) for n in kept)}
    for k in ("stats1", "stats"):
        measure[k] = lambda k=k: max(float(((got[k][n] - want[k][n]).abs() / (
            want[k][n].abs() + want[k][n].abs().max())).max()) for n in want[k])
    errs = {k: measure[k]() for k in tol}
    if any(not errs[k] <= tol[k] for k in tol):
        raise AssertionError(f"{what}: errors {errs} past {tol}")
    return errs


def profile_train_step(dev, model, opt, x, y) -> float:
    """One more training step under torch.profiler: its wall ms, the
    device's kernel and copy time and idle share, the largest kernels.
    Returns the idle share."""
    wall, busy, rows = _profiled(dev, lambda: float(train.train_step(model, opt, x, y)))
    log(f"  profiled step: wall {wall * 1e3:.3f} ms, device kernel and copy time "
        f"{busy * 1e3:.3f} ms, idle share {1 - busy / wall:.1%}")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"    {ms:9.3f} ms {count:5d}x  {name[:90]}")
    return 1 - busy / wall


@contextlib.contextmanager
def cudnn_wgrad():
    """Every convolution's weight gradient from cuDNN, as before
    ``ops/conv_wgrad.py`` (phase 19's attribution)."""
    routed = mlayers.wgrad_routed
    mlayers.wgrad_routed = lambda layer, dtype: False
    try:
        yield
    finally:
        mlayers.wgrad_routed = routed


def direct_kernel_origin(dev, p: int = TRAIN_P, batch: int = TRAIN_BATCH, f: int = TRAIN_F):
    """The convolutions whose weight gradient cuDNN computed with its
    ``wgrad2d_grouped_direct_kernel`` in one bfloat16 training step with
    every weight gradient on cuDNN: rows (the ``aten::convolution_backward``
    input shapes, the kernel's device ms), from the profiler's record of the
    op that launched it (``record_shapes=True``)."""
    x, y = train_batch(p, batch, dev)
    model = unet3d.Unet3D(init_features=f, dtype=torch.bfloat16)
    model.load_state_dict(mlayers.init_state(model, torch.Generator().manual_seed(TRAIN_SEED)))
    model.to(dev)
    opt = train.adam(model.parameters())
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with cudnn_wgrad():
        for _ in range(2):  # cuDNN's first calls
            train.train_step(model, opt, x, y)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
            train.train_step(model, opt, x, y)
            torch.cuda.synchronize()
    rows = []
    for e in prof.events():
        ms = sum(k.duration for k in e.kernels if "wgrad2d_grouped_direct" in k.name) / 1e3
        if ms == 0:
            continue
        op = e
        while op is not None and "convolution_backward" not in op.name:
            op = op.cpu_parent
        rows.append(((op or e).input_shapes, ms))
    return rows


def conv_wgrad_timing(dev, p: int = TRAIN_P, batch: int = TRAIN_BATCH, f: int = TRAIN_F,
                      reps: int = 20) -> dict:
    """Phase 19's weight-gradient kernel (``ops/conv_wgrad.py``) at the
    training step's two single-channel convolutions on the card: the first
    (1 -> f, 5^3, bfloat16) and the head (f -> 1, 1^3, float32).  Per
    convolution the kernel's ms (``reps`` calls between one pair of CUDA
    events) against its bound (the inputs' and the gradient's bytes over
    the device memory's bandwidth), the plain version's ms,
    ``torch.nn.grad.conv3d_weight``'s (cuDNN, TF32 off: a yardstick the
    port never calls) and the kernel's distance from the plain version:
    each element within 1e-6 of the sum of its terms' magnitudes (and a
    bfloat16 unit in the last place), a float32 result within 1e-5 in norm;
    then which convolution launched cuDNN's direct kernel before the
    kernel took the weight gradients (``direct_kernel_origin``)."""
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    out = {}
    for name, c_in, c_out, k, dtype in (("enc1_conv1", 1, f, 5, torch.bfloat16),
                                        ("conv", f, 1, 1, torch.float32)):
        x = torch.rand(batch, c_in, p, p, p, device=dev, generator=gen).to(dtype)
        dy = torch.randn(batch, c_out, p, p, p, device=dev, generator=gen).to(dtype)
        before = conv_wgrad.LAUNCHES["conv_wgrad"]
        got = conv_wgrad.conv_wgrad(x, dy, k).float()
        want = conv_wgrad.conv_wgrad_ref(x, dy, k).float()
        err = _norm_rel(got.double(), want.double())
        # two float32 sums of one element in other orders: within 1e-6 of
        # the sum of its terms' magnitudes (0.2% of a typical element
        # here), and a bfloat16 result one unit in the last place more
        room = 1e-6 * conv_wgrad.conv_wgrad_ref(x.abs(), dy.abs(), k).float()
        if dtype == torch.bfloat16:
            room += 2.0 ** -7 * want.abs()
        worst = float(((got - want).abs() / room).max())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            conv_wgrad.conv_wgrad(x, dy, k)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        calls = conv_wgrad.LAUNCHES["conv_wgrad"] - before
        plain_ms, _ = _event_ms(lambda: conv_wgrad.conv_wgrad_ref(x, dy, k), 2)
        with mlayers.fp32_convs(dev):
            library_ms, _ = _event_ms(lambda: torch.nn.grad.conv3d_weight(
                x, (c_out, c_in, k, k, k), dy, padding=k // 2), 3)
        nbytes = (x.numel() + dy.numel() + got.numel()) * x.element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
                     "bound_by": "bytes", "rel_err": err, "worst_over_room": worst,
                     "timing_calls": calls}
        log(f"  conv_wgrad {name} ({c_in} -> {c_out}, {k}^3, {str(dtype)[6:]}, {batch} x {p}^3): "
            f"kernel {ms:.4f} ms against its bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s; share {bound / ms:.1%}); plain {plain_ms:.3f} ms; library_ms "
            f"(conv3d_weight, TF32 off) {library_ms:.3f} ms; |kernel - plain| / |plain| "
            f"{err:.2e}, worst element at {worst:.3f} of its room; {calls} calls")
        if not worst <= 1 or (dtype == torch.float32 and not err <= 1e-5) or calls != reps + 1:
            raise AssertionError(f"[19] conv_wgrad {name}: {worst} of the room, rel_err {err}, "
                                 f"{calls} calls")
    origin = direct_kernel_origin(dev, p, batch, f)
    for shapes, ms in origin:
        log(f"  before the kernel: cuDNN's wgrad2d_grouped_direct_kernel {ms:.3f} ms a step, "
            f"launched by aten::convolution_backward of (grad_output, input, weight) "
            f"{shapes[:3]}")
    out["direct_kernel_origin"] = origin
    return out


def conv_wgrad_entries(trained: dict) -> list:
    """The ``kernels`` line's rows of the weight-gradient kernel from
    ``training_phase``'s result: its timing at each convolution, and its
    launches on the phase's training path, one a step for each convolution
    (the timing's own calls are ``timing_calls``)."""
    return [{"name": f"conv_wgrad[{name}]", "route": "cuda", "source": CONV_WGRAD_SOURCE,
             "replaces": None, "launches": trained["conv_wgrad_launches"][name], **row}
            for name, row in trained["conv_wgrad"].items() if name != "direct_kernel_origin"]


def training_phase(dev, tmp: Path, p: int = TRAIN_P, batch: int = TRAIN_BATCH,
                   steps: int = TRAIN_STEPS, f32_steps: int = TRAIN_F32_STEPS,
                   f: int = TRAIN_F, check=TRAIN_CHECK, world: int = TRAIN_WORLD) -> dict:
    """Phase 19: ``Unet3D(init_features=f, dtype=bfloat16)`` trained on the
    card.  (a) ``steps`` Adam steps on a global batch of ``batch`` patches
    of p^3 in one process: every loss finite and the last below the first;
    the median step ms of steps 2 on, the peak memory, the share of the
    dense bf16 peak (3 forward passes a step) and a profiled step's idle
    share; then ``f32_steps`` of them in float32.  (b) ``world`` ranks on the one
    card over gloo, each on its rows of the same batch, the batch norms'
    statistics and the gradients summed over the group, in bfloat16 and in
    float32: each rank's record equals (a)'s within ``BF16_TOL`` and
    ``CARD_DP_TOL`` (``DP_TOL`` on the CPU).  (c) one float32 step at
    ``check`` (patch side, batch) on the card and on the CPU, equal within
    ``CARD_TOL``.  No sweep or ray kernel lies on this path (their counts
    must stay 0); on the card the single-channel convolutions' weight
    gradients launch ``ops/conv_wgrad.py``'s kernel, timed first
    (``conv_wgrad_timing``), two launches a step."""
    import pickle

    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[19] training: Unet3D(init_features={f}), {batch} patches of {p}^3, {steps} Adam "
        f"steps ({card})")
    t_phase = time.perf_counter()
    kernels.reset_launches()
    rays.reset_launches()
    wgrad = conv_wgrad_timing(dev, p, batch, f) if dev.type == "cuda" else None
    conv_wgrad.reset_launches()

    a, (model, opt, x, y) = train_run(dev, p, batch, steps, torch.bfloat16, f)
    if not all(np.isfinite(a["losses"])) or not a["losses"][-1] < a["losses"][0]:
        raise AssertionError(f"[19] (a) losses {a['losses']}")
    step_ms = float(np.median(a["ms"][1:]))
    flops = 3 * unet3d_flops(p, f) * batch
    tflops = flops / (step_ms / 1e3) / 1e12
    log(f"  (a) one process, bfloat16: losses {a['losses']}; step ms "
        f"{[round(v, 3) for v in a['ms']]}; median of steps 2-{steps} {step_ms:.3f} ms; peak "
        f"{a['peak_gib']:.2f} GiB; {flops / 1e12:.3f} TFLOP a step, {tflops:.2f} TFLOP/s, "
        f"{tflops / BF16_DENSE_TFLOPS:.2%} of the dense bf16 peak ({card})")
    idle = profile_train_step(dev, model, opt, x, y)
    del model, opt, x, y
    a32, _ = train_run(dev, p, batch, f32_steps, torch.float32, f)
    log(f"  (a) one process, float32: losses {a32['losses']}; step ms "
        f"{[round(v, 3) for v in a32['ms']]}; peak {a32['peak_gib']:.2f} GiB")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    one_card = {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]}
    runs = spawn_ranks("train", world, tmp / "ranks", p, dev.type, batch, backend="gloo",
                       timeout=600.0, env=one_card if dev.type == "cuda" else None,
                       job={"f": f, "runs": {"bfloat16": steps, "float32": f32_steps}})
    _check_ranks(runs, "[19] (b)")
    b_errs = []
    for r in range(world):
        got = pickle.loads((tmp / "ranks" / f"rank{r}.pkl").read_bytes())
        for name, want, tol in (("bfloat16", a, BF16_TOL), (
                "float32", a32, CARD_DP_TOL if dev.type == "cuda" else DP_TOL)):
            b_errs.append(compare_training(got[name], want, tol, f"[19] (b) rank {r} {name}"))
            log(f"  (b) rank {r} of {world} (gloo, {batch // world} patches), {name}: losses "
                f"{got[name]['losses']}; step ms {[round(v, 3) for v in got[name]['ms']]}; "
                f"peak {got[name]['peak_gib']:.2f} GiB; against (a): {b_errs[-1]}")
    log(f"  (b): {time.perf_counter() - t0:.1f} s with start-up")

    cp, cb = check
    c_card, _ = train_run(dev, cp, cb, 1, torch.float32, f)
    c_cpu, _ = train_run(torch.device("cpu"), cp, cb, 1, torch.float32, f)
    c_errs = compare_training(c_card, c_cpu, CARD_TOL, "[19] (c)")
    log(f"  (c) one float32 step at {cp}^3, batch {cb}: card {c_card['losses'][0]:.7f}, "
        f"CPU {c_cpu['losses'][0]:.7f}; errors {c_errs}")

    launches = {"sweeps": dict(kernels.LAUNCHES),
                "rays": {k: dict(v) for k, v in rays.LAUNCHES.items()},
                "conv_wgrad": dict(conv_wgrad.LAUNCHES)}
    seconds = time.perf_counter() - t_phase
    # one process's steps on the card: (a) steps + the profiled one + the
    # float32 steps, and (c)'s one; two single-channel convolutions each
    card_steps = steps + 1 + f32_steps + 1 if dev.type == "cuda" else 0
    log(f"  phase [19]: {seconds:.1f} s ({card}); kernel launches on this path: {launches} "
        f"(the weight-gradient kernel's: 2 a step on the card, {2 * card_steps} expected)")
    if any(kernels.LAUNCHES.values()) or any(
            v for per_axis in rays.LAUNCHES.values() for v in per_axis.values()):
        raise AssertionError(f"a sweep or ray kernel launched on the training path: {launches}")
    if launches["conv_wgrad"] != {"conv_wgrad": 2 * card_steps, "k1": card_steps,
                                  "k5": card_steps}:
        raise AssertionError(f"[19] weight-gradient kernel launches {launches['conv_wgrad']}, "
                             f"want {card_steps} for each of k 1 and 5")
    return {"losses": a["losses"], "step_ms": step_ms, "peak_gib": a["peak_gib"],
            "bf16_share": tflops / BF16_DENSE_TFLOPS, "idle_share": idle, "b": b_errs,
            "c": c_errs, "seconds": seconds, "conv_wgrad": wgrad,
            "conv_wgrad_launches": {"enc1_conv1": conv_wgrad.LAUNCHES["k5"],
                                    "conv": conv_wgrad.LAUNCHES["k1"]}}

def cdb_epilogue_phase(dev, launches: int, shape=(8, 64, 256, 256), reps: int = 50) -> dict:
    """Phase 20: the fused transition of a competitive dense block
    (``ops/cdb_epilogue.py``) after the first level's second convolution,
    on ``shape``: the bf16 convolution output normalised, its maximum with
    the float32 partner written in float32, then PReLU and the bf16 input
    of the next convolution.  The kernel's ms (``reps`` calls between one
    pair of CUDA events) against its bound (12 B an element over the device
    memory's bandwidth) and the plain version's ms; the two must agree bit
    for bit, as they must in the first block's entry (its 7 input channels
    normalised to bf16) and after a last convolution (float32 out only).
    Returns the ``kernels`` line's row, with ``launches`` the kernel's
    launches on phase [12]'s parcellation path (the timing's own calls are
    ``timing_calls``)."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[20] competitive dense block transition, {'x'.join(map(str, shape))} ({card})")
    gen = torch.Generator(device=dev).manual_seed(20)

    def case(shape):
        c = shape[1]
        y = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        var = 0.5 + torch.rand(c, device=dev, generator=gen)
        weight, mean, bias = (torch.randn(c, device=dev, generator=gen) for _ in range(3))
        return y, (mean, torch.rsqrt(var + 1e-5) * weight, bias)

    def same(y, **args):
        got = cdb_epilogue.cdb_epilogue(y, **args)
        want = cdb_epilogue.cdb_epilogue_ref(y, **args)
        torch.cuda.synchronize()
        return all((g is None and w is None) or torch.equal(
            g.view(torch.int32 if g.dtype == torch.float32 else torch.int16),
            w.view(torch.int32 if w.dtype == torch.float32 else torch.int16))
            for g, w in zip(got, want))

    y, norm = case(shape)
    skip = torch.randn(shape, device=dev, generator=gen)
    slope = torch.full((1,), 0.25, device=dev)
    args = dict(norm=norm, skip=skip, slope=slope, out=True, act=torch.bfloat16)
    entry_y, entry_norm = case((shape[0], 7) + tuple(shape[2:]))
    with torch.inference_mode():
        before = cdb_epilogue.LAUNCHES["cdb_epilogue"]
        modes = {"middle": same(y, **args),
                 "entry_in_block": same(entry_y, norm=entry_norm, act=torch.bfloat16),
                 "last": same(y, norm=norm, out=True)}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            cdb_epilogue.cdb_epilogue(y, **args)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        calls = cdb_epilogue.LAUNCHES["cdb_epilogue"] - before
        plain_ms, _ = _event_ms(lambda: cdb_epilogue.cdb_epilogue_ref(y, **args), 5)
    nbytes = y.numel() * (y.element_size() + 4 + 4 + 2)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  kernel {ms:.4f} ms against its bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s; share {bound / ms:.1%}); plain {plain_ms:.3f} ms; "
        f"bit-identical {modes}; {calls} calls here, {launches} on phase [12]'s "
        f"parcellation ({card})")
    if not all(modes.values()) or calls != reps + len(modes):
        raise AssertionError(f"[20] cdb_epilogue: bit-identical {modes}, {calls} calls")
    return {"name": "cdb_epilogue[middle]", "route": "cuda", "source": CDB_EPILOGUE_SOURCE,
            "replaces": None, "launches": launches, "timing_calls": calls, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "bit_identical": modes, "shape": list(shape), "card": card}


if __name__ == "__main__":
    sys.exit(main())

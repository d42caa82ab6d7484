#!/usr/bin/env python3
"""Time the 3D viewer's ops of a tree of the port on one NVIDIA GPU.

    python3 time_viewer.py               # the package of this checkout
    python3 time_viewer.py --root DIR    # the package under DIR (for example
                                         # a git archive of another commit)

On a Slice of ``make_ct(512)`` (int16, spacing 0.5 mm) and its Bone
surface (9,235,800 triangles), the ops of ``chip_smoke.py`` phase [11]
that dominate its time: shear-warp frames (warm), the gather raycaster,
the mask preview, the oblique reslice (20 degrees, three methods), the
splat renderer, visibility culling and the mask cut.  Per op:

- wall ms: the host clock around a call with the device synchronised,
  the median of ``REPS`` calls after one warm-up call;
- device ms and launches: one call under torch.profiler (kernels, copies
  and memsets; one warm-up step first), and the device's busy share of
  the wall time (device ms / wall ms: the rest is the host at work or
  waiting);
- the three device ops that take the most time.

It prints the card's name and power limit first and a JSON line of the
numbers last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from time_rays import card

REPS = 3  # timed calls per op


def wall_ms(fn) -> float:
    """Median host-clock ms of ``REPS`` calls after one warm-up call, the
    device synchronised around each."""
    fn()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profile_once(fn):
    """(device ms, launches, [(device op, ms, count)] sorted by ms) of one
    call of ``fn`` under torch.profiler, after one warm-up step."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # device ops only: an aten op's or a step's row repeats its kernels' time
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_time_total > 0
                   and not e.key.startswith(("aten::", "cuda", "ProfilerStep"))
                   and "Activity Buffer" not in e.key
                   and "Command Buffer Full" not in e.key), key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


def viewer_ops(dev, n: int = 512):
    """[(name, fn)] of the timed ops on ``make_ct(n)``."""
    import chip_smoke as cs
    from invesalius3_tpu_torch import constants as const
    from invesalius3_tpu_torch import pipeline
    from invesalius3_tpu_torch.core.slice import Slice
    from invesalius3_tpu_torch.core.volume import Volume
    from invesalius3_tpu_torch.ops import rasterize, raycast, render_mesh, reslice

    ct = pipeline.make_ct(n)
    sp = pipeline.SPACING
    slc = Slice(Volume.from_numpy(ct, spacing=sp, device=dev))
    mask = slc.create_new_mask(threshold_range=const.THRESHOLD_PRESETS_CT["Bone"])
    surf = slc.create_surface_from_mask(mask)
    v, f = surf.vertices, surf.faces
    m20 = cs._oblique(ct.shape, sp)
    cval = float(ct.min())
    mproj, mv = cs._scene_matrices(ct.shape, sp, 30, 20, n)
    poly = rasterize.polygon2mask((n, n), [(0.2 * n, 0.25 * n), (0.8 * n, 0.3 * n),
                                           (0.6 * n, 0.85 * n), (0.15 * n, 0.6 * n)],
                                  device=dev).t()
    ops = []
    for name in ("Bone", "Soft + Skin", "MIP"):
        p = raycast.builtin_preset(name)
        for size, ds in ((n, 1), (n // 2, 2)):
            ops.append((f"shear_warp {name} {size}/{ds}", lambda p=p, size=size, ds=ds:
                        raycast.shear_warp_render(slc.matrix, sp, p, 30, 20,
                                                  image_size=size, downsample=ds)))
    for name in ("Bone", "MIP"):
        ops.append((f"render {name} {n}, {n // 2} steps", lambda name=name: raycast.render(
            slc.matrix, sp, raycast.builtin_preset(name), 30, 20, image_size=n,
            n_steps=n // 2)))
    ops.append(("render_mask_preview", lambda: raycast.render_mask_preview(
        mask.data, sp, azimuth=30, elevation=20)))
    for method in (const.INTERP_TRILINEAR, const.INTERP_TRICUBIC, const.INTERP_LANCZOS):
        ops.append((f"reslice {cs.METHOD_NAMES[method]}", lambda method=method:
                    reslice.apply_view_matrix_transform(slc.matrix, sp, m20, 0, "AXIAL",
                                                        method, cval, ct.shape)))
    ops.append((f"render_surfaces ({len(f)} triangles)", lambda: render_mesh.render_surfaces(
        [(v, f, (0.9, 0.85, 0.75))], 30, 20, size=n, max_triangles=len(f) + 1, device=dev)))
    ops.append(("remove_non_visible_faces (6 views)", lambda:
                render_mesh.remove_non_visible_faces(v, f, size=n, device=dev)))
    ops.append(("mask_cut", lambda: rasterize.mask_cut(mask.data, sp, 1e9, poly, mproj, mv,
                                                       0)))
    return ops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="directory holding the invesalius3_tpu_torch package to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_viewer: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    print(f"card: {card()}", flush=True)
    dev = torch.device("cuda")
    out = {}
    for name, fn in viewer_ops(dev):
        wall = wall_ms(fn)
        dev_ms, launches, rows = profile_once(fn)
        out[name] = {"wall_ms": wall, "device_ms": dev_ms, "launches": launches,
                     "busy": dev_ms / wall}
        print(f"  {name}: wall {wall:.2f} ms, device {dev_ms:.2f} ms ({dev_ms / wall:.1%} "
              f"busy), {launches} launches; "
              + "; ".join(f"{k[:50]} {ms:.2f} ms x{c}" for k, ms, c in rows[:3]), flush=True)
    print(json.dumps({"root": str(root), "ops": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

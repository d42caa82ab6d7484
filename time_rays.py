#!/usr/bin/env python3
"""Time the LMIP and MIDA ray kernels of a tree of the port on one NVIDIA GPU.

    python3 time_rays.py               # the package of this checkout
    python3 time_rays.py --root DIR    # the package under DIR (for example a
                                       # git archive of another commit)

On ``make_ct(512)`` (int16, 256 MiB on the card), full depth, with the
frame path's parameters (LMIP (40, 40), MIDA (40, 40)), per kernel and axis:

- wrapper ms: ``lmip_rays`` / ``mida_rays`` as the frame path calls them;
- kernel ms: the library call alone on pre-allocated buffers, where the
  tree exposes it (``lmip_launch`` / ``mida_launch``);
- a torch.profiler window over a few wrapper calls: device time per call
  by kernel name and device launches per call (the only kernel time this
  script can read from a tree without ``*_launch``).

Every ms is N back-to-back calls between one pair of CUDA events after a
warm-up, divided by N.  Then the min/max pass against ``torch.aminmax`` on
the same slab, and the slab frame: ``Slice.project`` ms (the same method)
and ``get_rendered_slice`` ms (host clock, RGB on the host, median) for
LMIP and MIDA in every orientation at slabs 64 and 512, window 400/40 and
the bone mask shown, as in ``chip_smoke.py`` phase [7].  It prints the
card's name and power limit first and a JSON line of the numbers last.
``chip_smoke.py`` phase [8] runs the same functions on this checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_CALLS = 50       # calls between one pair of events
N_PROFILED = 5     # wrapper calls in the profiler window
PARAMS = (40.0, 40.0)


def event_ms(fn, n: int = N_CALLS, warm: int = 3) -> float:
    """Milliseconds per call of ``fn``: ``warm`` calls, then ``n``
    back-to-back calls between one pair of CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profile_per_call(fn, n: int = N_PROFILED):
    """[(device op, device ms per call, launches per call)] of ``n`` calls
    of ``fn`` under torch.profiler (kernels, copies and memsets).  Two
    warm-up steps come first: events at the very start of a profiling
    window can be lost, most often in a process that profiled before."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=2, active=n, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2 + n):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # device ops only: an aten op's or a step's row repeats its kernels' time
    return [(e.key, e.device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_time_total > 0
            and not e.key.startswith(("aten::", "cuda", "ProfilerStep"))
            and "Activity Buffer" not in e.key]


def time_kernels(rays, volume: torch.Tensor, log=print):
    """{(kernel, axis): {"kernel_ms", "wrapper_ms", "device_ms",
    "launches_per_call", "profile"}} at full depth on ``volume``."""
    out = {}
    for k in ("lmip", "mida"):
        wrapper = getattr(rays, f"{k}_rays")
        launcher = getattr(rays, f"{k}_launch", None)
        for axis in (0, 1, 2):
            row = {"wrapper_ms": event_ms(lambda: wrapper(volume, axis, *PARAMS)),
                   "kernel_ms": None}
            if launcher is not None:
                launch = launcher(volume, axis, *PARAMS)

                def raw():
                    if launch.fn(*launch.args) != 0:
                        raise RuntimeError(f"{k} axis {axis}: launch failed")
                row["kernel_ms"] = event_ms(raw)
            prof = profile_per_call(lambda: wrapper(volume, axis, *PARAMS))
            row["profile"] = prof
            row["device_ms"] = sum(ms for _, ms, _ in prof)
            row["launches_per_call"] = sum(c for _, _, c in prof)
            out[(k, axis)] = row
            kms = "n/a" if row["kernel_ms"] is None else f"{row['kernel_ms']:.4f}"
            log(f"  {k} axis {axis}: kernel {kms} ms, wrapper {row['wrapper_ms']:.4f} ms; "
                f"profiler: {row['device_ms']:.4f} ms of device time and "
                f"{row['launches_per_call']:g} device launches a call: "
                + "; ".join(f"{name[:60]} {ms:.4f} ms x{c:g}" for name, ms, c in prof))
    return out


def time_minmax(rays, volume: torch.Tensor, log=print):
    """(min/max pass ms, torch.aminmax ms) on ``volume``, or None where the
    tree has no min/max pass of its own."""
    launcher = getattr(rays, "minmax_launch", None)
    if launcher is None:
        return None
    launch = launcher(volume)
    got = rays.slab_minmax(volume)
    want = torch.stack(torch.aminmax(volume)).to(torch.float32)
    if not torch.equal(got, want):
        raise AssertionError(f"min/max pass {got.tolist()} != aminmax {want.tolist()}")
    pass_ms = event_ms(lambda: launch.fn(*launch.args))
    lib_ms = event_ms(lambda: torch.aminmax(volume))
    log(f"  min/max pass {pass_ms:.4f} ms, torch.aminmax {lib_ms:.4f} ms "
        f"(the same slab, {volume.numel() * volume.element_size() / 2**20:.0f} MiB)")
    return pass_ms, lib_ms


def time_frames(slc, const, n: int, log=print):
    """[(type, orientation, slab, project ms, frame ms)] for LMIP and MIDA:
    project by CUDA events over many calls, the rendered frame (RGB on the
    host) by the host clock, median of 7."""
    rows = []
    for p in (const.PROJECTION_LMIP, const.PROJECTION_MIDA):
        for o in (const.AXIAL, const.CORONAL, const.SAGITTAL):
            for start, slabs in ((n * 7 // 16, n // 8), (0, n)):
                proj = event_ms(lambda: slc.project(o, start, slabs, projection=p), n=20)
                t = []
                for _ in range(8):
                    t0 = time.perf_counter()
                    slc.get_rendered_slice(o, start, projection=p, slabs=slabs)
                    t.append((time.perf_counter() - t0) * 1e3)
                frame = float(np.median(t[1:]))
                rows.append((const.PROJECTION_NAMES[p], o, slabs, proj, frame))
                log(f"  {const.PROJECTION_NAMES[p]:>5s} {o:>8s} slab {slabs:3d}: "
                    f"project {proj:.4f} ms, frame {frame:.3f} ms")
    return rows


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="directory holding the invesalius3_tpu_torch package to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_rays: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from invesalius3_tpu_torch import _build, pipeline
    from invesalius3_tpu_torch import constants as const
    from invesalius3_tpu_torch.core.slice import Slice
    from invesalius3_tpu_torch.core.volume import Volume
    from invesalius3_tpu_torch.ops import projection_kernels as rays

    print(f"card: {card()}", flush=True)
    print(f"tree: {root} (package {Path(rays.__file__).resolve().parent.parent})", flush=True)
    t0 = time.perf_counter()
    _build.ray_projections_lib()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    kernel = None
    for line in _build.BUILD_LOG.get("ray_projections", {}).get("log", "").splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line and kernel:
            print(f"  {kernel}: {line.split(':', 1)[1].strip()}", flush=True)
    n = 512
    vol = Volume.from_numpy(pipeline.make_ct(n), spacing=pipeline.SPACING,
                            device=torch.device("cuda"))
    slc = Slice(vol)
    slc.set_window(400.0, 40.0)
    slc.create_new_mask(threshold_range=const.THRESHOLD_PRESETS_CT["Bone"])
    log = lambda *a: print(*a, flush=True)  # noqa: E731
    kernels = time_kernels(rays, slc.matrix, log)
    minmax = time_minmax(rays, slc.matrix, log)
    frames = time_frames(slc, const, n, log)
    print(json.dumps({
        "root": str(root),
        "kernels": {f"{k}[axis={a}]": {key: v for key, v in row.items() if key != "profile"}
                    for (k, a), row in kernels.items()},
        "minmax": minmax, "frames": frames}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

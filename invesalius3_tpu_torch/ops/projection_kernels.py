"""The slab ray projections: hand-written CUDA kernels and their plain
versions.

``lmip_rays`` and ``mida_rays`` are the port of the TPU kernels
``lmip_axis0`` and ``mida_axis0`` (invesalius3_tpu/ops/pallas_kernels.py:81,
:147), generalised to any projection axis of a strided 3-D view.  A CUDA
tensor goes through ``csrc/ray_projections.cu``; only a CPU tensor takes the
plain versions ``lmip_ref`` / ``mida_ref``, which walk the ray in a Python
loop with the operation order of ``projections.lmip_scan`` and
``projections.mida_scan`` of the JAX package.  The kernels store the plane
in the slab's dtype with JAX's float-to-integer semantics (``store_cast``,
equal to ``cast_like_jax``); a dtype they are not templated for is walked
as float32 and cast by ``cast_like_jax``.  MIDA's min/max pass
(``slab_minmax``) is a kernel of the same library.

The wrappers' choices are plain functions: ``ray_route`` (the rows route's
shared-memory tiles for contiguous rows, the columns route's one ray a
thread otherwise), ``flat_view`` (the min/max pass's runs), ``store_dtype``
and ``table_fits`` (the rule by which the min/max pass lets MIDA read its
per-value table).  ``lmip_launch`` /
``mida_launch`` / ``minmax_launch`` return one library call on
pre-allocated buffers, which the wrappers run (and ``chip_smoke.py``
times alone).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch import _build
from invesalius3_tpu_torch.ops.casting import cast_like_jax
from invesalius3_tpu_torch.ops.windowing import get_opacity

# kernel launches per (kernel, projection axis); incremented only where the
# CUDA kernel is launched (callers reset the counts to measure one run)
# (the min/max pass, which every MIDA call runs too, under "minmax" 0)
LAUNCHES: Dict[str, Dict[int, int]] = {"lmip": {0: 0, 1: 0, 2: 0},
                                       "mida": {0: 0, 1: 0, 2: 0},
                                       "minmax": {0: 0}}

_DTYPE_CODE = {torch.float32: 0, torch.int16: 1, torch.uint8: 2}


def reset_launches() -> None:
    for per_axis in LAUNCHES.values():
        for axis in per_axis:
            per_axis[axis] = 0


def _check(volume: torch.Tensor, axis: int) -> None:
    if volume.dim() != 3:
        raise ValueError(f"need a 3-D volume, got shape {tuple(volume.shape)}")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    if volume.shape[axis] < 1 or volume.numel() == 0:
        raise ValueError(f"empty slab {tuple(volume.shape)}")
    if volume.dtype == torch.bool or volume.is_complex():
        raise TypeError(f"unsupported dtype {volume.dtype}")


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# plain versions (the counterparts of lmip_scan / mida_scan)
# ---------------------------------------------------------------------------


def lmip_ref(volume: torch.Tensor, axis: int, tmin: float,
             tmax: float) -> torch.Tensor:
    """First local maximum after the ray enters [tmin, tmax]: a running
    max; once a value in range has been seen, the first strict decrease
    stops the ray.  Returns the plane in the input dtype."""
    _check(volume, axis)
    lanes = volume.movedim(axis, 0)
    lo, hi = _f32(tmin, volume.device), _f32(tmax, volume.device)
    max_val = lanes[0]
    start = (max_val >= lo) & (max_val <= hi)
    stopped = torch.zeros_like(start)
    for z in range(lanes.shape[0]):
        val = lanes[z]
        greater = val > max_val
        less = val < max_val
        new_stopped = stopped | (less & start & ~stopped)
        max_val = torch.where(~stopped & greater, val, max_val)
        in_range = (val >= lo) & (val <= hi)
        start = torch.where(~new_stopped, start | in_range, start)
        stopped = new_stopped
    return max_val


def mida_ref(volume: torch.Tensor, axis: int, wl: float,
             ww: float) -> torch.Tensor:
    """MIDA over the slab: intensities normalised by the slab's min and
    range; each new running max re-weights what is behind it
    (bt = 1 - delta); front-to-back compositing with the WW/WL opacity,
    frozen once alpha reaches 1.  Returns the plane in the input dtype."""
    _check(volume, axis)
    lanes = volume.movedim(axis, 0).to(torch.float32)
    img_min = lanes.amin()
    rng = lanes.amax() - img_min
    shape = lanes.shape[1:]
    zeros = lambda: torch.zeros(shape, dtype=torch.float32, device=volume.device)  # noqa: E731
    fmax, alpha_p, colour_p = zeros(), zeros(), zeros()
    stopped = torch.zeros(shape, dtype=torch.bool, device=volume.device)
    zero = _f32(0.0, volume.device)
    for z in range(lanes.shape[0]):
        vl = lanes[z]
        fpi = (vl - img_min) / rng
        dl = torch.maximum(fpi - fmax, zero)
        new_fmax = torch.maximum(fmax, fpi)
        bt = 1.0 - dl
        alpha = get_opacity(vl, wl, ww)
        colour = bt * colour_p + (1.0 - bt * alpha_p) * fpi * alpha
        new_alpha = bt * alpha_p + (1.0 - bt * alpha_p) * alpha
        fmax = torch.where(stopped, fmax, new_fmax)
        alpha_p = torch.where(stopped, alpha_p, new_alpha)
        colour_p = torch.where(stopped, colour_p, colour)
        stopped = stopped | (alpha_p >= 1.0)
    return cast_like_jax(rng * colour_p + img_min, volume.dtype)


# ---------------------------------------------------------------------------
# the choices the wrappers make (plain functions, tested on the CPU)
# ---------------------------------------------------------------------------

ROUTE_COLUMNS, ROUTE_ROWS = 0, 1
# MIDA's per-value table: entries a block holds in shared memory
TABLE_CAP = {torch.int16: 4096, torch.uint8: 256}


def store_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the kernels walk and store: the slab's own where they are
    templated for it (the integer store then casts as ``store_cast``), else
    float32 (the wrapper widens the slab and ``cast_like_jax`` casts the
    plane)."""
    return dtype if dtype in _DTYPE_CODE else torch.float32


def store_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernels' store of a float result as ``dtype``, element by element
    as the device does it: NaN -> 0, at or past a bound -> the bound, else
    truncated toward zero (JAX's ``astype``, which ``cast_like_jax`` is)."""
    if dtype.is_floating_point:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    lo, hi = float(info.min), float(info.max)
    y = torch.where(x >= hi, hi, torch.where(x <= lo, lo, x.trunc()))
    return torch.where(torch.isnan(x), 0.0, y).to(dtype)


def ray_geometry(shape, strides, axis: int) -> tuple:
    """(n, ray_stride, rows, cols, row_stride, col_stride) in elements: the
    rays run along ``axis``, the output plane's rows and columns along the
    other two axes in order."""
    r, c = [a for a in range(3) if a != axis]
    return (shape[axis], strides[axis], shape[r], shape[c], strides[r], strides[c])


def ray_route(ray_stride: int, col_stride: int) -> int:
    """Rows route (shared-memory tiles) where the rays are contiguous rows
    and neighbouring rays are not adjacent (axis 2); columns route (a ray a
    thread, straight from device memory) otherwise: neighbouring rays
    adjacent (axes 0 and 1) or any other strides."""
    return ROUTE_ROWS if ray_stride == 1 and col_stride != 1 else ROUTE_COLUMNS


@functools.lru_cache(maxsize=256)
def flat_view(shape, strides) -> tuple:
    """The min/max pass's view of a slab: (d0, d1, len, s0, s1, s2), its
    dims ordered by stride, size-1 dims dropped and neighbours merged where
    they are contiguous, so a narrowed slab becomes one run (axis 0) or
    rows of one contiguous run (axes 1 and 2)."""
    dims = sorted(((n, s) for n, s in zip(shape, strides) if n != 1),
                  key=lambda d: -d[1])
    merged = []
    for n, s in dims:
        if merged and merged[-1][1] == n * s:
            merged[-1] = (merged[-1][0] * n, s)
        else:
            merged.append((n, s))
    merged = merged or [(1, 1)]
    merged = [(1, 0)] * (3 - len(merged)) + merged
    (d0, s0), (d1, s1), (n, s2) = merged
    return d0, d1, n, s0, s1, s2


def table_fits(vmin: float, vmax: float, dtype: torch.dtype) -> bool:
    """Whether MIDA's walk reads fpi and alpha from its per-value table
    (the min/max pass decides this on the card from the slab's min and
    max, by this rule); otherwise it computes them per element."""
    cap = TABLE_CAP.get(dtype, 0)
    return cap > 0 and int(vmax - vmin) + 1 <= cap


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


class Launch(NamedTuple):
    """One library call on pre-allocated buffers: ``fn(*args)`` launches
    the kernels into ``out`` on the slab's current stream.  ``slab`` is the
    tensor the kernels read (a float32 copy where the wrapper widened the
    slab), held so that its memory lives as long as the call."""
    fn: Callable[..., int]
    args: tuple
    out: torch.Tensor
    slab: torch.Tensor


# the min/max pass's workspace (counter, min/max, partials, MIDA's table),
# one per device and stream, zeroed once
_WORKSPACES: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace(lib, device: torch.device, stream: int) -> torch.Tensor:
    ws = _WORKSPACES.get((device.index, stream))
    if ws is None:
        ws = torch.zeros(lib.ray_workspace_bytes(), dtype=torch.uint8, device=device)
        _WORKSPACES[(device.index, stream)] = ws
    return ws


def _prepare(volume: torch.Tensor, axis: int):
    """(library, slab the kernels walk, its dtype code, route, geometry,
    stream)."""
    dtype = store_dtype(volume.dtype)
    work = volume if dtype == volume.dtype else volume.to(dtype)
    g = ray_geometry(work.shape, work.stride(), axis)
    route = ray_route(g[1], g[5])
    stream = torch.cuda.current_stream(work.device).cuda_stream
    return _build.ray_projections_lib(), work, _DTYPE_CODE[work.dtype], route, g, stream


def lmip_launch(volume: torch.Tensor, axis: int, tmin: float, tmax: float) -> Launch:
    lib, work, code, route, g, stream = _prepare(volume, axis)
    out = torch.empty(g[2:4], dtype=work.dtype, device=work.device)
    return Launch(lib.lmip_rays, (work.data_ptr(), out.data_ptr(), code, route, *g,
                                  float(tmin), float(tmax), stream), out, work)


def mida_launch(volume: torch.Tensor, axis: int, wl: float, ww: float) -> Launch:
    lib, work, code, route, g, stream = _prepare(volume, axis)
    out = torch.empty(g[2:4], dtype=work.dtype, device=work.device)
    ws = _workspace(lib, work.device, stream)
    return Launch(lib.mida_rays, (work.data_ptr(), out.data_ptr(), code, route, *g,
                                  *flat_view(work.shape, work.stride()), ws.data_ptr(),
                                  float(wl), float(ww), stream), out, work)


def minmax_launch(volume: torch.Tensor) -> Launch:
    """The min/max pass alone; ``out`` is the workspace's (min, max), valid
    until the next min/max pass on this stream."""
    lib, work, code, _, _, stream = _prepare(volume, 0)
    ws = _workspace(lib, work.device, stream)
    return Launch(lib.slab_minmax, (work.data_ptr(), code,
                                    *flat_view(work.shape, work.stride()),
                                    ws.data_ptr(), stream),
                  ws[16:24].view(torch.float32), work)


def _run(launch: Launch, name: str, volume: torch.Tensor, axis: int) -> None:
    index = volume.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            err = launch.fn(*launch.args)
    else:
        err = launch.fn(*launch.args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed (axis {axis}, shape "
                           f"{tuple(volume.shape)}, strides {volume.stride()}, "
                           f"{volume.dtype}): error {err}")


def _cuda_or_ref(volume: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); anything else raises."""
    if volume.device.type == "cuda":
        return True
    if volume.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {volume.device}")


def lmip_rays(volume: torch.Tensor, axis: int, tmin: float,
              tmax: float) -> torch.Tensor:
    """LMIP along ``axis`` of a 3-D (strided) view; the plane in the input
    dtype.  CUDA tensors launch the kernel on the current stream; CPU
    tensors take ``lmip_ref``."""
    _check(volume, axis)
    if not _cuda_or_ref(volume):
        return lmip_ref(volume, axis, tmin, tmax)
    launch = lmip_launch(volume, axis, tmin, tmax)
    _run(launch, "lmip_rays", volume, axis)
    LAUNCHES["lmip"][axis] += 1
    out = launch.out
    return out if out.dtype == volume.dtype else cast_like_jax(out, volume.dtype)


def mida_rays(volume: torch.Tensor, axis: int, wl: float,
              ww: float) -> torch.Tensor:
    """MIDA along ``axis`` of a 3-D (strided) view, normalised by the
    slab's own min and range; the plane in the input dtype.  CUDA tensors
    launch the min/max pass and the walk on the current stream; CPU
    tensors take ``mida_ref``."""
    _check(volume, axis)
    if not _cuda_or_ref(volume):
        return mida_ref(volume, axis, wl, ww)
    launch = mida_launch(volume, axis, wl, ww)
    _run(launch, "mida_rays", volume, axis)
    LAUNCHES["mida"][axis] += 1
    LAUNCHES["minmax"][0] += 1
    out = launch.out
    return out if out.dtype == volume.dtype else cast_like_jax(out, volume.dtype)


def minmax_ref(volume: torch.Tensor) -> torch.Tensor:
    """The slab's (min, max) as float32; NaN for both if any is NaN."""
    return torch.stack(torch.aminmax(volume)).to(torch.float32)


def slab_minmax(volume: torch.Tensor) -> torch.Tensor:
    """MIDA's min/max pass alone: (min, max) of a 3-D (strided) view as
    float32.  CUDA tensors launch the pass; CPU tensors take
    ``minmax_ref``."""
    _check(volume, 0)
    if not _cuda_or_ref(volume):
        return minmax_ref(volume)
    launch = minmax_launch(volume)
    _run(launch, "slab_minmax", volume, 0)
    LAUNCHES["minmax"][0] += 1
    return launch.out.clone()


def ray_case(shape, dtype, seed: int) -> np.ndarray:
    """A CT-like random volume for holding the kernels against their plain
    versions: air, soft tissue and bone runs along every axis, with noise,
    so rays start, rise, fall and stop."""
    r = np.random.default_rng(seed)
    base = r.choice(np.array([-1000, 40, 400, 1200], np.float32), size=shape,
                    p=[0.3, 0.4, 0.15, 0.15])
    v = base + r.integers(-30, 30, shape).astype(np.float32)
    if np.dtype(dtype) == np.uint8:
        v = (v + 1000.0) / 2300.0 * 255.0
    if np.issubdtype(np.dtype(dtype), np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(v), info.min, info.max).astype(dtype)
    return (np.rint(v * 4.0) / 4.0).astype(dtype)


# parameter sets every ray case runs: LMIP (tmin, tmax) and MIDA (wl, ww),
# with the Slice's degenerate (wl, wl) and a zero window level
LMIP_PARAMS = [(30.0, 500.0), (40.0, 40.0), (0.0, 0.0)]
MIDA_PARAMS = [(40.0, 400.0), (40.0, 40.0), (0.0, 0.0)]


class RayCase(NamedTuple):
    """A slab that holds the kernels against their plain versions: a view of
    ``volume`` narrowed to ``narrow`` (start, length) along ``axis``,
    flipped when ``inverted`` (a copy, as in the Slice), its storage
    starting ``offset`` elements into an aligned allocation, every
    ``step``-th element along y and x."""
    label: str
    volume: np.ndarray
    axis: int
    narrow: Optional[Tuple[int, int]] = None
    inverted: bool = False
    offset: int = 0
    step: int = 1   # every step-th element along y and x


def _range_case(shape, lo: int, count: int, seed: int) -> np.ndarray:
    """int16 values spanning exactly ``count`` values from ``lo`` (both ends
    present): MIDA's table at, or past, its capacity."""
    v = np.random.default_rng(seed).integers(lo, lo + count, shape).astype(np.int16)
    v.flat[0], v.flat[-1] = lo, lo + count - 1
    return v


def ray_cases():
    """The cases that hold the kernels against their plain versions, every
    axis each: unaligned and cubic shapes, int16 / float32 / uint8, inverted
    and narrowed slabs, a constant slab (MIDA's NaN path); an odd x and an x
    that is not a multiple of the rays a thread; slabs offset by one element
    (a misaligned base); rays longer than the rows route's ring and rays of
    length 1 and 2; a slab strided along y and x; int16 value ranges at
    MIDA's table capacity and one past it; a float32 slab holding a NaN (the
    min/max pass's NaN rule)."""
    cases = []

    def every_axis(label, v, **kw):
        cases.extend(RayCase(f"{label} axis {a}", v, a, **kw) for a in (0, 1, 2))

    for shape in [(9, 13, 150), (64, 64, 64)]:
        for dtype in (np.int16, np.float32):
            v = ray_case(shape, dtype, seed=len(cases))
            every_axis(f"{shape} {np.dtype(dtype).name}", v)
            every_axis(f"{shape} {np.dtype(dtype).name} inverted", v, inverted=True)
    for dtype in (np.int16, np.float32, np.uint8):
        name = np.dtype(dtype).name
        every_axis(f"64^3 {name} narrowed slab 17:46",
                   ray_case((64, 64, 64), dtype, seed=100), narrow=(17, 29))
        every_axis(f"(7, 9, 101) {name} odd x", ray_case((7, 9, 101), dtype, seed=101))
        every_axis(f"(9, 13, 150) {name} offset 1",
                   ray_case((9, 13, 150), dtype, seed=102), offset=1)
        every_axis(f"(3, 5, 2500) {name} long rows", ray_case((3, 5, 2500), dtype, seed=103))
        every_axis(f"(4, 6, 1) {name} rays of 1", ray_case((4, 6, 1), dtype, seed=104))
        every_axis(f"(4, 6, 2) {name} rays of 2", ray_case((4, 6, 2), dtype, seed=105))
    for dtype in (np.int16, np.float32):
        every_axis(f"constant {np.dtype(dtype).name}", np.full((12, 20, 30), 77, dtype))
    stepped = ray_case((9, 13, 150), np.int16, seed=110)
    for a in (0, 1, 2):   # strided rays and columns: the columns route
        cases.append(RayCase(f"(9, 13, 150) int16 every other x and y axis {a}", stepped, a,
                             step=2))
    every_axis("int16 range at the table's capacity",
               _range_case((10, 12, 70), -1024, TABLE_CAP[torch.int16], seed=106))
    every_axis("int16 range one past the table's capacity",
               _range_case((10, 12, 70), -1024, TABLE_CAP[torch.int16] + 1, seed=107))
    every_axis("uint8 full range", _range_case((10, 12, 70), 0, 256, seed=108)
               .astype(np.uint8))
    nan = ray_case((9, 13, 150), np.float32, seed=109)
    nan[3, 4, 5] = np.nan   # not the first element of any ray
    every_axis("float32 with a NaN", nan)
    return cases


def case_slab(case: RayCase, device) -> torch.Tensor:
    """The slab a case projects, on ``device``."""
    v = torch.from_numpy(case.volume)
    if case.offset:
        buf = torch.zeros(v.numel() + case.offset, dtype=v.dtype, device=device)
        vol = buf[case.offset:].view(v.shape)
        vol.copy_(v)
    else:
        vol = v.to(device)
    slab = vol if case.narrow is None else vol.narrow(case.axis, *case.narrow)
    slab = slab[:, ::case.step, ::case.step]
    return torch.flip(slab, dims=(case.axis,)) if case.inverted else slab

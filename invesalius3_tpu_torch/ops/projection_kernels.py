"""The slab ray projections: hand-written CUDA kernels and their plain
versions.

``lmip_rays`` and ``mida_rays`` are the port of the TPU kernels
``lmip_axis0`` and ``mida_axis0`` (invesalius3_tpu/ops/pallas_kernels.py:81,
:147), generalised to any projection axis of a strided 3-D view.  A CUDA
tensor goes through ``csrc/ray_projections.cu``; only a CPU tensor takes the
plain versions ``lmip_ref`` / ``mida_ref``, which walk the ray in a Python
loop with the operation order of ``projections.lmip_scan`` and
``projections.mida_scan`` of the JAX package.  Outputs are cast back to the
input dtype with JAX's float-to-integer semantics (``cast_like_jax``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.ops.casting import cast_like_jax
from invesalius3_tpu_torch.ops.windowing import get_opacity

# kernel launches per (kernel, projection axis); incremented only where the
# CUDA kernel is launched (callers reset the counts to measure one run)
LAUNCHES: Dict[str, Dict[int, int]] = {"lmip": {0: 0, 1: 0, 2: 0},
                                       "mida": {0: 0, 1: 0, 2: 0}}

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
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _ray_layout(volume: torch.Tensor, axis: int) -> Tuple[torch.Tensor, tuple]:
    """(tensor the kernel walks, (n, ray_stride, rows, cols, row_stride,
    col_stride)).  Widens dtypes the kernels do not template to float32.

    An axis-2 slab is walked as the strided view: its rays are contiguous
    rows, so neighbouring threads read a row apart, and yet at 512^3 int16
    that beat copying the slab to (X, Z, Y) and walking axis 0 coalesced
    (LMIP 0.48 against 1.81 ms, MIDA 0.61 against 2.12 ms, full depth, on
    an NVIDIA H100 80GB HBM3 at 700 W; chip_smoke.py times both)."""
    if volume.dtype not in _DTYPE_CODE:
        volume = volume.to(torch.float32)
    r, c = [a for a in range(3) if a != axis]
    st = volume.stride()
    return volume, (volume.shape[axis], st[axis], volume.shape[r],
                    volume.shape[c], st[r], st[c])


def _launch_check(err: int, name: str, volume: torch.Tensor, axis: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed (axis {axis}, shape "
                           f"{tuple(volume.shape)}, {volume.dtype}): error {err}")


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
    from invesalius3_tpu_torch import _build

    lib = _build.ray_projections_lib()
    work, (n, rs, rows, cols, r_st, c_st) = _ray_layout(volume, axis)
    out = torch.empty((rows, cols), dtype=work.dtype, device=work.device)
    with torch.cuda.device(work.device):
        stream = torch.cuda.current_stream(work.device).cuda_stream
        err = lib.lmip_rays(work.data_ptr(), out.data_ptr(),
                            _DTYPE_CODE[work.dtype], n, rs, rows, cols,
                            r_st, c_st, float(tmin), float(tmax), stream)
    _launch_check(err, "lmip_rays", volume, axis)
    LAUNCHES["lmip"][axis] += 1
    return cast_like_jax(out, volume.dtype)


def mida_rays(volume: torch.Tensor, axis: int, wl: float,
              ww: float) -> torch.Tensor:
    """MIDA along ``axis`` of a 3-D (strided) view, normalised by the
    slab's own min and range; the plane in the input dtype.  CUDA tensors
    launch the kernel on the current stream; CPU tensors take
    ``mida_ref``."""
    _check(volume, axis)
    if not _cuda_or_ref(volume):
        return mida_ref(volume, axis, wl, ww)
    from invesalius3_tpu_torch import _build

    lib = _build.ray_projections_lib()
    minmax = torch.stack(torch.aminmax(volume)).to(torch.float32)
    work, (n, rs, rows, cols, r_st, c_st) = _ray_layout(volume, axis)
    out = torch.empty((rows, cols), dtype=torch.float32, device=work.device)
    with torch.cuda.device(work.device):
        stream = torch.cuda.current_stream(work.device).cuda_stream
        err = lib.mida_rays(work.data_ptr(), out.data_ptr(),
                            _DTYPE_CODE[work.dtype], n, rs, rows, cols,
                            r_st, c_st, minmax.data_ptr(), float(wl),
                            float(ww), stream)
    _launch_check(err, "mida_rays", volume, axis)
    LAUNCHES["mida"][axis] += 1
    return cast_like_jax(out, volume.dtype)


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


def ray_cases():
    """The cases that hold the kernels against their plain versions:
    (label, volume (numpy), axis, narrow (start, length) or None, inverted).
    Unaligned and cubic shapes, int16 / float32 / uint8, every axis,
    inverted slabs, a narrowed slab of a 64^3 volume and a constant slab
    (MIDA's NaN path)."""
    cases = []
    for shape in [(9, 13, 150), (64, 64, 64)]:
        for dtype in (np.int16, np.float32):
            v = ray_case(shape, dtype, seed=len(cases))
            for axis in (0, 1, 2):
                for inverted in (False, True):
                    cases.append((f"{shape} {np.dtype(dtype).name} axis {axis}"
                                  f"{' inverted' if inverted else ''}",
                                  v, axis, None, inverted))
    for dtype in (np.int16, np.float32, np.uint8):
        v = ray_case((64, 64, 64), dtype, seed=100)
        for axis in (0, 1, 2):
            cases.append((f"64^3 {np.dtype(dtype).name} narrowed slab 17:46 axis {axis}",
                          v, axis, (17, 29), False))
    for dtype in (np.int16, np.float32):
        v = np.full((12, 20, 30), 77, dtype)
        for axis in (0, 1, 2):
            cases.append((f"constant {np.dtype(dtype).name} axis {axis}", v, axis,
                          None, False))
    return cases


def case_slab(volume: torch.Tensor, axis: int, narrow, inverted: bool) -> torch.Tensor:
    """The slab a case projects: a view of ``volume`` (narrowed), flipped
    along ``axis`` when inverted (a copy, as in the Slice)."""
    slab = volume if narrow is None else volume.narrow(axis, *narrow)
    return torch.flip(slab, dims=(axis,)) if inverted else slab

"""Volume rendering: the gather raycaster (composite / MIP, shading, crop
plane), the shear-warp renderer, the mask preview and the raycasting
presets (port of invesalius3_tpu/ops/raycast.py).

Reference: invesalius/data/volume.py ``Volume`` :110 — builds VTK
color/opacity transfer functions from raycasting preset plists
(presets/raycasting/*.plist: ``16bitClutCurves``/``16bitClutColors`` node
lists, ``useShading``, ``projection``, WW/WL) and renders with
vtkOpenGLGPUVolumeRayCastMapper / vtkFixedPointVolumeRayCastMapper
(:636-646), MIP mode at :520-536, crop plane ``CutPlane`` :745.

Everything runs as plain PyTorch on the volume's device.  ``raycast``
marches every screen ray through the volume: one trilinear sample (and six
more for shading) per step, the RGBA LUT looked up by index, front-to-back
compositing; the loop stops once every ray is opaque, which changes no
pixel.  ``shear_warp_render`` permutes the volume so the principal viewing
axis is the slice axis (cached per camera octant), shears each slice onto
an intermediate image and composites slice over slice, then warps that
image to the screen.  Each slice's window offset (``iu``, ``iv``) is
computed on the host in float32 and drives plain slicing; the window is
clamped to the image as ``lax.dynamic_slice`` clamps it.  The colour map
is the preset's piecewise-linear knots in relu form (``_preset_knots``),
evaluated on batches of slices; only the composite itself runs slice by
slice.  Positions that are floored (ray samples, slice offsets, the warp)
are computed in XLA's order (``ops/xla_float``).
"""

from __future__ import annotations

import plistlib
import threading
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.ops.reslice import trilinear
from invesalius3_tpu_torch.ops.xla_float import fma, recip, row4


# ---------------------------------------------------------------------------
# CLUT presets
# ---------------------------------------------------------------------------


@dataclass
class RaycastPreset:
    """A raycasting preset: baked value->RGBA lookup table + params."""

    name: str = "Custom"
    lut_min: float = -1024.0
    lut_max: float = 3071.0
    rgba: np.ndarray = field(default_factory=lambda: np.zeros((256, 4), np.float32))
    use_shading: bool = False
    projection_mode: str = "composite"  # or "mip"
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    wl: float = 0.0
    ww: float = 2000.0

    @classmethod
    def from_plist(cls, path_or_bytes, lut_size: int = 2048) -> "RaycastPreset":
        """Parse a reference raycasting preset plist (advanced 16-bit CLUT
        curves or basic color/alpha node lists) and bake the LUT."""
        if isinstance(path_or_bytes, (bytes, bytearray)):
            d = plistlib.loads(bytes(path_or_bytes))
        else:
            with open(path_or_bytes, "rb") as f:
                d = plistlib.load(f)

        name = d.get("name", "Custom")
        use_shading = bool(d.get("useShading", False))
        proj = "mip" if d.get("projection", 0) in (2, "MIP") else "composite"
        bg = (
            float(d.get("backgroundColorRedComponent", 0.0)),
            float(d.get("backgroundColorGreenComponent", 0.0)),
            float(d.get("backgroundColorBlueComponent", 0.0)),
        )

        if d.get("advancedCLUT"):
            curves = d["16bitClutCurves"]
            colors = d["16bitClutColors"]
            xs = [p["x"] for curve in curves for p in curve]
            lut_min, lut_max = min(xs), max(xs)
            values = np.linspace(lut_min, lut_max, lut_size)
            rgba = np.zeros((lut_size, 4), np.float32)
            for curve, cols in zip(curves, colors):
                cx = np.array([p["x"] for p in curve])
                cy = np.array([p["y"] for p in curve])
                cr = np.array([c["red"] for c in cols])
                cg = np.array([c["green"] for c in cols])
                cb = np.array([c["blue"] for c in cols])
                inside = (values >= cx[0]) & (values <= cx[-1])
                a = np.interp(values, cx, cy)
                r = np.interp(values, cx, cr)
                g = np.interp(values, cx, cg)
                b = np.interp(values, cx, cb)
                # curves are disjoint intensity windows; outside a curve its
                # contribution is zero
                sel = inside & (a > rgba[:, 3])
                rgba[sel] = np.stack([r, g, b, a], axis=1)[sel]
        else:
            # basic preset: 'red'/'green'/'blue' + 'alpha' node dicts
            cx = [p["x"] for p in d.get("alpha", [{"x": 0, "y": 0}, {"x": 1000, "y": 1}])]
            lut_min, lut_max = min(cx), max(cx)
            values = np.linspace(lut_min, lut_max, lut_size)
            a = (np.interp(values, cx, [p["y"] for p in d["alpha"]]) if "alpha" in d
                 else np.ones(lut_size))
            rgba = np.zeros((lut_size, 4), np.float32)
            rgba[:, 3] = a
            for i, ch in enumerate(("red", "green", "blue")):
                if ch in d:
                    nx = [p["x"] for p in d[ch]]
                    ny = [p["y"] for p in d[ch]]
                    rgba[:, i] = np.interp(values, nx, ny)
                else:
                    rgba[:, i] = 1.0

        return cls(
            name=name, lut_min=lut_min, lut_max=lut_max, rgba=rgba,
            use_shading=use_shading, projection_mode=proj, background=bg,
            wl=float(d.get("wl", 0.0)), ww=float(d.get("ww", 2000.0)),
        )


# Authored preset specs covering the reference's 30-preset catalog
# (the reference's presets/raycasting/*.plist — same names, curves authored
# fresh as compact ramps).  Each: HU range, alpha ramp points, RGB stops,
# shading, projection, background.
def _spec(lo, hi, alpha, stops, shading=True, mode="composite",
          bg=(0.0, 0.0, 0.0)):
    return dict(lo=lo, hi=hi, alpha=alpha, stops=stops, shading=shading,
                mode=mode, bg=bg)


_BONE_STOPS = [(-200, (0.4, 0.3, 0.25)), (300, (0.9, 0.76, 0.65)),
               (1200, (1.0, 0.98, 0.92)), (2500, (1.0, 1.0, 1.0))]
_SKIN_STOPS = [(-500, (0.55, 0.3, 0.25)), (-100, (0.85, 0.55, 0.45)),
               (200, (0.95, 0.75, 0.65))]
_VESSEL_STOPS = [(100, (0.45, 0.0, 0.0)), (300, (0.85, 0.1, 0.1)),
                 (600, (1.0, 0.45, 0.35)), (1200, (1.0, 0.9, 0.8))]
_GRAY = [(-1024, (0.0, 0.0, 0.0)), (3071, (1.0, 1.0, 1.0))]

_PRESET_SPECS = {
    "Standard": _spec(-1024, 3071, [(-200, 0.0), (300, 0.3), (1500, 0.9)],
                      _BONE_STOPS),
    "Bone": _spec(-200, 2000, [(150, 0.0), (700, 0.9)], _BONE_STOPS),
    "Gold Bone": _spec(-100, 2500, [(200, 0.0), (800, 0.95)],
                       [(200, (0.45, 0.3, 0.05)), (1000, (0.95, 0.75, 0.2)),
                        (2500, (1.0, 0.95, 0.6))]),
    "Yellow Bone": _spec(-100, 2500, [(200, 0.0), (800, 0.95)],
                         [(200, (0.5, 0.45, 0.05)), (1000, (1.0, 0.95, 0.2)),
                          (2500, (1.0, 1.0, 0.7))]),
    "Dark Bone": _spec(100, 2500, [(300, 0.0), (1000, 0.95)],
                       [(300, (0.1, 0.09, 0.08)), (2500, (0.9, 0.85, 0.8))]),
    "Bone + Skin": _spec(-800, 2000,
                         [(-600, 0.0), (-400, 0.25), (-150, 0.0),
                          (200, 0.0), (700, 0.9)],
                         _SKIN_STOPS + [(700, (0.95, 0.92, 0.85)),
                                        (2000, (1.0, 1.0, 1.0))]),
    "Bone + Skin II": _spec(-800, 2000,
                            [(-600, 0.0), (-350, 0.45), (-100, 0.0),
                             (250, 0.0), (800, 0.95)],
                            _SKIN_STOPS + [(800, (1.0, 0.98, 0.9))]),
    "Skin On Blue": _spec(-800, 500, [(-550, 0.0), (-200, 0.6), (100, 0.9)],
                          _SKIN_STOPS, bg=(0.1, 0.2, 0.45)),
    "Skin On Blue II": _spec(-800, 500, [(-500, 0.0), (-100, 0.85)],
                             _SKIN_STOPS, bg=(0.05, 0.12, 0.35)),
    "Soft": _spec(-800, 400, [(-300, 0.0), (60, 0.45), (300, 0.7)],
                  [(-300, (0.6, 0.35, 0.3)), (40, (0.85, 0.55, 0.45)),
                   (400, (0.95, 0.8, 0.7))]),
    "Soft Tissue": _spec(-800, 400, [(-300, 0.0), (100, 0.4)],
                         [(-300, (0.85, 0.55, 0.45)),
                          (400, (0.9, 0.65, 0.55))]),
    "Soft On Blue": _spec(-800, 400, [(-300, 0.0), (100, 0.55)],
                          [(-300, (0.8, 0.55, 0.45)), (400, (0.95, 0.8, 0.7))],
                          bg=(0.1, 0.2, 0.45)),
    "Soft on White": _spec(-800, 400, [(-300, 0.0), (100, 0.55)],
                           [(-300, (0.55, 0.35, 0.3)), (400, (0.8, 0.6, 0.5))],
                           bg=(1.0, 1.0, 1.0)),
    "Soft + Skin": _spec(-800, 600,
                         [(-600, 0.0), (-350, 0.2), (-100, 0.0), (40, 0.5)],
                         _SKIN_STOPS),
    "Soft + Skin II": _spec(-800, 600,
                            [(-600, 0.0), (-300, 0.35), (-50, 0.0), (60, 0.6)],
                            _SKIN_STOPS),
    "Soft + Skin III": _spec(-800, 600,
                             [(-600, 0.0), (-250, 0.5), (0, 0.0), (80, 0.7)],
                             _SKIN_STOPS),
    "Vascular": _spec(0, 1200, [(80, 0.0), (300, 0.8)], _VESSEL_STOPS),
    "Vascular II": _spec(0, 1200, [(120, 0.0), (400, 0.9)], _VESSEL_STOPS),
    "Vascular III": _spec(50, 1500, [(150, 0.0), (500, 0.95)], _VESSEL_STOPS),
    "Vascular IV": _spec(100, 1500, [(200, 0.0), (600, 1.0)], _VESSEL_STOPS),
    "Airways": _spec(-1024, -300, [(-1024, 0.6), (-800, 0.3), (-500, 0.0)],
                     [(-1024, (0.4, 0.7, 1.0)), (-300, (0.6, 0.85, 1.0))]),
    "Airways II": _spec(-1024, -200, [(-1024, 0.8), (-700, 0.25), (-400, 0.0)],
                        [(-1024, (0.3, 0.6, 1.0)), (-200, (0.7, 0.9, 1.0))],
                        bg=(0.05, 0.05, 0.1)),
    "High Contrast": _spec(-200, 1200, [(-200, 0.0), (600, 0.2), (1200, 0.95)],
                           [(-200, (0.2, 0.12, 0.06)), (700, (1.0, 0.6, 0.3)),
                            (1200, (1.0, 0.95, 0.85))]),
    "Mid Contrast": _spec(-400, 1400, [(-400, 0.0), (400, 0.4), (1400, 0.85)],
                          _BONE_STOPS),
    "Low Contrast": _spec(-800, 2000, [(-800, 0.0), (600, 0.35), (2000, 0.7)],
                          _BONE_STOPS),
    "Glossy": _spec(-500, 1500, [(-200, 0.0), (300, 0.75)],
                    [(-200, (0.75, 0.75, 0.8)), (1500, (1.0, 1.0, 1.0))]),
    "Glossy II": _spec(-500, 1500, [(-100, 0.0), (500, 0.9)],
                       [(-100, (0.6, 0.65, 0.75)), (1500, (0.95, 0.97, 1.0))]),
    "Pencil": _spec(-600, 1200, [(-600, 0.0), (-200, 0.15), (800, 0.45)],
                    [(-600, (0.15, 0.15, 0.15)), (1200, (0.35, 0.35, 0.35))],
                    shading=False, bg=(1.0, 1.0, 1.0)),
    "Red on White": _spec(-500, 1500, [(-200, 0.0), (400, 0.7)],
                          [(-200, (0.6, 0.05, 0.05)), (1500, (1.0, 0.4, 0.3))],
                          bg=(1.0, 1.0, 1.0)),
    "Black & White": _spec(-1024, 3071, [(200, 0.0), (1400, 0.9)], _GRAY,
                           shading=False),
    "No Shading": _spec(-200, 2000, [(150, 0.0), (700, 0.9)], _BONE_STOPS,
                        shading=False),
    "MIP": _spec(-1024, 3071, [(-1024, 0.0), (3071, 1.0)], _GRAY,
                 shading=False, mode="mip"),
}


def preset_from_nodes(name, lo, hi, alpha_nodes, color_nodes,
                      shading=True, mode="composite", bg=(0.0, 0.0, 0.0),
                      lut_size: int = 2048) -> RaycastPreset:
    """Bake a preset from editable (value, alpha) and (value, rgb) node
    lists — the CLUT-editor entry point (reference
    gui/widgets/clut_raycasting.py curve model; same interpolation the
    builtin catalog uses)."""
    lo, hi = float(lo), float(hi)
    values = np.linspace(lo, hi, lut_size)
    a_pts = sorted((float(v), float(a)) for v, a in alpha_nodes)
    a = np.interp(values, [p[0] for p in a_pts], [p[1] for p in a_pts])
    rgba = np.empty((lut_size, 4), np.float32)
    rgba[:, 3] = np.clip(a, 0.0, 1.0)
    stops = sorted((float(v), tuple(rgb)) for v, rgb in color_nodes)
    xs = [p[0] for p in stops]
    for c in range(3):
        rgba[:, c] = np.interp(values, xs, [p[1][c] for p in stops])
    return RaycastPreset(name, lo, hi, rgba, use_shading=bool(shading),
                         projection_mode=mode, background=tuple(bg))


def builtin_preset(name: str = "Bone", lut_size: int = 2048) -> RaycastPreset:
    """Bake one of the authored presets (full reference catalog coverage:
    the 30 names under presets/raycasting/)."""
    spec = _PRESET_SPECS.get(name)
    if spec is None:
        raise KeyError(name)
    return preset_from_nodes(name, spec["lo"], spec["hi"], spec["alpha"],
                             spec["stops"], shading=spec["shading"],
                             mode=spec["mode"], bg=spec["bg"],
                             lut_size=lut_size)


def nodes_from_preset(p: "RaycastPreset", n_nodes: int = 16) -> dict:
    """Downsample a baked preset LUT back to an editable node view."""
    n = p.rgba.shape[0]
    values = np.linspace(p.lut_min, p.lut_max, n_nodes)
    idx = np.clip(((values - p.lut_min) / max(p.lut_max - p.lut_min, 1e-6)
                   * (n - 1)).astype(int), 0, n - 1)
    return {"name": p.name, "lo": float(p.lut_min), "hi": float(p.lut_max),
            "alpha_nodes": [[float(v), float(p.rgba[i, 3])]
                            for v, i in zip(values, idx)],
            "color_nodes": [[float(v), [float(c) for c in p.rgba[i, :3]]]
                            for v, i in zip(values, idx)],
            "shading": bool(p.use_shading), "mode": p.projection_mode}


def preset_nodes(name: str) -> dict:
    """The editable node view of a preset: builtin specs verbatim, saved
    user presets downsampled from their baked LUT (what the CLUT editor
    loads)."""
    spec = _PRESET_SPECS.get(name)
    if spec is not None:
        return {"name": name, "lo": float(spec["lo"]), "hi": float(spec["hi"]),
                "alpha_nodes": [[float(v), float(a)] for v, a in spec["alpha"]],
                "color_nodes": [[float(v), [float(c) for c in rgb]]
                                for v, rgb in spec["stops"]],
                "shading": bool(spec["shading"]), "mode": spec["mode"]}
    return nodes_from_preset(load_preset(name))


BUILTIN_PRESETS = tuple(_PRESET_SPECS)


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------


def camera_rays(
    shape: Tuple[int, int, int],
    spacing: Tuple[float, float, float],
    azimuth: float,
    elevation: float,
    image_size: int = 512,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Orthographic camera looking at the volume center from (azimuth,
    elevation) degrees.  Returns (origins (H, W, 3), direction (3,),
    up-scale, ray length) in voxel coordinates (z, y, x order)."""
    dz, dy, dx = shape
    sx, sy, sz = spacing
    center = np.array([dz * sz, dy * sy, dx * sx]) / 2.0  # world (z, y, x)
    diag = float(np.linalg.norm(center) * 2.0)

    az = np.radians(azimuth)
    el = np.radians(elevation)
    # view direction in world (z, y, x): az rotates in the (x, y) plane,
    # el tilts toward +z
    d = np.array([np.sin(el), np.cos(el) * np.cos(az), np.cos(el) * np.sin(az)])
    d = d / np.linalg.norm(d)
    # build orthonormal basis
    upw = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    right = np.cross(d, upw)
    right /= np.linalg.norm(right)
    up = np.cross(right, d)

    half = diag / 2.0
    js = np.linspace(-half, half, image_size)
    is_ = np.linspace(-half, half, image_size)
    grid_u, grid_v = np.meshgrid(is_, js, indexing="ij")
    eye = center - d * diag / 2.0
    origins = (
        eye[None, None, :]
        + grid_u[..., None] * up[None, None, :]
        + grid_v[..., None] * right[None, None, :]
    )
    # to voxel units
    scale = np.array([sz, sy, sx])
    return (origins / scale).astype(np.float32), (d / scale).astype(np.float32), diag, float(
        np.linalg.norm(d / scale)
    )


# ---------------------------------------------------------------------------
# Renderer
# ---------------------------------------------------------------------------


_STEPS_AT_ONCE = 16  # ray steps sampled in one batch (the early-out period)


def _volume_tensor(volume, device) -> torch.Tensor:
    """A tensor stays on its device; a host array goes to ``device``."""
    if isinstance(volume, torch.Tensor):
        return volume
    a = np.ascontiguousarray(np.asarray(volume))
    if not a.flags.writeable:  # never alias memory the tensor may not own
        a = a.copy()
    return torch.from_numpy(a).to(resolve_device(device))


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _host32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def raycast(
    volume: torch.Tensor,
    origins,  # (H, W, 3) voxel coords (z, y, x)
    direction,  # (3,) voxel-space step vector per unit t
    t_max: float,
    lut_rgba,  # (N, 4)
    lut_min: float,
    lut_max: float,
    n_steps: int = 256,
    mode: str = "composite",
    use_shading: bool = False,
    crop_plane=None,  # (4,) plane eq in voxel coords
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> torch.Tensor:
    """(H, W, 3) float32 image in [0, 1] on the volume's device."""
    dev = volume.device
    volume = volume.contiguous()
    org = torch.from_numpy(_host32(origins)).to(dev)
    oz, oy, ox = org[..., 0], org[..., 1], org[..., 2]
    H, W = oz.shape
    d = _host32(direction)
    dt = np.float32(t_max) * np.float32(recip(n_steps))
    step = d * dt
    lut = torch.from_numpy(_host32(lut_rgba)).to(dev)
    n_lut = lut.shape[0]
    lut_t = lut.t().contiguous()
    lmin, lmax = np.float32(lut_min), np.float32(lut_max)
    lmin_t, span_t = _f32(lmin, dev), _f32(lmax - lmin, dev)
    dzv, dyv, dxv = volume.shape
    crop = None if crop_plane is None else _host32(crop_plane)

    def lut_idx(v):
        idx = (v - lmin_t) / span_t * float(n_lut - 1)
        return idx.clamp(0, n_lut - 1).long()

    def sample(pz, py, px):
        valid = ((pz >= 0) & (pz < dzv - 1) & (py >= 0) & (py < dyv - 1)
                 & (px >= 0) & (px < dxv - 1))
        if crop is not None:
            valid = valid & (row4(crop, pz, py, px) >= 0)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        v = trilinear(volume, torch.where(valid, px, zero),
                      torch.where(valid, py, zero), torch.where(valid, pz, zero))
        return torch.where(valid, v, _f32(lmin, dev)), valid

    def ray_pos(i0, k):
        """Sample positions of steps i0 .. i0 + k - 1, (k, H, W) each."""
        t = torch.arange(i0, i0 + k, dtype=torch.float32, device=dev)[:, None, None]
        return fma(float(step[0]), t, oz), fma(float(step[1]), t, oy), fma(float(step[2]), t, ox)

    # The samples of _STEPS_AT_ONCE steps are taken in one batch (every op
    # is elementwise, so a sample's value does not depend on the batch);
    # only the front-to-back blend runs step by step.
    if mode == "mip":
        best = torch.full((H, W), float(lmin), dtype=torch.float32, device=dev)
        for i0 in range(0, n_steps, _STEPS_AT_ONCE):
            v, valid = sample(*ray_pos(i0, min(_STEPS_AT_ONCE, n_steps - i0)))
            best = torch.maximum(best, torch.where(valid, v, best).amax(0))
        idx = lut_idx(best)
        return torch.stack([lut_t[c][idx] for c in range(3)], dim=-1)

    # composite front-to-back
    dn = (d / np.linalg.norm(d)).astype(np.float32)
    cr, cg, cb, alpha = (torch.zeros((H, W), dtype=torch.float32, device=dev)
                         for _ in range(4))
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    chunk = _STEPS_AT_ONCE // 2 if use_shading else _STEPS_AT_ONCE
    for i0 in range(0, n_steps, chunk):
        # once every ray is opaque the remaining steps add nothing
        if i0 % _STEPS_AT_ONCE == 0 and i0 and bool(done.all()):
            break
        k = min(chunk, n_steps - i0)
        pz, py, px = ray_pos(i0, k)
        v, valid = sample(pz, py, px)
        idx = lut_idx(v)
        a_lut = lut_t[3][idx]
        r, g, b = lut_t[0][idx], lut_t[1][idx], lut_t[2][idx]
        if use_shading:
            # central-difference gradient diffuse shading (headlight): the
            # six neighbours (z+, z-, y+, y-, x+, x-) in one batch
            nb, _ = sample(torch.stack([pz + 1.0, pz - 1.0, pz, pz, pz, pz]),
                           torch.stack([py, py, py + 1.0, py - 1.0, py, py]),
                           torch.stack([px, px, px, px, px + 1.0, px - 1.0]))
            dz_, dy_, dx_ = nb[0] - nb[1], nb[2] - nb[3], nb[4] - nb[5]
            gn = torch.sqrt(fma(dx_, dx_, fma(dz_, dz_, dy_ * dy_)))
            gn = torch.where(gn == 0, torch.ones_like(gn), gn)
            dot = fma(dx_, float(dn[2]), fma(dz_, float(dn[0]), dy_ * float(dn[1])))
            shade = fma(0.7, dot.abs() / gn, 0.3)
            r, g, b = r * shade, g * shade, b * shade
        for j in range(k):
            w = (1.0 - alpha) * torch.where(valid[j] & ~done, a_lut[j], zero)
            cr = fma(r[j], w, cr)
            cg = fma(g[j], w, cg)
            cb = fma(b[j], w, cb)
            alpha = alpha + w
            done = done | (alpha >= 0.99)
    bg = np.asarray(background, np.float32)
    rem = 1.0 - alpha
    return torch.stack([fma(rem, float(bg[0]), cr), fma(rem, float(bg[1]), cg),
                        fma(rem, float(bg[2]), cb)], dim=-1)


def _to_u8(img: torch.Tensor) -> torch.Tensor:
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def render(
    volume,
    spacing=(1.0, 1.0, 1.0),
    preset: Optional[RaycastPreset] = None,
    azimuth: float = 0.0,
    elevation: float = 0.0,
    image_size: int = 512,
    n_steps: int = 256,
    crop_plane=None,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """Render a volume to (H, W, 3) uint8 with the gather raycaster.  A
    tensor renders on its device, a host array on ``device``."""
    preset = preset or builtin_preset("Bone")
    vol = _volume_tensor(volume, device)
    origins, direction, diag, dirlen = camera_rays(
        tuple(vol.shape), spacing, azimuth, elevation, image_size)
    img = raycast(
        vol, origins, direction, float(diag), preset.rgba, preset.lut_min,
        preset.lut_max, n_steps=n_steps, mode=preset.projection_mode,
        use_shading=preset.use_shading, crop_plane=crop_plane,
        background=preset.background)
    return _to_u8(img).cpu().numpy()


def render_mask_preview(
    mask,
    spacing=(1.0, 1.0, 1.0),
    colour=(0.33, 1.0, 0.33),
    azimuth: float = 0.0,
    elevation: float = 0.0,
    image_size: int = 256,
    n_steps: int = 128,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """3D preview of a mask during editing (reference
    invesalius/data/volume_mask.py: GPU raycast of the mask with its
    colour): a shear-warp render with a two-node LUT over the 0/255 mask
    values (``n_steps`` is unused, as in the JAX package)."""
    lut = np.zeros((256, 4), np.float32)
    lut[127:, 0] = colour[0]
    lut[127:, 1] = colour[1]
    lut[127:, 2] = colour[2]
    lut[127:, 3] = 0.9
    preset = RaycastPreset(
        name="MaskPreview", lut_min=0.0, lut_max=255.0, rgba=lut,
        use_shading=True)
    return shear_warp_render(mask, spacing, preset, azimuth=azimuth,
                             elevation=elevation, image_size=image_size,
                             device=device)


# ---------------------------------------------------------------------------
# Shear-warp renderer (Lacroute & Levoy '94)
# ---------------------------------------------------------------------------
#
# Permute so the principal viewing axis is the slice axis, shear each slice
# by a per-slice offset so rays become vertical, composite slice over slice
# front to back, then warp the intermediate image to the screen with one
# 2-D resample.  The volume is read once per frame and never gathered.


def _axis_permutation(direction):
    """(perm, flip, d_permuted): principal axis to the front, slices
    ordered front-to-back."""
    d = np.asarray(direction, np.float64)
    k = int(np.argmax(np.abs(d)))
    perm = (k,) + tuple(i for i in range(3) if i != k)
    dp = d[list(perm)]
    flip = dp[0] < 0
    if flip:
        dp = -dp  # slice order reversed => ray direction negated
    return perm, flip, dp


def _pwl_eval_multi(v, xs, y0, dm, lut_min, lut_max, channels):
    """Piecewise-linear colour map channels in relu form, elementwise:
    y(v) = y0 + sum_k dm_k * relu(clip(v) - x_k), the knots in order and
    the relu terms shared across channels.  ``xs`` (M,), ``y0`` (4,) and
    ``dm`` (4, M) are host float32 arrays; knots whose slope change is 0 in
    every channel add exactly 0 and are skipped."""
    vc = v.clamp(float(lut_min), float(lut_max))
    live = [k for k in range(len(xs)) if np.any(dm[:, k] != 0)]
    terms = [torch.clamp_min(vc - float(xs[k]), 0.0) for k in live]
    out = []
    for ch in channels:
        y = torch.full_like(v, float(y0[ch]))
        for t, k in zip(terms, live):
            y = y + float(dm[ch, k]) * t
        out.append(y)
    return out


def _shifted(sl: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Resample (B, U, V) slices onto the integer accumulator grid:
    out[i, j] = bilinear(sl, i - fu, j - fv), sized (B, U + 1, V + 1);
    ``w`` (4, B, 1, 1) holds the weights (w00, w10, w01, w11)."""
    p = F.pad(sl, (1, 1, 1, 1))
    return (p[:, 1:, 1:] * w[0] + p[:, :-1, 1:] * w[1]
            + p[:, 1:, :-1] * w[2] + p[:, :-1, :-1] * w[3])


def _edge_diffs(s: torch.Tensor):
    """Central differences of (B, U, V) slices along U and V with edge
    padding."""
    p = F.pad(s[None], (1, 1, 1, 1), mode="replicate")[0]
    return p[:, 2:, 1:-1] - p[:, :-2, 1:-1], p[:, 1:-1, 2:] - p[:, 1:-1, :-2]


def _slice_offsets(shear, base, P: int):
    """Per slice p: (iu, iv) window starts and (fu, fv) fractions, as the
    JAX package computes them on the device in float32
    (su = base + shear * p, one FMA)."""
    p = np.arange(P, dtype=np.float32).astype(np.float64)
    sh = np.asarray(shear, np.float32).astype(np.float64)
    bs = np.asarray(base, np.float32).astype(np.float64)
    su = (sh[0] * p + bs[0]).astype(np.float32)
    sv = (sh[1] * p + bs[1]).astype(np.float32)
    iu, iv = np.floor(su), np.floor(sv)
    return iu.astype(np.int64), iv.astype(np.int64), su - iu, sv - iv


_COLOUR_SLICES = 16  # permuted slices whose colour is computed in one batch


def _shear_composite(vol_p, shear, base, xs, y0, dm, lut_min, lut_max,
                     alpha_q, mode: str, dims, use_shading: bool = False,
                     dn=None):
    """Composite the permuted slices into the (4, AU, AV) accumulator
    (premultiplied rgb + alpha planes), or the (1, AU, AV) running max for
    mode="mip".

    vol_p: (P, U, V) permuted volume; shear: (2,) per-slice (du, dv);
    base: (2,) offset of slice 0 in the accumulator; alpha_q: opacity
    correction exponent (path length through one slice / slice spacing);
    (xs, y0, dm): relu-form CLUT knots from _preset_knots.  The colour of
    ``_COLOUR_SLICES`` slices is computed at once; the composite runs slice
    by slice.
    """
    P, U, V = vol_p.shape
    AU, AV = dims
    dev = vol_p.device
    iu, iv, fu, fv = _slice_offsets(shear, base, P)
    # lax.dynamic_slice clamps a window that would run past the edge
    iu = np.clip(iu, 0, AU - (U + 1))
    iv = np.clip(iv, 0, AV - (V + 1))
    one = np.float32(1.0)
    weights = np.stack([(one - fu) * (one - fv), fu * (one - fv),
                        (one - fu) * fv, fu * fv]).astype(np.float32)
    wdev = torch.from_numpy(weights).to(dev)[:, :, None, None]  # (4, P, 1, 1)
    if mode == "mip":
        acc = torch.full((1, AU, AV), float(np.float32(lut_min)),
                         dtype=torch.float32, device=dev)
    else:
        acc = torch.zeros((4, AU, AV), dtype=torch.float32, device=dev)
        aq = float(np.float32(alpha_q))
    for p0 in range(0, P, _COLOUR_SLICES):
        p1 = min(P, p0 + _COLOUR_SLICES)
        w = wdev[:, p0:p1]
        sl = vol_p[p0:p1].float()
        ss = _shifted(sl, w)  # (B, U + 1, V + 1)
        if mode == "mip":
            for j in range(p1 - p0):
                win = acc[0, iu[p0 + j]:iu[p0 + j] + U + 1, iv[p0 + j]:iv[p0 + j] + V + 1]
                win.clamp_(min=ss[j])
            continue
        r, g, b, a = _pwl_eval_multi(ss, xs, y0, dm, lut_min, lut_max, (0, 1, 2, 3))
        a = 1.0 - torch.pow(torch.clamp_min(1.0 - a, 0.0), aq)
        if use_shading:
            # central-difference gradient: along the slice axis from the
            # p-1 and p+1 slices (clamped), in-plane from edge-padded shifts
            ps = torch.arange(p0, p1, device=dev)
            lo = vol_p.index_select(0, (ps - 1).clamp_min(0)).float()
            hi = vol_p.index_select(0, (ps + 1).clamp_max(P - 1)).float()
            du, dv = _edge_diffs(sl)
            gp, gu, gv = _shifted(hi - lo, w), _shifted(du, w), _shifted(dv, w)
            gn = torch.sqrt(gp * gp + gu * gu + gv * gv)
            gn = torch.where(gn == 0, torch.ones_like(gn), gn)
            diffuse = (gp * float(dn[0]) + gu * float(dn[1]) + gv * float(dn[2])).abs() / gn
            shade = 0.3 + 0.7 * diffuse
            r, g, b = r * shade, g * shade, b * shade
        rgb1 = torch.stack([r, g, b, torch.ones_like(a)], dim=1)  # (B, 4, U+1, V+1)
        for j in range(p1 - p0):
            p = p0 + j
            win = acc[:, iu[p]:iu[p] + U + 1, iv[p]:iv[p] + V + 1]
            wj = (1.0 - win[3]) * a[j]
            win.addcmul_(rgb1[j], wj)
    return acc


def _warp_sample(acc: torch.Tensor, coords_u, coords_v) -> torch.Tensor:
    """Bilinear samples of the (C, AU, AV) accumulator at screen-ray base
    coordinates (H, W), zero outside; (C, H, W)."""
    AU, AV = acc.shape[1:]
    u0 = torch.floor(coords_u)
    v0 = torch.floor(coords_v)
    fu = coords_u - u0
    fv = coords_v - v0
    valid = ((coords_u >= 0) & (coords_u < AU - 1)
             & (coords_v >= 0) & (coords_v < AV - 1))
    u0 = u0.long().clamp(0, AU - 2)
    v0 = v0.long().clamp(0, AV - 2)
    flat = acc.reshape(acc.shape[0], -1)
    zero = torch.zeros((), dtype=torch.float32, device=acc.device)
    out = []
    for ch in flat:
        def g(du, dv):
            return ch[(u0 + du) * AV + (v0 + dv)]
        val = (g(0, 0) * (1 - fu) * (1 - fv) + g(1, 0) * fu * (1 - fv)
               + g(0, 1) * (1 - fu) * fv + g(1, 1) * fu * fv)
        out.append(torch.where(valid, val, zero))
    return torch.stack(out)


def _frame_epilogue(acc, affine, xs, y0, dm, lut_min, lut_max, bg,
                    mode: str, out_shape) -> torch.Tensor:
    """Warp -> colormap -> (H, W, 3) uint8 frame.  ``affine`` holds
    (cu00, dcu_i, dcu_j, cv00, dcv_i, dcv_j): for an orthographic camera
    the screen -> base-plane coordinates are affine in the pixel indices."""
    H, W = out_shape
    dev = acc.device
    ii = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    jj = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    af = [float(v) for v in np.asarray(affine, np.float32)]
    cu = fma(af[2], jj, fma(af[1], ii, af[0]))
    cv = fma(af[5], jj, fma(af[4], ii, af[3]))
    img = _warp_sample(acc, cu, cv)
    if mode == "mip":
        rgb = torch.stack(_pwl_eval_multi(img[0], xs, y0, dm, lut_min, lut_max,
                                          (0, 1, 2)), dim=-1)
    else:
        rem = 1.0 - img[3]
        bgf = np.asarray(bg, np.float32)
        rgb = torch.stack([fma(rem, float(bgf[c]), img[c]) for c in range(3)], dim=-1)
    return _to_u8(rgb)


def _preset_knots(preset, max_knots: int = 64):
    """Relu-form knot decomposition of the preset's baked (N, 4) LUT,
    cached on the preset object.

    Builtin/user presets are baked with np.interp over a handful of spec
    nodes, so the LUT is exactly piecewise linear — second differences of
    the sampled values recover every slope break.  Returns host float32
    arrays (xs (M,), y0 (4,), dm (4, M)) such that each channel is
    y(v) = y0 + sum_k dm_k * relu(clip(v, lut_min, lut_max) - xs[k]).
    M is padded to a multiple of 8 (dm=0, xs=lut_max), as in the JAX
    package.  Dense LUTs (> max_knots breaks) are resampled to max_knots
    uniform segments."""
    hit = getattr(preset, "_knots", None)
    if hit is not None:
        return hit
    rgba = np.asarray(preset.rgba, np.float32)
    n = rgba.shape[0]
    lo, hi = float(preset.lut_min), float(preset.lut_max)
    dv = (hi - lo) / (n - 1)
    slopes = np.diff(rgba, axis=0) / dv  # (n-1, 4) per-value-unit slopes
    d2 = np.abs(np.diff(slopes, axis=0)).max(axis=1)  # (n-2,)
    tol = max(1e-9, float(np.abs(slopes).max()) * 1e-3)
    idx = np.nonzero(d2 > tol)[0] + 1  # LUT index of each slope break
    if len(idx) + 1 <= max_knots:
        kx = lo + np.concatenate([[0], idx]) * dv  # (M,)
        sl = slopes[np.concatenate([[0], idx])]    # slope after each knot
        y0 = rgba[0]
    else:
        px = np.linspace(0, n - 1, max_knots + 1)
        ys = np.stack([np.interp(px, np.arange(n), rgba[:, c])
                       for c in range(4)], axis=1)
        kx = lo + px[:-1] * dv
        sl = np.diff(ys, axis=0) / ((px[1] - px[0]) * dv)
        y0 = ys[0]
    m = len(kx)
    mp = -(-m // 8) * 8
    xs = np.full(mp, hi, np.float32)
    xs[:m] = kx
    dmk = np.zeros((4, mp), np.float32)
    dmk[:, 0] = sl[0]
    dmk[:, 1:m] = (sl[1:] - sl[:-1]).T
    hit = (xs, y0.astype(np.float32), dmk)
    preset._knots = hit
    return hit


def _pool2(vol: torch.Tensor, mode: str) -> torch.Tensor:
    """2x2x2 pooling with SAME padding at the high ends (``reduce_window``):
    max padded with -2^15 in the volume's dtype for "mip", else the float32
    sum padded with 0 and divided by 8 (a padded window too)."""
    pads = [s % 2 for s in vol.shape]
    if mode == "mip":
        v = vol
        # -2^15 in the volume's dtype: wrapped to 0 by 8-bit types
        fill = -(2 ** 15) if (vol.dtype.is_floating_point
                              or torch.iinfo(vol.dtype).min <= -(2 ** 15)) else 0
    else:
        v = vol.float()
        fill = 0.0
    if any(pads):
        v = F.pad(v, (0, pads[2], 0, pads[1], 0, pads[0]), value=fill)
    Z, Y, X = (s // 2 for s in v.shape)
    r = v.reshape(Z, 2, Y, 2, X, 2)
    if mode == "mip":
        return r.amax(dim=(1, 3, 5))
    return r.sum(dim=(1, 3, 5)) * 0.125


def _ready(t: torch.Tensor) -> torch.Tensor:
    """Wait until the work that made ``t`` on its stream has run (a cache
    entry built on one thread is read by others)."""
    if t.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        ev.synchronize()
    return t


# permuted/pooled volume cache: per camera octant the permute (and the
# optional 2x pooling) of the volume is the frame's largest copy; orbiting
# a volume reuses the same few entries (reference keeps the VTK mapper's
# resampled volume alive the same way)
_VOLP_CACHE: dict = {}
_VOLP_LOCK = threading.Lock()
_VOLP_INFLIGHT: dict = {}   # key -> threading.Event set when the build lands
_FULLRES_KEEP = 3           # full-resolution permutes kept (a 512^3 int16
                            # copy is 256 MiB), apart from the global cap


def _permuted_volume(volume, perm, flip, downsample, mode, chunked=False,
                     device=DEFAULT_DEVICE):
    # keyed by the id of the CALLER's object, with a strong reference kept
    # in the value: without it a freed volume's id can be reused by a new
    # one and the cache would return the wrong volume's data.  Locked: a
    # warm thread inserts while frames render.  Concurrent misses on the
    # SAME key dedup through _VOLP_INFLIGHT: one thread builds, the rest
    # wait on its event.
    key = (id(volume), perm, bool(flip), int(downsample), mode)
    while True:
        with _VOLP_LOCK:
            hit = _VOLP_CACHE.get(key)
            if hit is not None:
                _VOLP_CACHE[key] = _VOLP_CACHE.pop(key)  # LRU touch
                return hit[1]
            ev = _VOLP_INFLIGHT.get(key)
            if ev is None:
                ev = threading.Event()
                _VOLP_INFLIGHT[key] = ev
                break
        # builder failed -> event set with no cache entry; loop retries
        # (this thread then becomes the builder)
        ev.wait(300)
    try:
        vol = _volume_tensor(volume, device)
        if downsample > 1:
            vol = _pool2(vol, mode)
        if chunked and vol.shape[perm[0]] >= 256:
            # background warm: build in slabs, each finished before the
            # next, so frames rendered meanwhile interleave with it; the
            # flip folds into the slab order
            P0 = vol.shape[perm[0]]
            step = max(32, -(-P0 // 8))
            parts = []
            for s in range(0, P0, step):
                part = vol.narrow(perm[0], s, min(step, P0 - s)).permute(perm)
                if flip:
                    part = part.flip(0)
                parts.append(_ready(part.contiguous()))
            if flip:
                parts.reverse()
            vol_p = torch.cat(parts, dim=0)
        else:
            vol_p = vol.permute(perm)
            if flip:
                vol_p = vol_p.flip(0)
            vol_p = vol_p.contiguous()
        vol_p = _ready(vol_p)
        with _VOLP_LOCK:
            full = [k for k in _VOLP_CACHE if k[3] == 1]
            while len(full) >= _FULLRES_KEEP and downsample == 1:
                _VOLP_CACHE.pop(full.pop(0))
            while len(_VOLP_CACHE) > 20:
                _VOLP_CACHE.pop(next(iter(_VOLP_CACHE)))
            _VOLP_CACHE[key] = (volume, vol_p)
    finally:
        with _VOLP_LOCK:
            _VOLP_INFLIGHT.pop(key, None)
        ev.set()
    return vol_p


def _warm_fullres_octant(volume, perm, flip, mode, device=DEFAULT_DEVICE):
    """Build the current octant's full-resolution permute on a background
    thread while pooled (interactive) frames stream, so the full-quality
    frame after the camera stops finds it cached.  No-op when the entry
    exists or its build is in flight."""
    key = (id(volume), perm, bool(flip), 1, mode)
    with _VOLP_LOCK:
        if key in _VOLP_CACHE or key in _VOLP_INFLIGHT:
            return

    def build():
        dev = volume.device if isinstance(volume, torch.Tensor) else resolve_device(device)
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                _permuted_volume(volume, perm, flip, 1, mode, chunked=True, device=dev)
        else:
            _permuted_volume(volume, perm, flip, 1, mode, chunked=True, device=dev)

    threading.Thread(target=build, daemon=True, name="shear-fullres-warm").start()


def drop_shear_cache(volume) -> None:
    """Evict every cache entry built from ``volume`` (call when the matrix
    is replaced: crop, reorient, import), so the old volume's device
    copies are freed."""
    with _VOLP_LOCK:
        for key in [k for k, v in _VOLP_CACHE.items() if v[0] is volume]:
            _VOLP_CACHE.pop(key, None)


def warm_shear_cache(volume, mode: str = "composite", downsample: int = 2,
                     device=DEFAULT_DEVICE):
    """Pre-permute/pool the interactive (downsample >= 2) volume for every
    camera octant (3 principal axes x front/back), so the first pooled
    frame at any angle finds its entry.  Full-resolution permutes are not
    warmed here: they are warmed per octant while pooled frames stream
    (``_warm_fullres_octant``), at most ``_FULLRES_KEEP`` of them."""
    for k in range(3):
        perm = (k,) + tuple(i for i in range(3) if i != k)
        for flip in (False, True):
            _permuted_volume(volume, perm, flip, max(2, downsample), mode,
                             device=device)


def shear_warp_render(
    volume,
    spacing=(1.0, 1.0, 1.0),
    preset: Optional[RaycastPreset] = None,
    azimuth: float = 0.0,
    elevation: float = 0.0,
    image_size: int = 512,
    downsample: int = 1,
    fetch: bool = True,
    device=DEFAULT_DEVICE,
):
    """Interactive-quality volume rendering via shear-warp; same camera
    model as ``render``.  Returns (H, W, 3) uint8 (a numpy array, or with
    ``fetch=False`` the tensor on the volume's device).  A tensor renders
    on its device, a host array on ``device``.

    ``downsample=2`` composites a 2x-pooled copy of the volume (mean for
    composite, max for MIP) — 8x less slice work for interactive orbiting;
    the warp resamples to the requested image size either way."""
    preset = preset or builtin_preset("Bone")
    full_shape = tuple(int(s) for s in volume.shape)
    if not isinstance(volume, torch.Tensor):
        resolve_device(device)
    origins, direction, diag, _ = camera_rays(
        full_shape, spacing, azimuth, elevation, image_size)

    perm, flip, dp = _axis_permutation(direction)
    mode0 = "mip" if preset.projection_mode == "mip" else "composite"
    if downsample > 1 and min(full_shape) >= 128:
        # interactive frame: warm this octant's full-res permute in the
        # background so the full-quality frame finds it cached
        _warm_fullres_octant(volume, perm, flip, mode0, device=device)
    vol_p = _permuted_volume(volume, perm, flip, downsample, mode0, device=device)
    if downsample > 1:
        # ray origins are in full-res voxel coordinates; halve them
        origins = origins / float(downsample)
    P, U, V = (int(s) for s in vol_p.shape)

    # shear per slice makes rays vertical: a ray advances (dp1/dp0,
    # dp2/dp0) in (u, v) per slice, so slices shift by the negative
    shear = np.array([-dp[1] / dp[0], -dp[2] / dp[0]])
    AU, AV = U + P + 2, V + P + 2
    base = np.array([
        1.0 + (abs(shear[0]) * P if shear[0] < 0 else 0.0),
        1.0 + (abs(shear[1]) * P if shear[1] < 0 else 0.0),
    ])
    # opacity correction: path length per (possibly pooled) slice
    alpha_q = float(np.sqrt(dp[0] ** 2 + dp[1] ** 2 + dp[2] ** 2) / dp[0]
                    ) * downsample

    mode = preset.projection_mode if preset.projection_mode == "mip" else "composite"
    dn_p = (dp / np.linalg.norm(dp)).astype(np.float32)
    xs, y0, dm = _preset_knots(preset)
    lut_min, lut_max = np.float32(preset.lut_min), np.float32(preset.lut_max)

    # screen -> base-plane coordinates: ray (o + t d) crosses the slice-0
    # plane of the permuted/flipped frame at t0 = (p0 - o_p) / d_p
    o = np.transpose(origins[..., list(perm)], (2, 0, 1))  # (3 perm, H, W)
    d = np.asarray(direction, np.float64)[list(perm)]
    if flip:
        # slice index p' = (P - 1) - p; direction/origin mirror in p
        o = np.stack([(P - 1) - o[0], o[1], o[2]])
        d = np.array([-d[0], d[1], d[2]])
    t0 = (0.0 - o[0]) / d[0]
    cu = o[1] + t0 * d[1] + base[0] + 0.0
    cv = o[2] + t0 * d[2] + base[1] + 0.0
    # cu/cv are affine in the pixel indices (orthographic camera)
    H, W = cu.shape
    affine = np.array([
        cu[0, 0], (cu[-1, 0] - cu[0, 0]) / max(H - 1, 1),
        (cu[0, -1] - cu[0, 0]) / max(W - 1, 1),
        cv[0, 0], (cv[-1, 0] - cv[0, 0]) / max(H - 1, 1),
        (cv[0, -1] - cv[0, 0]) / max(W - 1, 1),
    ], np.float32)
    acc = _shear_composite(
        vol_p, shear.astype(np.float32), base.astype(np.float32), xs, y0, dm,
        lut_min, lut_max, np.float32(alpha_q), mode, (AU, AV),
        use_shading=bool(preset.use_shading), dn=dn_p)
    img8 = _frame_epilogue(acc, affine, xs, y0, dm, lut_min, lut_max,
                           np.asarray(preset.background, np.float32), mode, (H, W))
    return img8.cpu().numpy() if fetch else img8


# ---------------------------------------------------------------------------
# User preset persistence (reference control.py:1422-1450 Load/SaveRaycastingPreset)
# ---------------------------------------------------------------------------


def preset_to_plist(preset: RaycastPreset, n_nodes: int = 64) -> bytes:
    """Serialize a preset as a reference-compatible advanced-CLUT plist
    (one 16-bit curve sampled from the baked LUT); round-trips through
    RaycastPreset.from_plist."""
    n = preset.rgba.shape[0]
    pos = np.linspace(0, n - 1, n_nodes).astype(int)
    xs = np.linspace(preset.lut_min, preset.lut_max, n)[pos]
    curve = [{"x": float(x), "y": float(preset.rgba[i, 3])}
             for x, i in zip(xs, pos)]
    colors = [{"red": float(preset.rgba[i, 0]),
               "green": float(preset.rgba[i, 1]),
               "blue": float(preset.rgba[i, 2])} for i in pos]
    d = {
        "name": preset.name,
        "advancedCLUT": True,
        "16bitClutCurves": [curve],
        "16bitClutColors": [colors],
        "useShading": bool(preset.use_shading),
        "projection": 2 if preset.projection_mode == "mip" else 0,
        "backgroundColorRedComponent": float(preset.background[0]),
        "backgroundColorGreenComponent": float(preset.background[1]),
        "backgroundColorBlueComponent": float(preset.background[2]),
        "wl": float(preset.wl),
        "ww": float(preset.ww),
    }
    return plistlib.dumps(d)


def _user_preset_dir():
    from invesalius3_tpu_torch.utils import paths

    return paths.user_presets_dir() / "raycasting"


def save_user_preset(preset: RaycastPreset, name: Optional[str] = None):
    """Persist a (possibly edited) preset under the user config dir
    (reference SaveRaycastingPreset -> USER_RAYCASTING_PRESETS_DIRECTORY)."""
    import dataclasses as _dc

    name = name or preset.name
    preset = _dc.replace(preset, name=name)
    d = _user_preset_dir()
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{name}.plist"
    path.write_bytes(preset_to_plist(preset))
    return path


def load_preset(name: str, lut_size: int = 2048) -> RaycastPreset:
    """Builtin catalog first, then the user preset dir (reference
    LoadRaycastingPreset lookup order)."""
    if name in _PRESET_SPECS:
        return builtin_preset(name, lut_size)
    path = _user_preset_dir() / f"{name}.plist"
    if path.exists():
        return RaycastPreset.from_plist(path, lut_size)
    raise KeyError(f"no raycasting preset {name!r}")


def available_presets():
    """Builtin + saved user preset names."""
    names = list(_PRESET_SPECS)
    d = _user_preset_dir()
    if d.is_dir():
        names += sorted(p.stem for p in d.glob("*.plist")
                        if p.stem not in _PRESET_SPECS)
    return names

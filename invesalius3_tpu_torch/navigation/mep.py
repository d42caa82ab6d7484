"""MEP (motor evoked potential) motor mapping as data (port of
invesalius3_tpu/navigation/mep.py).

Reference: invesalius/data/visualization/mep_visualizer.py — markers carry
MEP amplitudes (µV); a gaussian point-interpolation kernel
(vtkGaussianKernel inside vtkPointInterpolator, :155 InterpolateData)
spreads them over the (decimated) brain surface, and a 4-anchor color
transfer function over ``colormap_range_uv`` colors the vertices
(:192 _CustomColormap).  Config defaults mirror
constants.py:1076 DEFAULT_MEP_CONFIG_PARAMS.

The GUI actor plumbing is dropped; the data products are the per-vertex
interpolated amplitude field (a dense (V, N) weight matrix on the device;
N markers is small) and its RGB mapping (numpy).  Any frontend can consume
them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device

CORTEX_COLOR = (190 / 255.0, 190 / 255.0, 190 / 255.0)

DEFAULT_MEP_CONFIG = {
    "mep_enabled": False,
    "threshold_down": 0,
    "range_up": 1,
    "mep_colormap": "Viridis",
    "gaussian_sharpness": 1.0,
    "gaussian_radius": 3.0,
    "dimensions_size": 80,
    "colormap_range_uv": {"min": 50, "low": 200, "mid": 600, "max": 1000},
}

MEP_COLORMAPS: Dict[str, Dict[str, Tuple[float, float, float]]] = {
    "BlueCyanYellowRed": {
        "min": (0.0, 0.0, 1.0), "low": (0.0, 1.0, 1.0),
        "mid": (1.0, 1.0, 0.0), "max": (1.0, 0.0, 0.0)},
    "GreenYellowOrangeRed": {
        "min": (0.0, 1.0, 0.0), "low": (1.0, 1.0, 0.0),
        "mid": (1.0, 0.647, 0.0), "max": (1.0, 0.0, 0.0)},
    "PurpleBlueGreenYellow": {
        "min": (0.5, 0.0, 0.5), "low": (0.0, 0.0, 1.0),
        "mid": (0.0, 1.0, 0.0), "max": (1.0, 1.0, 0.0)},
    "BlackGrayWhiteRed": {
        "min": (0.0, 0.0, 0.0), "low": (0.5, 0.5, 0.5),
        "mid": (1.0, 1.0, 1.0), "max": (1.0, 0.0, 0.0)},
    "Viridis": {
        "min": (0.267, 0.005, 0.329), "low": (0.229, 0.322, 0.545),
        "mid": (0.369, 0.788, 0.382), "max": (0.993, 0.906, 0.144)},
}


def _gaussian_interpolate(verts3v: torch.Tensor, points3n: torch.Tensor,
                          values: torch.Tensor, sharpness: float, radius: float
                          ) -> torch.Tensor:
    """vtkGaussianKernel semantics: w_i = exp(-(sharpness * r / radius)^2)
    within ``radius``, value = sum(w v) / sum(w); vertices with no point in
    range get 0.  verts3v (3, V), points3n (3, N): one dense (V, N) weight
    matrix on their device."""
    dev = verts3v.device
    sharp = torch.tensor(sharpness, dtype=torch.float32, device=dev)
    rad = torch.tensor(radius, dtype=torch.float32, device=dev)
    d2 = sum((verts3v[c][:, None] - points3n[c][None, :]) ** 2 for c in range(3))  # (V, N)
    w = torch.exp(-(sharp * sharp) * d2 / (rad * rad))
    w = torch.where(d2 <= rad * rad, w, 0.0)
    wsum = torch.sum(w, dim=1)
    vals = torch.sum(w * values[None, :], dim=1) / torch.clamp(wsum, min=1e-12)
    return torch.where(wsum > 0, vals, 0.0)


def interpolate_mep_surface(verts: np.ndarray, marker_positions: np.ndarray,
                            mep_values: np.ndarray, config: Optional[dict] = None,
                            device=DEFAULT_DEVICE) -> np.ndarray:
    """Per-vertex MEP amplitude field (uV) over a surface, computed on
    ``device`` (the card unless the caller passes "cpu")."""
    cfg = dict(DEFAULT_MEP_CONFIG, **(config or {}))
    dev = resolve_device(device)
    v3, p3 = (as_tensor(np.asarray(a, np.float32).T, dev)
              for a in (verts, marker_positions))
    vals = as_tensor(mep_values, dev, torch.float32)
    out = _gaussian_interpolate(v3, p3, vals, float(cfg["gaussian_sharpness"]),
                                float(cfg["gaussian_radius"]))
    return out.cpu().numpy()


def mep_colors(values: np.ndarray, config: Optional[dict] = None) -> np.ndarray:
    """(V, 3) RGB: piecewise-linear through the 4 colormap anchors at the
    configured µV breakpoints; 0/no-data renders the cortex color
    (reference _CustomColormap adds RGBPoint(0, CORTEX_COLOR))."""
    cfg = dict(DEFAULT_MEP_CONFIG, **(config or {}))
    cmap = MEP_COLORMAPS[cfg["mep_colormap"]]
    rng = cfg["colormap_range_uv"]
    xs = [0.0] + [float(rng[k]) for k in ("min", "low", "mid", "max")]
    anchors = [CORTEX_COLOR] + [cmap[k] for k in ("min", "low", "mid", "max")]
    v = np.asarray(values, np.float32)
    out = np.empty(v.shape + (3,), np.float32)
    for c in range(3):
        out[..., c] = np.interp(v, xs, [a[c] for a in anchors])
    return out


@dataclasses.dataclass
class MEPMapper:
    """Session-configured motor mapping (reference MEPVisualizer state:
    config persisted under 'mep_configuration')."""

    config: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_MEP_CONFIG))

    @classmethod
    def from_session(cls, session) -> "MEPMapper":
        cfg = session.get_config("mep_configuration") or {}
        return cls(config=dict(DEFAULT_MEP_CONFIG, **cfg))

    def save_to_session(self, session) -> None:
        session.set_config("mep_configuration", self.config)

    def map_markers(self, surface_verts: np.ndarray, markers, device=DEFAULT_DEVICE) -> dict:
        """markers: iterable with .position and .mep_value (µV; markers
        without a value are skipped).  Returns {values, colors}."""
        pos, vals = [], []
        for m in markers:
            v = getattr(m, "mep_value", None)
            if v is not None:
                pos.append(np.asarray(m.position, float))
                vals.append(float(v))
        if not pos:
            values = np.zeros(len(surface_verts), np.float32)
        else:
            values = interpolate_mep_surface(
                surface_verts, np.asarray(pos), np.asarray(vals), self.config, device)
        return {"values": values, "colors": mep_colors(values, self.config)}

"""Surface entity and the mask -> mesh creation pipeline (port of
invesalius3_tpu/core/surface.py).

Reference: invesalius/data/surface.py ``Surface`` :93 and
``SurfaceManager.AddNewActor`` :1259 (contour -> optional ca_smoothing ->
decimate -> keep-largest -> fill-holes -> mass properties,
surface_process.py:71-415).

A ``Surface`` holds host (V, 3) float32 vertices and (F, 3) int32 faces.
``create_surface_from_mask`` keeps the mesh on the mask's device from
marching through smoothing, brings it to the host once
(``marching.mesh_to_host``, vertices rounded through float16 as the JAX
package does), runs the host post steps (QEM decimation, keep-largest), and
takes volume and area on the device.  The port's marching mesh has no
padding orphan vertex, so its vertex ids are the JAX package's minus one
wherever the JAX mesh padded (``convert.surface_from_jax``).
"""

from __future__ import annotations

import dataclasses
import plistlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.ops import marching, mesh as mesh_ops


@dataclass
class Surface:
    """A triangle mesh + display/measure properties."""

    vertices: np.ndarray
    faces: np.ndarray
    index: int = -1
    name: str = ""
    colour: Tuple[float, float, float] = (1.0, 0.78, 0.65)
    transparency: float = 0.0
    volume: float = 0.0
    area: float = 0.0
    is_shown: bool = True
    category: str = "General"

    _counter = [-1]  # process-wide: decides a new surface's index and name

    def __post_init__(self):
        if self.index < 0:
            Surface._counter[0] += 1
            self.index = Surface._counter[0]
        if not self.name:
            self.name = f"Surface {self.index + 1}"

    def compute_properties(self, device=DEFAULT_DEVICE) -> None:
        """Volume and area by ``mesh_ops.mass_properties`` on ``device``
        (the card unless "cpu")."""
        dev = resolve_device(device)
        vol, area = mesh_ops.mass_properties(
            torch.from_numpy(np.ascontiguousarray(self.vertices, np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(self.faces)).to(dev))
        self.volume = float(vol)
        self.area = float(area)

    def export(self, path, **kw) -> None:
        from invesalius3_tpu_torch.io import mesh_io

        mesh_io.export_surface(path, self.vertices, self.faces, **kw)

    def save_plist(self, vtp_name: str) -> bytes:
        # the reference's key set (surface.py:136-146 SavePlist): "polydata"
        # names the .vtp member
        return plistlib.dumps(
            {
                "colour": list(self.colour),
                "index": self.index,
                "name": self.name,
                "polydata": vtp_name,
                "transparency": self.transparency,
                "visible": self.is_shown,
                "volume": self.volume,
                "area": self.area,
                "category": self.category,
            }
        )

    @classmethod
    def load_plist(cls, plist_bytes: bytes, verts: np.ndarray, faces: np.ndarray) -> "Surface":
        info = plistlib.loads(plist_bytes)
        s = cls(vertices=verts, faces=faces, index=info["index"], name=info["name"])
        s.colour = tuple(info["colour"])
        s.transparency = info.get("transparency", 0.0)
        s.is_shown = info.get("visible", True)
        s.volume = info.get("volume", 0.0)
        s.area = info.get("area", 0.0)
        s.category = info.get("category", "General")
        return s


def import_surface_file(path, fill_holes_size: float = const.FILL_HOLES_MAX_SIZE,
                        name: str = "", device=DEFAULT_DEVICE) -> Surface:
    """Read a mesh file into a Surface, capping open boundaries up to
    ``fill_holes_size`` (0 skips; reference surface.py:619
    OnImportSurfaceFile and :437 OnImportCustomBinFile).  Volume and area
    are taken on ``device``."""
    from invesalius3_tpu_torch.io import mesh_io

    p = Path(path)
    verts, faces = mesh_io.import_surface(p)
    n_filled = 0
    if fill_holes_size:
        verts, faces, n_filled = mesh_ops.fill_holes(verts, faces,
                                                     fill_holes_size)
    s = Surface(vertices=np.asarray(verts, np.float32),
                faces=np.asarray(faces, np.int32), name=name or p.stem)
    s.filled_holes = n_filled
    s.compute_properties(device)
    return s


class _StageClock:
    """Records each stage's seconds into ``times`` (the device synchronised
    at the stage's end) when the caller asked for them; else does nothing."""

    def __init__(self, times: Optional[dict], dev: torch.device):
        self.times, self.dev = times, dev
        self.t0 = self._now()

    def _now(self) -> float:
        if self.times is not None and self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.perf_counter()

    def mark(self, name: str) -> None:
        if self.times is not None:
            t = self._now()
            self.times[name] = t - self.t0
            self.t0 = t


def create_surface_from_mask(
    mask: Mask,
    spacing: Tuple[float, float, float],
    quality: str = const.DEFAULT_SURFACE_QUALITY,
    algorithm: str = "Default",
    smooth_iterations: Optional[int] = None,
    smooth_relaxation: Optional[float] = None,
    decimate_reduction: Optional[float] = None,
    keep_largest: bool = False,
    fill_holes: bool = False,
    ca_options: Optional[dict] = None,
    name: str = "",
    times: Optional[dict] = None,
) -> Surface:
    """The reference creation pipeline (surface.py:1259 ->
    surface_process.py:204-415) on the mask's device: marching ->
    [ca_smoothing if algorithm == 'ca_smoothing'] -> to the host ->
    [decimate] -> [keep largest] -> mass properties.

    The JAX package's quirks are kept: no Laplacian smoothing and no
    resample for any preset (the reference has both commented out);
    'Default' and 'Binary' are the same; the preset's decimate_reduction
    applies when the caller passes none (the JAX package's sane gate, where
    the reference's is inverted); ``fill_holes`` is a no-op because
    marching output is closed.  ``times``, if given, receives each stage's
    seconds (marching, smoothing, to_host, decimate, keep_largest,
    mass_properties), the device synchronised at each stage's end.
    """
    del smooth_iterations, smooth_relaxation, fill_holes  # the JAX package ignores them
    if decimate_reduction is None and quality in const.SURFACE_QUALITY:
        decimate_reduction = const.SURFACE_QUALITY[quality][3]
    dev = mask.data.device
    clock = _StageClock(times, dev)
    dm = marching.mask_to_surface_device(mask.data, spacing)
    clock.mark("marching")

    if algorithm == "ca_smoothing":
        opts = {"t": 0.7, "tmax": 3.0, "bmin": 0.5, "n_iters": 10,
                "propagate": "grid"}
        if ca_options:
            opts.update(ca_options)
        dm = dataclasses.replace(dm, verts3v=mesh_ops.ca_smoothing_device(
            dm, opts["t"], opts["tmax"], opts["bmin"], opts["n_iters"],
            propagate=opts["propagate"]))
        clock.mark("smoothing")

    verts, faces = marching.mesh_to_host(dm)
    del dm
    clock.mark("to_host")

    if decimate_reduction:
        verts, faces = decimate(verts, faces, decimate_reduction)
        clock.mark("decimate")

    if keep_largest:
        verts, faces = mesh_ops.keep_largest_component(verts, faces)
        clock.mark("keep_largest")

    s = Surface(vertices=np.asarray(verts, np.float32), faces=np.asarray(faces))
    if name:
        s.name = name
    s.compute_properties(dev)
    clock.mark("mass_properties")
    return s


def merge_surfaces(surfaces, device=DEFAULT_DEVICE) -> Surface:
    """One mesh from many (reference polydata_utils.py:142 Merge)."""
    verts, faces = [], []
    base = 0
    for s in surfaces:
        verts.append(np.asarray(s.vertices, np.float32))
        faces.append(np.asarray(s.faces, np.int64) + base)
        base += len(s.vertices)
    out = Surface(vertices=np.concatenate(verts),
                  faces=np.concatenate(faces).astype(np.int32), name="merged")
    out.compute_properties(device)
    return out


def split_surface(surface: Surface, device=DEFAULT_DEVICE) -> list:
    """One new Surface per connected component with faces, largest first
    (reference surface.py:431 OnSplitSurface)."""
    parts = mesh_ops.split_components(surface.vertices, surface.faces)
    # face-less components (isolated vertices) are dropped
    parts = sorted((p for p in parts if len(p[1])),
                   key=lambda p: len(p[1]), reverse=True)
    out = []
    for i, (v, f) in enumerate(parts):
        s = Surface(vertices=v, faces=f, name=f"{surface.name} part {i + 1}")
        s.colour = surface.colour
        s.compute_properties(device)
        out.append(s)
    return out


def surface_from_seeds(surface: Surface, seeds, seeds_are_points: bool = True,
                       device=DEFAULT_DEVICE) -> Surface:
    """New surface keeping the components hit by the seeds: world-mm points
    (default) or vertex ids (reference surface.py:319 OnSeedSurface)."""
    ids = (mesh_ops.nearest_vertex(surface.vertices, seeds)
           if seeds_are_points else seeds)
    v, f = mesh_ops.select_components_by_seeds(surface.vertices, surface.faces, ids)
    s = Surface(vertices=v, faces=f, name=f"{surface.name} (seeded)")
    s.colour = surface.colour
    s.compute_properties(device)
    return s


def smooth_surface(surface: Surface, iterations: int = 20,
                   relaxation: float = 0.4, device=DEFAULT_DEVICE) -> Surface:
    """Laplacian relaxation on ``device`` (reference surface.py:344
    OnSmoothSurface -> vtkSmoothPolyDataFilter(iterations=20, 0.4))."""
    v = mesh_ops.laplacian_smooth(surface.vertices, surface.faces,
                                  iterations, relaxation, device)
    s = Surface(vertices=v, faces=surface.faces.copy(),
                name=f"{surface.name} (smoothed)")
    s.colour = surface.colour
    s.compute_properties(device)
    return s


def decimate(verts: np.ndarray, faces: np.ndarray, reduction: float):
    """QEM decimation to (1 - reduction) of the triangles by the port's
    native decimator (``csrc/decimate.cpp``; the reference uses
    vtkQuadricDecimation, surface_process.py:350-372).  A failed build
    raises: there is no fallback."""
    if reduction <= 0:
        return verts, faces
    from invesalius3_tpu_torch import native

    return native.decimate_qem(verts, faces, reduction)

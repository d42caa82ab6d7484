"""Crop-box geometry: the axis-aligned box state driving the crop-mask tool.

Reference: invesalius/data/geometry.py ``Box`` singleton :31 — stores voxel
min/max per axis, converts to world mm via spacing (SetSpacing :77), and
bakes per-orientation edge segments for the 2D viewers (MakeMatrix :100);
the crop itself is applied by CropMaskInteractorStyle via
Slice.do_threshold_to_all_slices + mask zeroing outside the box.

A copy of invesalius3_tpu/core/geometry.py: a plain class (no
singleton/pubsub); the edge-segment "matrix" is returned as data so any
frontend can draw it; the crop itself is ops/morphology.crop_mask.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class Box:
    """Axis-aligned crop box.  Limits are voxel indices (inclusive), world
    extents are voxel * spacing, mirroring reference geometry.py:31-98."""

    def __init__(self, shape: Tuple[int, int, int] = (1, 1, 1),
                 spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)):
        self.shape = tuple(int(s) for s in shape)
        self.spacing = tuple(float(s) for s in spacing)  # (sx, sy, sz)
        # voxel-index limits, (zi, zf, yi, yf, xi, xf), full volume initially
        self.zi, self.zf = 0, self.shape[0] - 1
        self.yi, self.yf = 0, self.shape[1] - 1
        self.xi, self.xf = 0, self.shape[2] - 1

    # -- setters (reference SetX/SetY/SetZ keep i <= f) -------------------------
    def set_x(self, i: int, f: int) -> None:
        self.xi, self.xf = sorted((int(i), int(f)))

    def set_y(self, i: int, f: int) -> None:
        self.yi, self.yf = sorted((int(i), int(f)))

    def set_z(self, i: int, f: int) -> None:
        self.zi, self.zf = sorted((int(i), int(f)))

    def set_limits(self, zi, zf, yi, yf, xi, xf) -> None:
        self.set_z(zi, zf)
        self.set_y(yi, yf)
        self.set_x(xi, xf)

    def clamp(self) -> None:
        self.zi = max(0, min(self.zi, self.shape[0] - 1))
        self.zf = max(self.zi, min(self.zf, self.shape[0] - 1))
        self.yi = max(0, min(self.yi, self.shape[1] - 1))
        self.yf = max(self.yi, min(self.yf, self.shape[1] - 1))
        self.xi = max(0, min(self.xi, self.shape[2] - 1))
        self.xf = max(self.xi, min(self.xf, self.shape[2] - 1))

    # -- world-space views -------------------------------------------------------
    @property
    def world_limits(self) -> Tuple[float, float, float, float, float, float]:
        """(xi, xf, yi, yf, zi, zf) in mm (reference SetSpacing semantics)."""
        sx, sy, sz = self.spacing
        return (self.xi * sx, self.xf * sx, self.yi * sy, self.yf * sy,
                self.zi * sz, self.zf * sz)

    def make_matrix(self) -> Dict[str, List[List[List[float]]]]:
        """Per-orientation edge segments of the box, world mm, half-voxel
        expanded — the data the reference bakes for its 2D viewer overlays
        (geometry.py MakeMatrix :100-214).  Keys: AXIAL/CORONAL/SAGITTAL;
        each is 4 segments of two (x, y, z) endpoints."""
        sx, sy, sz = self.spacing
        xi, xf = self.xi * sx, self.xf * sx
        yi, yf = self.yi * sy, self.yf * sy
        zi, zf = self.zi * sz, self.zf * sz
        xi_e, xf_e = xi - sx / 2.0, xf + sx / 2.0
        yi_e, yf_e = yi - sy / 2.0, yf + sy / 2.0
        zi_e, zf_e = zi - sz / 2.0, zf + sz / 2.0
        return {
            # axial plane (fixed z): rectangle in (x, y)
            "AXIAL": [
                [[xi, yi_e, zi], [xf, yi_e, zi]],
                [[xi, yf_e, zi], [xf, yf_e, zi]],
                [[xi_e, yi, zi], [xi_e, yf, zi]],
                [[xf_e, yi, zi], [xf_e, yf, zi]],
            ],
            # coronal plane (fixed y): rectangle in (x, z)
            "CORONAL": [
                [[xi, yi, zi_e], [xf, yi, zi_e]],
                [[xi, yi, zf_e], [xf, yi, zf_e]],
                [[xi_e, yi, zi], [xi_e, yi, zf]],
                [[xf_e, yi, zi], [xf_e, yi, zf]],
            ],
            # sagittal plane (fixed x): rectangle in (y, z)
            "SAGITTAL": [
                [[xi, yi, zi_e], [xi, yf, zi_e]],
                [[xi, yi, zf_e], [xi, yf, zf_e]],
                [[xi, yi_e, zi], [xi, yi_e, zf]],
                [[xi, yf_e, zi], [xi, yf_e, zf]],
            ],
        }

    @property
    def limits(self) -> Tuple[int, int, int, int, int, int]:
        """(zi, zf, yi, yf, xi, xf) voxel limits for ops.morphology.crop_mask."""
        return (self.zi, self.zf, self.yi, self.yf, self.xi, self.xf)

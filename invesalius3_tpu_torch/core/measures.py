"""Measurements: linear, angular, density (circle/polygon region stats),
and surface-geodesic distance (port of invesalius3_tpu/core/measures.py;
numpy and scipy on the host, as there: a density measure takes the one 2-D
plane the caller copied from the device).

Reference: invesalius/data/measures.py — ``MeasurementManager`` :143 with
serializable ``Measurement`` :673, linear :877, angular :1533, geodesic
(surface-constrained) :1068, density circle/polygon :1818/:2138 reporting
mean/min/max/std over the region; invesalius/math_utils.py distance/angle
helpers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from invesalius3_tpu_torch import events

LINEAR = "linear"
ANGULAR = "angular"
DENSITY_ELLIPSE = "density_ellipse"
DENSITY_POLYGON = "density_polygon"
GEODESIC = "geodesic"
ANNOTATION = "annotation"


def calculate_distance(p1, p2) -> float:
    """Euclidean distance (reference math_utils.py:7)."""
    return float(np.linalg.norm(np.asarray(p2, float) - np.asarray(p1, float)))


def calculate_angle(v1, v2) -> float:
    """Angle between two vectors in degrees (reference math_utils.py:20)."""
    v1 = np.asarray(v1, float)
    v2 = np.asarray(v2, float)
    cos = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def angle_from_3_points(p0, p1, p2) -> float:
    """Angle at vertex p1 formed by p0-p1-p2."""
    return calculate_angle(np.asarray(p0, float) - p1, np.asarray(p2, float) - p1)


def polygon_area_perimeter(points: Sequence[Tuple[float, float]]) -> Tuple[float, float]:
    """Shoelace area + perimeter of a closed 2D polygon (reference
    math_utils.py:60-107)."""
    pts = np.asarray(points, float)
    x, y = pts[:, 0], pts[:, 1]
    area = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    per = float(np.sum(np.linalg.norm(np.roll(pts, -1, axis=0) - pts, axis=1)))
    return float(area), per


# ---------------------------------------------------------------------------
# density measures (stats inside a 2D region of a slice)
# ---------------------------------------------------------------------------


def _region_stats(values: np.ndarray) -> Dict[str, float]:
    if values.size == 0:
        return {"mean": 0.0, "min": 0.0, "max": 0.0, "std": 0.0, "area_px": 0}
    return {
        "mean": float(values.mean()),
        "min": float(values.min()),
        "max": float(values.max()),
        "std": float(values.std()),
        "area_px": int(values.size),
    }


def density_ellipse(image2d: np.ndarray, center_yx, radius_y: float, radius_x: float) -> Dict:
    """Density stats inside an ellipse (reference measures.py:1818)."""
    h, w = image2d.shape
    yy, xx = np.mgrid[:h, :w]
    cy, cx = center_yx
    inside = ((yy - cy) / radius_y) ** 2 + ((xx - cx) / radius_x) ** 2 <= 1.0
    return _region_stats(np.asarray(image2d)[inside])


def polygon2mask(shape: Tuple[int, int], points_yx: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Scanline polygon rasterization -> bool mask (reference
    invesalius_rs/src/polygon_mask.rs polygon2mask_rs, even-odd rule)."""
    h, w = shape
    pts = np.asarray(points_yx, float)
    mask = np.zeros(shape, bool)
    n = len(pts)
    xx = np.arange(w) + 0.0
    for y in range(h):
        crossings = []
        for i in range(n):
            y0, x0 = pts[i]
            y1, x1 = pts[(i + 1) % n]
            if (y0 <= y < y1) or (y1 <= y < y0):
                t = (y - y0) / (y1 - y0)
                crossings.append(x0 + t * (x1 - x0))
        crossings.sort()
        for a, b in zip(crossings[::2], crossings[1::2]):
            mask[y, (xx >= a) & (xx <= b)] = True
    return mask


def density_polygon(image2d: np.ndarray, points_yx: Sequence[Tuple[float, float]]) -> Dict:
    """Density stats inside a polygon (reference measures.py:2138)."""
    mask = polygon2mask(image2d.shape, points_yx)
    return _region_stats(np.asarray(image2d)[mask])


# ---------------------------------------------------------------------------
# geodesic distance on a surface (reference measures.py:1068)
# ---------------------------------------------------------------------------


def geodesic_distance(
    verts: np.ndarray, faces: np.ndarray, start_idx: int, end_idx: int
) -> float:
    """Shortest path along mesh edges (Dijkstra over the edge graph —
    the reference uses a vtkDijkstraGraphGeodesicPath)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    faces = np.asarray(faces, np.int64)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [0, 2]]])
    e = np.unique(np.sort(e, axis=1), axis=0)  # dedupe: coo sums duplicates
    lengths = np.linalg.norm(verts[e[:, 0]] - verts[e[:, 1]], axis=1)
    n = len(verts)
    g = coo_matrix((lengths, (e[:, 0], e[:, 1])), shape=(n, n))
    dist = dijkstra(g, directed=False, indices=[start_idx])[0]
    return float(dist[end_idx])


def ray_pick(
    verts: np.ndarray,
    faces: np.ndarray,
    origin: Sequence[float],
    direction: Sequence[float],
    chunk: int = 1_000_000,
) -> Optional[Tuple[float, int, int, np.ndarray]]:
    """Nearest ray-triangle intersection (Möller–Trumbore, vectorized,
    chunked so million-face meshes stay under ~200 MB of temporaries).

    The viewer's geodesic tool casts a camera ray per click; the reference
    uses a vtkCellPicker against the live scene (measures.py:1068 geodesic
    path + viewer_volume picking).  Returns (t, face_idx, vertex_idx,
    hit_point) for the closest front hit, or None.  vertex_idx is the hit
    face's corner nearest the intersection point — the Dijkstra endpoint.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    best = None
    for f0 in range(0, len(faces), chunk):
        f = faces[f0 : f0 + chunk]
        v0 = verts[f[:, 0]]
        e1 = verts[f[:, 1]] - v0
        e2 = verts[f[:, 2]] - v0
        p = np.cross(d, e2)
        det = np.einsum("ij,ij->i", e1, p)
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = o - v0
        u = np.einsum("ij,ij->i", tv, p) * inv
        q = np.cross(tv, e1)
        v = q @ d * inv
        t = np.einsum("ij,ij->i", e2, q) * inv
        ok &= (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-9)
        if not ok.any():
            continue
        ti = np.where(ok, t, np.inf).argmin()
        if best is None or t[ti] < best[0]:
            best = (float(t[ti]), f0 + int(ti))
    if best is None:
        return None
    t, fi = best
    point = o + t * d
    corners = verts[faces[fi]]
    vi = int(faces[fi][np.linalg.norm(corners - point, axis=1).argmin()])
    return t, fi, vi, point


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Measurement:
    index: int = 0
    name: str = ""
    type: str = LINEAR
    location: str = "AXIAL"
    slice_number: int = 0
    points: List = dataclasses.field(default_factory=list)
    value: float = 0.0
    unit: str = "mm"
    colour: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    visible: bool = True
    extra: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    # reference constants.py int codes (measurements written by the
    # reference serialize type/location as ints; constants.py:98-113)
    _REF_TYPES = {6: LINEAR, 7: ANGULAR, 8: DENSITY_ELLIPSE, 9: DENSITY_POLYGON,
                  10: ANNOTATION}
    _REF_LOCATIONS = {1: "AXIAL", 2: "CORONAL", 3: "SAGITAL", 5: "SURFACE"}

    @classmethod
    def from_dict(cls, d: dict) -> "Measurement":
        d = dict(d)
        if isinstance(d.get("type"), int):
            d["type"] = cls._REF_TYPES.get(d["type"], LINEAR)
        if isinstance(d.get("location"), int):
            d["location"] = cls._REF_LOCATIONS.get(d["location"], "AXIAL")
        if "points" in d:
            d["points"] = [list(p) for p in d["points"]]
        if "colour" in d:
            d["colour"] = tuple(d["colour"])[:3]
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class MeasurementManager:
    """Create/remove measurements, publish bus updates (reference
    measures.py:143)."""

    def __init__(self, bus=None):
        self.bus = bus or events.bus
        self.measures: Dict[int, Measurement] = {}
        self._next = 0

    def _add(self, m: Measurement) -> Measurement:
        m.index = self._next
        self._next += 1
        self.measures[m.index] = m
        self.bus.send_message("measures.added", index=m.index, value=m.value,
                              type=m.type)
        return m

    def add_linear(self, p1, p2, location="AXIAL", slice_number=0) -> Measurement:
        return self._add(Measurement(
            type=LINEAR, points=[list(p1), list(p2)],
            value=calculate_distance(p1, p2), location=location,
            slice_number=slice_number, name=f"M {self._next + 1}"))

    def add_angular(self, p0, p1, p2, location="AXIAL", slice_number=0) -> Measurement:
        return self._add(Measurement(
            type=ANGULAR, points=[list(p0), list(p1), list(p2)],
            value=angle_from_3_points(p0, p1, p2), unit="deg",
            location=location, slice_number=slice_number,
            name=f"M {self._next + 1}"))

    def add_annotation(self, point, text: str, lead_point=None,
                       location="AXIAL", slice_number=0) -> Measurement:
        """Text note anchored at a point with an optional leader-line end
        (reference measures.py:1320 AnnotationMeasure: marker point +
        text beside it; ``value`` holds the text)."""
        points = [list(point)]
        if lead_point is not None:
            points.append(list(lead_point))
        return self._add(Measurement(
            type=ANNOTATION, points=points, value=text, unit="",
            location=location, slice_number=slice_number,
            name=f"A {self._next + 1}"))

    def add_density_ellipse(self, image2d, center_yx, ry, rx, **kw) -> Measurement:
        stats = density_ellipse(image2d, center_yx, ry, rx)
        stats.update({"ry": float(ry), "rx": float(rx),
                      "center_yx": [float(center_yx[0]), float(center_yx[1])]})
        m = Measurement(type=DENSITY_ELLIPSE, value=stats["mean"], unit="HU",
                        extra=stats, name=f"D {self._next + 1}", **kw)
        return self._add(m)

    def add_density_polygon(self, image2d, points_yx, **kw) -> Measurement:
        stats = density_polygon(image2d, points_yx)
        m = Measurement(type=DENSITY_POLYGON, value=stats["mean"], unit="HU",
                        extra=stats, name=f"D {self._next + 1}", **kw)
        return self._add(m)

    def add_geodesic(self, verts, faces, i0, i1) -> Measurement:
        import math

        value = geodesic_distance(verts, faces, i0, i1)
        if not math.isfinite(value):
            # picks on different connected components: Dijkstra returns
            # inf, which json.dumps would emit as invalid JSON and poison
            # every later /api/measures response — reject up front
            raise ValueError(
                "no surface path between the picked points (they lie on "
                "different connected components)")
        return self._add(Measurement(
            type=GEODESIC, points=[verts[i0].tolist(), verts[i1].tolist()],
            value=value, location="3D", name=f"M {self._next + 1}"))

    def remove(self, index: int) -> None:
        self.measures.pop(index, None)
        self.bus.send_message("measures.removed", index=index)

    def to_dict(self) -> dict:
        return {str(i): m.to_dict() for i, m in self.measures.items()}

    def load_dict(self, d: dict) -> None:
        for _, md in d.items():
            m = Measurement.from_dict(md)
            self.measures[m.index] = m
            self._next = max(self._next, m.index + 1)

"""Markers: versioned fiducial/target/landmark records with JSON/CSV
import-export and scalp snapping (port of
invesalius3_tpu/navigation/markers.py).

Reference: invesalius/data/markers/marker.py — ``MarkerType`` enum :10
(FIDUCIAL / LANDMARK / BRAIN_TARGET / COIL_TARGET / COIL_POSE), versioned
``Marker`` dataclass :45 serialized into the project and sent to the
robot; invesalius/navigation/markers.py ``MarkersControl`` :32 (add /
delete / select / target set / import-export JSON & CSV).
"""

from __future__ import annotations

import csv
import dataclasses
import json
from enum import IntEnum
from pathlib import Path
from typing import List, Optional

import numpy as np

MARKER_FILE_VERSION = 1


class MarkerType(IntEnum):
    FIDUCIAL = 0
    LANDMARK = 1
    BRAIN_TARGET = 2
    COIL_TARGET = 3
    COIL_POSE = 4


@dataclasses.dataclass
class Marker:
    marker_id: int = 0
    marker_type: MarkerType = MarkerType.LANDMARK
    position: tuple = (0.0, 0.0, 0.0)
    orientation: tuple = (0.0, 0.0, 0.0)
    colour: tuple = (1.0, 1.0, 0.0)
    size: float = 2.0
    label: str = ""
    is_target: bool = False
    visible: bool = True
    session_id: int = 1
    # coil-target extras (reference marker.py z_offset/z_rotation fields)
    z_rotation: float = 0.0
    z_offset: float = 0.0
    # MEP amplitude in µV for motor mapping (reference marker.py mep_value,
    # consumed by mep_visualizer); None = not a MEP sample
    mep_value: float = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["marker_type"] = int(self.marker_type)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Marker":
        d = dict(d)
        d["marker_type"] = MarkerType(d.get("marker_type", 1))
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        for key in ("position", "orientation", "colour"):
            if key in d:
                d[key] = tuple(d[key])
        return cls(**d)


class MarkersControl:
    """Add/delete/select markers, single-target invariant, JSON/CSV IO."""

    def __init__(self, bus=None):
        from invesalius3_tpu_torch import events

        self.bus = bus or events.bus
        self.markers: List[Marker] = []
        self._next_id = 0

    def add(self, marker: Marker) -> Marker:
        marker.marker_id = self._next_id
        self._next_id += 1
        self.markers.append(marker)
        self.bus.send_message("markers.added", marker=marker)
        return marker

    def delete(self, marker_id: int) -> None:
        self.markers = [m for m in self.markers if m.marker_id != marker_id]
        self.bus.send_message("markers.deleted", marker_id=marker_id)

    def clear(self) -> None:
        self.markers.clear()
        self.bus.send_message("markers.cleared")

    def get(self, marker_id: int) -> Optional[Marker]:
        return next((m for m in self.markers if m.marker_id == marker_id), None)

    def set_target(self, marker_id: int) -> None:
        """Only one marker can be the active target (reference
        markers.py SetTarget)."""
        for m in self.markers:
            m.is_target = m.marker_id == marker_id
        self.bus.send_message("markers.target_set", marker_id=marker_id)

    def unset_target(self) -> None:
        for m in self.markers:
            m.is_target = False
        self.bus.send_message("markers.target_unset")

    @property
    def target(self) -> Optional[Marker]:
        return next((m for m in self.markers if m.is_target), None)

    # -- IO (reference markers import/export) ----------------------------------
    def save_json(self, path) -> None:
        payload = {
            "version": MARKER_FILE_VERSION,
            "markers": [m.to_dict() for m in self.markers],
        }
        Path(path).write_text(json.dumps(payload, indent=2))

    def load_json(self, path) -> None:
        payload = json.loads(Path(path).read_text())
        for d in payload["markers"]:
            self.add(Marker.from_dict(d))

    def save_csv(self, path) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "type", "x", "y", "z", "alpha", "beta", "gamma",
                        "label", "is_target", "z_rotation", "z_offset"])
            for m in self.markers:
                w.writerow([m.marker_id, int(m.marker_type), *m.position,
                            *m.orientation, m.label, int(m.is_target),
                            m.z_rotation, m.z_offset])

    def load_csv(self, path) -> None:
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                self.add(Marker(
                    marker_type=MarkerType(int(row["type"])),
                    position=(float(row["x"]), float(row["y"]), float(row["z"])),
                    orientation=(float(row["alpha"]), float(row["beta"]),
                                 float(row["gamma"])),
                    label=row["label"],
                    is_target=bool(int(row["is_target"])),
                    z_rotation=float(row.get("z_rotation", 0) or 0),
                    z_offset=float(row.get("z_offset", 0) or 0),
                ))


def project_to_scalp(
    point: np.ndarray, scalp_verts: np.ndarray, scalp_normals: Optional[np.ndarray] = None
) -> np.ndarray:
    """Snap a marker onto the nearest scalp vertex (reference
    data/markers/surface_geometry.py snapping)."""
    d = np.linalg.norm(scalp_verts - np.asarray(point)[None, :], axis=1)
    return scalp_verts[int(np.argmin(d))]

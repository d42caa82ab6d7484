"""Per-vendor tracker pose converters: raw SDK payloads -> 6-DOF rows
(port of invesalius3_tpu/navigation/vendor_coords.py: host numpy on the
port's own ``ops/transforms.py``).

Reference: invesalius/data/coordinates.py:139-511 — each tracker vendor
returns poses in its own units/axes/orientation encoding; these pure
functions reproduce the conversions so a hardware backend only has to
hand over the raw payload.  The vendor SDK *connections* stay
hardware-gated (navigation/tracker.py), but the math is testable here.

All converters return ``(x, y, z, alpha, beta, gamma)`` with angles in
degrees, euler order 'rzyx' — the convention the coregistration chain
consumes (coordinates.py:582 coordinates_to_transformation_matrix).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from invesalius3_tpu_torch.ops import transforms as tr

POSE_MISSING = np.zeros(6)


def euler_from_quaternion(q: Sequence[float], axes: str = "rzyx") -> np.ndarray:
    """Euler angles (radians) from a (w, x, y, z) quaternion."""
    return np.asarray(tr.euler_from_matrix(tr.quaternion_matrix(q), axes=axes))


def quaternion_pose(q_wxyz: Sequence[float], t_xyz: Sequence[float]) -> np.ndarray:
    """Generic quaternion+translation -> 6-DOF ('rzyx' degrees) — the NDI
    Polaris convention (coordinates.py:259 PolarisCoord)."""
    angles = np.degrees(euler_from_quaternion(q_wxyz))
    return np.hstack([np.asarray(t_xyz, float), angles])


def parse_polaris_p4(record: str) -> Optional[np.ndarray]:
    """Decode one Polaris P4 ASCII tool record (coordinates.py:139
    PolarisP4Coord): after the 2-char prefix, four 6-char quaternion ints
    scaled 1e-4 then three 7-char translation ints scaled 1e-2; 'MISSING'
    tools return None."""
    body = record[2:]
    if body[:7] == "MISSING":
        return None
    q = [int(body[i:i + 6]) * 0.0001 for i in range(0, 24, 6)]
    t = [int(body[i:i + 7]) * 0.01 for i in range(24, 45, 7)]
    return quaternion_pose(q, t)


def optitrack_pose(qw: float, qx: float, qy: float, qz: float,
                   px: float, py: float, pz: float) -> np.ndarray:
    """Motive API rigid body -> InVesalius frame (coordinates.py:183
    OptitrackCoord): meters -> mm with the (z, x, y) position permutation
    and the (w, z, x, y) quaternion reshuffle."""
    angles = np.degrees(euler_from_quaternion([qw, qz, qx, qy]))
    return np.hstack([np.array([pz, px, py]) * 1000.0, angles])


def claron_pose(x: float, y: float, z: float,
                angle_z: float, angle_y: float, angle_x: float) -> np.ndarray:
    """MicronTracker (Claron) already reports mm + ZYX angles in degrees
    (coordinates.py:295 ClaronCoord): pass through in (z, y, x) angle
    order."""
    return np.array([x, y, z, angle_z, angle_y, angle_x], float)


def polhemus_wrapper_pose(row: Sequence[float], scale_cm_to_mm: bool = True
                          ) -> np.ndarray:
    """Polhemus wrapper library row (x, y, z, a, b, g) in cm
    (coordinates.py:356): scale to mm, angles pass through."""
    row = np.asarray(row, float)
    s = 10.0 if scale_cm_to_mm else 1.0
    return np.hstack([row[:3] * s, row[3:6]])


def polhemus_usb_pose(values: Sequence[float], tracker_is_patriot: bool
                      ) -> np.ndarray:
    """Polhemus USB payload (coordinates.py:414 PolhemusUSBCoord): Patriot
    reports cm (x10), Fastrak/Isotrak inches (x25.4); z is negated."""
    v = np.asarray(values, float)
    s = 10.0 if tracker_is_patriot else 25.4
    return np.array([v[0] * s, v[1] * s, -v[2] * s, v[3], v[4], v[5]])


def parse_polhemus_serial(line: bytes) -> np.ndarray:
    """Polhemus ISOTRAK serial line (coordinates.py:467): fields may abut
    through their minus signs; first token is the station letter.  cm -> mm."""
    data = line.replace(b"-", b" -").split()
    vals = [float(s) for s in data[1:]]
    return np.array([vals[0] * 10.0, vals[1] * 10.0, vals[2] * 10.0,
                     vals[3], vals[4], vals[5]])


def polhemus_dynamic_pose(probe: np.ndarray, reference: np.ndarray
                          ) -> np.ndarray:
    """Attitude-matrix dynamic reference (Polhemus manual; reference
    coordinates.py:622 dynamic_reference): rotate (probe - reference) by
    the reference's azimuth/elevation/roll, negate z."""
    a, b, g = np.radians(reference[3:6])
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cg, sg = np.cos(g), np.sin(g)
    m_rot = np.array([
        [ca * cb, sb * sg * ca - cg * sa, ca * sb * cg + sa * sg],
        [cb * sa, sb * sg * sa + cg * ca, cg * sb * sa - sg * ca],
        [-sb, sg * cb, cb * cg],
    ])
    vet = np.asarray(probe[:3], float) - np.asarray(reference[:3], float)
    rot = vet @ m_rot
    return np.array([rot[0], rot[1], -rot[2], probe[3], probe[4], probe[5]])

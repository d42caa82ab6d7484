"""Real-time coregistration: tracker space -> image space pose computation
(port of invesalius3_tpu/navigation/coregistration.py).

Reference: invesalius/data/coregistration.py — static/dynamic object coreg
math :34-331 (probe :173, dynamic object :217, static :252,
``image_to_tracker`` :109 for robot targets) and the 120 Hz
``CoordinateCorregistrate`` thread :332 feeding bounded LIFO queues.

The per-pose math is a fixed chain of 4x4 float64 matmuls on the host, as
in the JAX package: the 120 Hz loop never waits on the card.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from invesalius3_tpu_torch.ops import transforms as tr


def pose_to_matrix(coord: np.ndarray) -> np.ndarray:
    """6-vector (x, y, z, a, b, g degrees) -> 4x4 (reference
    coordinates.py coordinates_to_transformation_matrix, 'rzyx')."""
    a, b, g = np.radians(coord[3:6])
    m = tr.euler_matrix(a, b, g, axes="rzyx")
    m[:3, 3] = coord[:3]
    return m


def matrix_to_pose(m: np.ndarray) -> np.ndarray:
    a, b, g = tr.euler_from_matrix(m, axes="rzyx")
    return np.array([m[0, 3], m[1, 3], m[2, 3],
                     np.degrees(a), np.degrees(b), np.degrees(g)])


def dynamic_reference(probe_pose: np.ndarray, ref_pose: np.ndarray) -> np.ndarray:
    """Express the probe pose relative to the patient reference sensor
    (compensates head motion — reference coregistration dynamic mode)."""
    m_probe = pose_to_matrix(probe_pose)
    m_ref = pose_to_matrix(ref_pose)
    return np.linalg.inv(m_ref) @ m_probe


def corregistrate_probe(
    m_change: np.ndarray,
    probe_pose: np.ndarray,
    ref_pose: Optional[np.ndarray] = None,
    m_icp: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Tracker probe pose -> image-space 4x4 (reference
    coregistration.py:173-216 corregistrate_probe)."""
    if ref_pose is not None:
        m_probe = dynamic_reference(probe_pose, ref_pose)
    else:
        m_probe = pose_to_matrix(probe_pose)
    m_img = m_change @ m_probe
    if m_icp is not None:
        m_img = m_icp @ m_img
    return m_img


def corregistrate_object_dynamic(
    m_change: np.ndarray,
    obj_data: tuple,
    coil_pose: np.ndarray,
    ref_pose: Optional[np.ndarray],
    m_icp: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Coil pose -> image space using the object registration data
    (reference coregistration.py:217-251)."""
    t_obj_reference, r_s0_raw, s0_dyn, m_obj_raw = obj_data
    m_coil = pose_to_matrix(coil_pose)
    if ref_pose is not None:
        m_ref = pose_to_matrix(ref_pose)
        m_dyn = np.linalg.inv(m_ref) @ m_coil
    else:
        m_dyn = m_coil
    m_img = m_change @ m_dyn @ np.linalg.inv(r_s0_raw) @ t_obj_reference
    if m_icp is not None:
        m_img = m_icp @ m_img
    return m_img


def image_to_tracker(
    m_change: np.ndarray,
    target_img: np.ndarray,
    ref_pose: Optional[np.ndarray] = None,
    m_icp: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Image-space target -> tracker space (for robot targets, reference
    coregistration.py:109-172)."""
    m_target = pose_to_matrix(target_img)
    if m_icp is not None:
        m_target = np.linalg.inv(m_icp) @ m_target
    m_trk = np.linalg.inv(m_change) @ m_target
    if ref_pose is not None:
        m_trk = pose_to_matrix(ref_pose) @ m_trk
    return m_trk


class LIFOQueue(queue.Queue):
    """Bounded queue that drops stale items (reference navigation.py:81-105
    QueueCustom.clear: consumers only ever want the freshest pose)."""

    def put_latest(self, item) -> None:
        while True:
            try:
                self.put_nowait(item)
                return
            except queue.Full:
                try:
                    self.get_nowait()
                except queue.Empty:
                    pass


@dataclass
class CoregistrationData:
    m_change: np.ndarray
    obj_datas: Dict[int, tuple] = field(default_factory=dict)  # coil idx -> obj data
    m_icp: Optional[np.ndarray] = None
    use_dynamic_reference: bool = True


class CoordinateCorregistrate(threading.Thread):
    """The 120 Hz loop: read tracker -> compute image-space poses -> push
    to queues (reference coregistration.py:332-470)."""

    def __init__(self, tracker, data: CoregistrationData,
                 coord_queue: LIFOQueue, poll_hz: float = 120.0,
                 extra_queues: tuple = ()):
        super().__init__(daemon=True)
        self.tracker = tracker
        self.data = data
        self.coord_queue = coord_queue
        # side consumers (tracts, e-field, serial trigger) each get their
        # own drop-stale queue so a slow worker never back-pressures the
        # 120 Hz loop (reference coregistration.py:397-470 pushes the same
        # pose to coord/tracts/efield/serial queues)
        self.extra_queues = tuple(extra_queues)
        self.period = 1.0 / poll_hz
        self._stop_event = threading.Event()

    def compute_once(self) -> dict:
        coords, flags = self.tracker.get_coordinates()
        ref_pose = coords[1] if self.data.use_dynamic_reference else None
        m_probe_img = corregistrate_probe(
            self.data.m_change, coords[0], ref_pose, self.data.m_icp)
        coils = {}
        for idx, obj_data in self.data.obj_datas.items():
            coils[idx] = corregistrate_object_dynamic(
                self.data.m_change, obj_data, coords[2], ref_pose, self.data.m_icp)
        return {
            "probe_pose_img": matrix_to_pose(m_probe_img),
            "m_probe_img": m_probe_img,
            "coils_img": coils,
            "markers_flag": flags,
            "raw": coords,
            "timestamp": time.monotonic(),
        }

    def run(self):
        while not self._stop_event.is_set():
            t0 = time.monotonic()
            item = self.compute_once()
            self.coord_queue.put_latest(item)
            for q in self.extra_queues:
                q.put_latest(item)
            dt = time.monotonic() - t0
            if dt < self.period:
                time.sleep(self.period - dt)

    def stop(self):
        self._stop_event.set()

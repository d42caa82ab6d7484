"""Navigation engine: the real-time pipeline orchestrator (port of
invesalius3_tpu/navigation/navigation.py).

Reference: invesalius/navigation/navigation.py — ``NavigationHub`` :54
composing Tracker/Image/ICP/Pedal/Robot/Markers, ``Navigation`` :341:
fiducial registration (EstimateTrackerToInVTransformationMatrix :549,
FRE :524), ``StartNavigation`` :589 spawning the thread pipeline
(coregistration -> [serial / tracts / e-field] -> UpdateNavigationScene
:107 with render rate limits :146-152), ``StopNavigation`` :759.

Pipeline: ReceiveCoordinates (tracker poll, >= 120 Hz) ->
CoordinateCorregistrate (pose math) -> UpdateNavigationScene (drains the
LIFO queue, rate-limits renders to <= 100 Hz / slices <= 10 Hz, publishes
bus events the viewers subscribe to).  The optional tract and e-field
workers run on ``device`` (the card unless the caller passes "cpu"); the
poll, coregistration and scene threads stay on the host and never wait on
the card.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.constants import (NAV_POLL_HZ, NAV_RENDER_MAX_HZ,
                                             NAV_SLICE_RENDER_MAX_HZ)
from invesalius3_tpu_torch.device import DEFAULT_DEVICE
from invesalius3_tpu_torch.navigation.coregistration import (
    CoordinateCorregistrate,
    CoregistrationData,
    LIFOQueue,
)
from invesalius3_tpu_torch.navigation.markers import MarkersControl
from invesalius3_tpu_torch.navigation.tracker import Tracker
from invesalius3_tpu_torch.ops import registration


class ImageFiducials:
    """Image-space fiducials (reference navigation/image.py)."""

    NAMES = ("LE", "RE", "NA")  # left ear, right ear, nasion

    def __init__(self):
        self.fiducials = np.full((3, 3), np.nan)

    def set(self, index: int, position) -> None:
        self.fiducials[index] = position

    def are_set(self) -> bool:
        return not np.isnan(self.fiducials).any()


class IterativeClosestPoint:
    """Surface-based refinement matrix holder (reference
    iterativeclosestpoint.py)."""

    def __init__(self):
        self.use_icp = False
        self.m_icp: Optional[np.ndarray] = None
        self.icp_fre: Optional[float] = None

    def register(self, surface_points: np.ndarray, probe_points: np.ndarray,
                 device=DEFAULT_DEVICE) -> float:
        m, err = registration.icp(probe_points, surface_points, device=device)
        self.m_icp = m
        self.icp_fre = err
        self.use_icp = True
        return err

    def save_state(self, session) -> None:
        session.set_state("icp", {
            "use_icp": self.use_icp,
            "m_icp": None if self.m_icp is None else self.m_icp.tolist(),
        })

    def load_state(self, session) -> None:
        st = session.get_state("icp")
        if st:
            self.use_icp = st["use_icp"]
            self.m_icp = None if st["m_icp"] is None else np.asarray(st["m_icp"])


class UpdateNavigationScene(threading.Thread):
    """Drains the pose queue, rate-limits, republishes to the bus
    (reference navigation.py:107-340)."""

    def __init__(self, coord_queue: LIFOQueue, bus=None,
                 render_max_hz: float = NAV_RENDER_MAX_HZ,
                 slice_max_hz: float = NAV_SLICE_RENDER_MAX_HZ):
        super().__init__(daemon=True)
        self.coord_queue = coord_queue
        self.bus = bus or events.bus
        self.render_period = 1.0 / render_max_hz
        self.slice_period = 1.0 / slice_max_hz
        self._stop_event = threading.Event()
        self._last_render = 0.0
        self._last_slice = 0.0

    def run(self):
        while not self._stop_event.is_set():
            try:
                item = self.coord_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            now = time.monotonic()
            if now - self._last_render >= self.render_period:
                self._last_render = now
                self.bus.send_message("navigation.update_scene", **item)
            if now - self._last_slice >= self.slice_period:
                self._last_slice = now
                self.bus.send_message(
                    "navigation.update_slices", position=item["probe_pose_img"][:3])

    def stop(self):
        self._stop_event.set()


class Navigation:
    """Fiducial registration + navigation lifecycle (reference
    navigation.py:341-800)."""

    def __init__(self, tracker: Optional[Tracker] = None, bus=None, device=DEFAULT_DEVICE):
        self.bus = bus or events.bus
        self.device = device
        self.tracker = tracker or Tracker()
        self.image = ImageFiducials()
        self.icp = IterativeClosestPoint()
        self.m_change: Optional[np.ndarray] = None
        self.fre: Optional[float] = None
        self.obj_datas: Dict[int, tuple] = {}
        self.use_dynamic_reference = True
        self._coreg: Optional[CoordinateCorregistrate] = None
        self._updater: Optional[UpdateNavigationScene] = None
        self.coord_queue = LIFOQueue(maxsize=1)
        self.is_navigating = False
        # optional side workers spawned with the pipeline (reference
        # navigation.py:589 StartNavigation spawns coreg -> [serial,
        # tracts, e-field]): kwargs for ComputeTractsThread /
        # VisualizeEFieldThread, set before start_navigation
        self.tract_params: Optional[dict] = None
        self.efield_params: Optional[dict] = None
        self._tract_thread = None
        self._efield_thread = None

    # -- registration ---------------------------------------------------------
    def estimate_tracker_to_image_transform(self) -> float:
        """Least-squares fiducial registration + FRE (reference
        navigation.py:549 + bases.py:111)."""
        assert self.image.are_set(), "image fiducials not set"
        assert self.tracker.are_fiducials_set(), "tracker fiducials not set"
        trk = self.tracker.tracker_fiducials[:, :3]
        img = self.image.fiducials
        self.m_change = registration.estimate_rigid_transform(trk, img)
        self.fre = registration.calculate_fre(trk, img, self.m_change)
        self.bus.send_message("navigation.registered", fre=self.fre)
        return self.fre

    def register_coil(self, coil_index: int, fiducials, orients, coord_raw) -> None:
        self.obj_datas[coil_index] = registration.object_registration(
            fiducials, orients, coord_raw, self.m_change)

    # -- lifecycle -------------------------------------------------------------
    def start_navigation(self, poll_hz: float = NAV_POLL_HZ) -> None:
        assert self.m_change is not None, "run fiducial registration first"
        assert self.tracker.connected, "tracker not connected"
        data = CoregistrationData(
            m_change=self.m_change,
            obj_datas=self.obj_datas,
            m_icp=self.icp.m_icp if self.icp.use_icp else None,
            use_dynamic_reference=self.use_dynamic_reference,
        )
        extra_queues = []
        if self.tract_params is not None:
            from invesalius3_tpu_torch.navigation.tractography import (
                ComputeTractsThread)

            q = LIFOQueue(maxsize=1)
            self._tract_thread = ComputeTractsThread(
                q, bus=self.bus, **{"device": self.device, **self.tract_params})
            extra_queues.append(q)
        if self.efield_params is not None:
            from invesalius3_tpu_torch.navigation.efield import VisualizeEFieldThread

            q = LIFOQueue(maxsize=1)
            self._efield_thread = VisualizeEFieldThread(
                q, bus=self.bus, **{"device": self.device, **self.efield_params})
            extra_queues.append(q)
        self._coreg = CoordinateCorregistrate(
            self.tracker, data, self.coord_queue, poll_hz,
            extra_queues=tuple(extra_queues))
        self._updater = UpdateNavigationScene(self.coord_queue, self.bus)
        self._coreg.start()
        self._updater.start()
        if self._tract_thread is not None:
            self._tract_thread.start()
        if self._efield_thread is not None:
            self._efield_thread.start()
        self.is_navigating = True
        self.bus.send_message("navigation.started")

    def stop_navigation(self) -> None:
        threads = [th for th in (self._coreg, self._updater, self._tract_thread,
                                 self._efield_thread) if th is not None]
        for th in threads:
            th.stop()
        for th in threads:
            th.join(timeout=5.0)  # no post-stop publishes
        self._coreg = self._updater = None
        self._tract_thread = self._efield_thread = None
        self.is_navigating = False
        self.bus.send_message("navigation.stopped")


class NavigationHub:
    """Composes the navigation domain objects (reference navigation.py:54
    NavigationHub)."""

    def __init__(self, bus=None, device=DEFAULT_DEVICE):
        from invesalius3_tpu_torch.navigation.mep import MEPMapper
        from invesalius3_tpu_torch.navigation.robot import Robots

        self.bus = bus or events.bus
        self.tracker = Tracker()
        self.navigation = Navigation(self.tracker, bus=self.bus, device=device)
        self.markers = MarkersControl(bus=self.bus)
        self.image = self.navigation.image
        self.icp = self.navigation.icp
        self.robots = Robots(bus=self.bus)
        self.mep = MEPMapper()

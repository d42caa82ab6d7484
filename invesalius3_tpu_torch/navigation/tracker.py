"""Tracker abstraction + debug (fake) tracker backends (port of
invesalius3_tpu/navigation/tracker.py; the hardware trackers' drivers are
``navigation/serial_drivers.py``).

Reference: invesalius/data/coordinates.py — per-vendor readers (Polaris,
Optitrack, Polhemus, Claron, Camera, Robot...) polled by a
``ReceiveCoordinates`` thread :759 into a shared ``TrackerCoordinates``
:44; invesalius/navigation/tracker.py ``Tracker`` singleton :40 with
connect/disconnect/fiducial capture; the debug trackers
(``DebugCoordRandom`` coordinates.py:522, DebugTracker*Connection
tracker_connection.py:512-561) are the reference's own hardware-free test
seam and the pattern this build keeps for CI.

Coordinate convention: each probe/sensor pose is a 6-vector
(x, y, z, alpha, beta, gamma) in mm/degrees; ``GetCoordinates`` returns
(coords (n_sensors, 6), markers_flag (3,)) like the reference.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np

TRACKER_DEBUG_RANDOM = "debug_random"
TRACKER_DEBUG_APPROACH = "debug_approach"
TRACKER_POLHEMUS_SERIAL = "polhemus_serial"
TRACKER_POLARIS_NDI = "polaris_ndi"
TRACKER_CAMERA = "camera"
TRACKER_OPTITRACK = "optitrack"     # NatNet streaming (serial_drivers.py)
TRACKER_CLARON = "claron_mtc"       # MicronTracker SDK-surface driver
TRACKERS = [TRACKER_DEBUG_RANDOM, TRACKER_DEBUG_APPROACH,
            TRACKER_POLHEMUS_SERIAL, TRACKER_POLARIS_NDI, TRACKER_CAMERA,
            TRACKER_OPTITRACK, TRACKER_CLARON]


class TrackerConnection:
    """Base connection: vendor SDK boundary.  Real vendor backends plug in
    here; the debug backends generate poses."""

    n_sensors = 3  # probe, reference, coil

    def connect(self) -> bool:
        return True

    def disconnect(self) -> None:
        pass

    def get_coordinates(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class DebugRandomConnection(TrackerConnection):
    """Uniform random walk poses (reference DebugCoordRandom)."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def get_coordinates(self):
        coords = np.zeros((self.n_sensors, 6))
        coords[:, :3] = self._rng.uniform(1, 200, (self.n_sensors, 3))
        coords[:, 3:] = self._rng.uniform(-180.0, 180.0, (self.n_sensors, 3))
        return coords, np.array([True, True, True])


class DebugApproachConnection(TrackerConnection):
    """Poses converging toward a target (reference
    DebugTrackerApproachConnection) — exercises target-mode GUI logic."""

    def __init__(self, target=(100.0, 100.0, 100.0), seed: int = 0):
        self.target = np.asarray(target, float)
        self._pos = np.zeros((self.n_sensors, 3))
        self._rng = np.random.default_rng(seed)

    def get_coordinates(self):
        self._pos += (self.target - self._pos) * 0.05 + self._rng.normal(0, 0.5, self._pos.shape)
        coords = np.zeros((self.n_sensors, 6))
        coords[:, :3] = self._pos
        return coords, np.array([True, True, True])


class CameraConnection(TrackerConnection):
    """Duck-typed external camera tracker (reference coordinates.py:288
    ``CameraCoord`` + tracker_connection.py camera entry): the caller
    injects an object whose ``Run()`` returns (coords, probe_vis, ref_vis,
    coil_vis) — the same seam the reference uses for research camera
    rigs driven from another process."""

    def __init__(self, camera):
        self.camera = camera

    def get_coordinates(self):
        coords, probe_vis, ref_vis, coil_vis = self.camera.Run()
        out = np.zeros((self.n_sensors, 6))
        out[:min(len(coords), self.n_sensors)] = np.asarray(
            coords, float)[:self.n_sensors]
        return out, np.array([bool(probe_vis), bool(ref_vis),
                              bool(coil_vis)])


def create_tracker_connection(tracker_id: str, **kw) -> TrackerConnection:
    """Reference tracker_connection.CreateTrackerConnection :562.  A
    hardware tracker opens its real transport (pyserial, the NatNet socket,
    the pyclaron SDK) only when no ``transport=`` / ``transcript=`` /
    ``frames=`` / ``poses=`` / ``sdk=`` is given."""
    if tracker_id == TRACKER_DEBUG_RANDOM:
        return DebugRandomConnection(**kw)
    if tracker_id == TRACKER_DEBUG_APPROACH:
        return DebugApproachConnection(**kw)
    if tracker_id == TRACKER_POLHEMUS_SERIAL:
        from invesalius3_tpu_torch.navigation.serial_drivers import (
            PolhemusSerialConnection, PySerialTransport, ReplayTransport)

        transport = kw.pop("transport", None)
        if transport is None and "transcript" in kw:
            transport = ReplayTransport(kw.pop("transcript"))
        if transport is None:
            transport = PySerialTransport(kw.pop("com_port"),
                                          kw.pop("baud_rate", 115200))
        return PolhemusSerialConnection(transport, **kw)
    if tracker_id == TRACKER_POLARIS_NDI:
        from invesalius3_tpu_torch.navigation.serial_drivers import (
            NDIPolarisConnection, PySerialTransport, ReplayTransport)

        transport = kw.pop("transport", None)
        if transport is None and "transcript" in kw:
            transport = ReplayTransport(kw.pop("transcript"))
        if transport is None:
            transport = PySerialTransport(kw.pop("com_port"),
                                          kw.pop("baud_rate", 921600))
        return NDIPolarisConnection(transport, **kw)
    if tracker_id == TRACKER_CAMERA:
        return CameraConnection(kw.pop("camera"))
    if tracker_id == TRACKER_OPTITRACK:
        from invesalius3_tpu_torch.navigation.serial_drivers import (
            OptitrackNatNetConnection, ReplayDatagramTransport,
            UDPDatagramTransport)

        transport = kw.pop("transport", None)
        if transport is None and "frames" in kw:
            transport = ReplayDatagramTransport(kw.pop("frames"))
        if transport is None:
            transport = UDPDatagramTransport(kw.pop("port", 1511))
        return OptitrackNatNetConnection(transport, **kw)
    if tracker_id == TRACKER_CLARON:
        from invesalius3_tpu_torch.navigation.serial_drivers import (
            ClaronConnection, ReplayMTC)

        sdk = kw.pop("sdk", None)
        if sdk is None and "poses" in kw:
            sdk = ReplayMTC(kw.pop("poses"))
        if sdk is None:  # the real closed-SDK wrapper, when installed
            import pyclaron  # pragma: no cover

            sdk = pyclaron.pyclaron()
        return ClaronConnection(sdk)
    raise ValueError(
        f"tracker {tracker_id!r} not available in this build (vendor SDKs "
        f"are hardware-gated); available: {TRACKERS}"
    )


class TrackerCoordinates:
    """Thread-shared latest-pose holder (reference coordinates.py:44-136)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._coords = np.zeros((3, 6))
        self._flags = np.array([False, False, False])

    def set_coordinates(self, coords: np.ndarray, flags: np.ndarray) -> None:
        with self._lock:
            self._coords = coords
            self._flags = flags

    def get_coordinates(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            return self._coords.copy(), self._flags.copy()


class ReceiveCoordinates(threading.Thread):
    """Polls the vendor connection at poll_hz into TrackerCoordinates
    (reference coordinates.py:759)."""

    def __init__(self, connection: TrackerConnection, shared: TrackerCoordinates,
                 poll_hz: float = 120.0):
        super().__init__(daemon=True)
        self.connection = connection
        self.shared = shared
        self.period = 1.0 / poll_hz
        self._stop_event = threading.Event()

    def run(self):
        while not self._stop_event.is_set():
            coords, flags = self.connection.get_coordinates()
            self.shared.set_coordinates(coords, flags)
            time.sleep(self.period)

    def stop(self):
        self._stop_event.set()


class Tracker:
    """Tracker lifecycle + fiducial capture (reference
    navigation/tracker.py:40-330)."""

    def __init__(self):
        self.tracker_id: Optional[str] = None
        self.connection: Optional[TrackerConnection] = None
        self.coordinates = TrackerCoordinates()
        self._receiver: Optional[ReceiveCoordinates] = None
        self.tracker_fiducials = np.full((3, 6), np.nan)
        self.connected = False

    def connect(self, tracker_id: str, poll_hz: float = 120.0, **kw) -> bool:
        self.disconnect()
        self.connection = create_tracker_connection(tracker_id, **kw)
        if not self.connection.connect():
            return False
        self.tracker_id = tracker_id
        self._receiver = ReceiveCoordinates(self.connection, self.coordinates, poll_hz)
        self._receiver.start()
        self.connected = True
        return True

    def disconnect(self) -> None:
        if self._receiver is not None:
            self._receiver.stop()
            self._receiver.join(timeout=2.0)
            self._receiver = None
        if self.connection is not None:
            self.connection.disconnect()
            self.connection = None
        self.connected = False
        self.tracker_id = None

    def get_coordinates(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.coordinates.get_coordinates()

    def set_tracker_fiducial(self, index: int) -> None:
        """Capture the probe pose as fiducial ``index`` (reference
        tracker.py:248 SetTrackerFiducial)."""
        coords, _ = self.get_coordinates()
        self.tracker_fiducials[index] = coords[0]

    def are_fiducials_set(self) -> bool:
        return not np.isnan(self.tracker_fiducials).any()

    # session persistence (reference tracker.py:62-111)
    def save_state(self, session) -> None:
        session.set_state("tracker", {
            "tracker_id": self.tracker_id,
            "fiducials": self.tracker_fiducials.tolist(),
        })

    def load_state(self, session) -> bool:
        st = session.get_state("tracker")
        if not st or not st.get("tracker_id"):
            return False
        self.tracker_fiducials = np.asarray(st["fiducials"])
        return self.connect(st["tracker_id"])

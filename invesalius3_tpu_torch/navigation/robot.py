"""Robot control integration (robotized TMS coil positioning; port of
invesalius3_tpu/navigation/robot.py).

Reference: invesalius/navigation/robot.py — per-robot ``Robot`` :41 (IP
connect via the NeuronavigationApi :210, tracker<->robot matrix
registration :165, ``SendTargetToRobot`` :254 transforming the image-space
target into tracker space via coregistration.image_to_tracker, objectives
enum :34, free-drive :399) and the ``Robots`` registry singleton :414.

The robot hardware link rides the duck-typed NeuronavigationApi
connection; with no connection attached every call is a no-op that still
updates local state (the reference behaves the same headless).
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, Optional

import numpy as np

from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.navigation.coregistration import image_to_tracker, matrix_to_pose


class RobotObjective(Enum):
    NONE = 0
    TRACK_TARGET = 1
    MOVE_AWAY_FROM_HEAD = 2


class Robot:
    def __init__(self, robot_id: str = "robot0", api=None, bus=None):
        self.robot_id = robot_id
        self.api = api
        self.bus = bus or events.bus
        self.ip: Optional[str] = None
        self.connected = False
        self.m_tracker_to_robot: Optional[np.ndarray] = None
        self.objective = RobotObjective.NONE
        self.target_tracker: Optional[np.ndarray] = None
        self.force: float = 0.0

    def connect(self, ip: str) -> bool:
        self.ip = ip
        if self.api is not None:
            self.api.connect_robot(self.robot_id, ip)
        self.connected = True
        self.bus.send_message("robot.connected", robot_id=self.robot_id, ip=ip)
        return True

    def register_tracker_to_robot(self, m: np.ndarray) -> None:
        self.m_tracker_to_robot = np.asarray(m)
        self.bus.send_message("robot.registered", robot_id=self.robot_id)

    def set_objective(self, objective: RobotObjective) -> None:
        self.objective = objective
        if self.api is not None:
            self.api.set_robot_objective(self.robot_id, objective.value)
        self.bus.send_message("robot.objective", robot_id=self.robot_id,
                              objective=objective.name)

    def send_target(self, navigation, target_pose_img: np.ndarray) -> np.ndarray:
        """Transform the image-space target into tracker space and send it
        (reference robot.py:254 SendTargetToRobot)."""
        coords, _ = navigation.tracker.get_coordinates()
        ref_pose = coords[1] if navigation.use_dynamic_reference else None
        m_target_trk = image_to_tracker(
            navigation.m_change, target_pose_img, ref_pose,
            navigation.icp.m_icp if navigation.icp.use_icp else None)
        self.target_tracker = m_target_trk
        if self.api is not None:
            self.api.set_robot_target(self.robot_id, matrix_to_pose(m_target_trk).tolist())
        self.bus.send_message("robot.target_sent", robot_id=self.robot_id)
        return m_target_trk

    def set_free_drive(self, enabled: bool) -> None:
        if self.api is not None:
            self.api.set_robot_free_drive(self.robot_id, enabled)
        self.bus.send_message("robot.free_drive", robot_id=self.robot_id, enabled=enabled)

    def on_force_update(self, force: float) -> None:
        self.force = force
        self.bus.send_message("robot.force", robot_id=self.robot_id, force=force)


class Robots:
    """Registry (reference robot.py:414)."""

    def __init__(self, api=None, bus=None):
        self.api = api
        self.bus = bus or events.bus
        self._robots: Dict[str, Robot] = {}

    def get(self, robot_id: str = "robot0") -> Robot:
        if robot_id not in self._robots:
            self._robots[robot_id] = Robot(robot_id, api=self.api, bus=self.bus)
        return self._robots[robot_id]

    def all(self):
        return list(self._robots.values())

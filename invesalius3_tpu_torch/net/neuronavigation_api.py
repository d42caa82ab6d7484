"""NeuronavigationApi: the duck-typed boundary to an external process
(robot controller, e-field solver, MEP recorder; port of
invesalius3_tpu/net/neuronavigation_api.py).

Reference: invesalius/net/neuronavigation_api.py :29 — wraps an injected
``connection`` object (the reference gets it from ``app.main(connection=)``,
app.py:682-699): outbound update_coil_pose / update_efield* / set_target;
inbound callbacks (robot pose, stimulation pulses) registered on the
connection.  With connection=None everything is a silent no-op, exactly
like the reference headless.
"""

from __future__ import annotations

from invesalius3_tpu_torch import events


class NeuronavigationApi:
    def __init__(self, connection=None, bus=None):
        self.connection = connection
        self.bus = bus or events.bus
        if connection is not None:
            self._set_callbacks(connection)

    # -- outbound ---------------------------------------------------------------
    def _send(self, method: str, *args, **kw):
        if self.connection is None:
            return None
        fn = getattr(self.connection, method, None)
        if fn is None:
            return None
        return fn(*args, **kw)

    def update_coil_pose(self, position, orientation) -> None:
        self._send("update_coil_pose", position=position, orientation=orientation)

    def update_probe_pose(self, position, orientation) -> None:
        self._send("update_probe_pose", position=position, orientation=orientation)

    def update_focus(self, position) -> None:
        self._send("update_focus", position=position)

    def set_target(self, target) -> None:
        self._send("set_target", target=target)

    def unset_target(self) -> None:
        self._send("unset_target")

    def update_efield_vector_roi_max(self, position, orientation, t_rot, id_list):
        """Ask the external solver for e-field norms over ROI ids
        (reference neuronavigation_api.py:276-298)."""
        return self._send(
            "update_efield_vectorROIMax", position=position,
            orientation=orientation, T_rot=t_rot, id_list=id_list)

    # robot plumbing used by navigation.robot
    def connect_robot(self, robot_id, ip):
        self._send("connect_to_robot", robot_id=robot_id, ip=ip)

    def set_robot_objective(self, robot_id, objective):
        self._send("set_objective", robot_id=robot_id, objective=objective)

    def set_robot_target(self, robot_id, target):
        self._send("update_robot_target", robot_id=robot_id, target=target)

    def set_robot_free_drive(self, robot_id, enabled):
        self._send("set_free_drive", robot_id=robot_id, enabled=enabled)

    # -- inbound ---------------------------------------------------------------
    def _set_callbacks(self, connection) -> None:
        """Register inbound callbacks (reference __set_callbacks :301)."""
        if hasattr(connection, "set_callback__robot_pose"):
            connection.set_callback__robot_pose(self._on_robot_pose)
        if hasattr(connection, "set_callback__stimulation_pulse"):
            connection.set_callback__stimulation_pulse(self._on_stimulation_pulse)

    def _on_robot_pose(self, pose) -> None:
        self.bus.send_message("robot.pose_received", pose=pose)

    def _on_stimulation_pulse(self, **kw) -> None:
        self.bus.send_message("navigation.stimulation_pulse_received", **kw)

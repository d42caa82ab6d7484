"""The port's remote control, event server, NeuronavigationApi and TTL port
(``net/{remote_control,remote_server,neuronavigation_api}.py``,
``navigation/serial_port.py``) on the JAX package's cases
(tests/test_navigation.py: the mirror, the event-server round trip, the
robot target through the API; tests/test_editor_ops.py: the TTL fake port),
and against the JAX package: the JSON lines mirrored for one scripted bus
sequence (slice, masks, markers, measures, navigation poses, robot, API
callbacks, TTL) are equal line for line, and no payload of the port's
sequence is a tensor.  Every wait is on a condition with a timeout; every
socket, server and thread is closed, stopped or joined."""

import io
import json
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from invesalius3_tpu import events as events_jax
from invesalius3_tpu.core.mask import Mask as MaskJax
from invesalius3_tpu.core.measures import MeasurementManager as MeasuresJax
from invesalius3_tpu.core.slice import Slice as SliceJax
from invesalius3_tpu.core.volume import Volume as VolumeJax
from invesalius3_tpu.navigation import coregistration as coreg_jax
from invesalius3_tpu.navigation import markers as markers_jax
from invesalius3_tpu.navigation import robot as robot_jax
from invesalius3_tpu.navigation import serial_port as serial_port_jax
from invesalius3_tpu.net import neuronavigation_api as api_jax
from invesalius3_tpu.net import remote_control as rc_jax
from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.core.measures import MeasurementManager
from invesalius3_tpu_torch.core.slice import Slice
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.navigation import coregistration as coreg
from invesalius3_tpu_torch.navigation import efield
from invesalius3_tpu_torch.navigation import markers
from invesalius3_tpu_torch.navigation import robot
from invesalius3_tpu_torch.navigation import serial_port
from invesalius3_tpu_torch.navigation.navigation import Navigation
from invesalius3_tpu_torch.navigation.tracker import TRACKER_DEBUG_RANDOM
from invesalius3_tpu_torch.net import neuronavigation_api as api
from invesalius3_tpu_torch.net import remote_control as rc
from invesalius3_tpu_torch.net import remote_server
from invesalius3_tpu_torch.net.remote_server import RemoteEventServer

torch.set_num_threads(1)


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.01)
    return cond()


class _LineServer:
    """Accepts one connection on 127.0.0.1 and keeps every byte it reads;
    ``lines`` once the peer has closed."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.settimeout(10.0)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.data = bytearray()
        self.conn = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        self.conn, _ = self.sock.accept()
        self.conn.settimeout(10.0)
        while chunk := self.conn.recv(65536):
            self.data += chunk

    def lines(self):
        self._thread.join(timeout=10.0)
        assert not self._thread.is_alive()
        self.conn.close()
        self.sock.close()
        return bytes(self.data).split(b"\n")[:-1]


# -- the JAX package's cases ----------------------------------------------------------------

def test_remote_control_mirror():
    """Internal events mirror out; inbound lines re-publish internally."""
    srv = socket.socket()
    srv.settimeout(10.0)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    received, served = [], threading.Event()

    def server():
        conn, _ = srv.accept()
        with conn:
            conn.settimeout(10.0)
            buf = b""
            while b"\n" not in buf:
                buf += conn.recv(4096)
            received.append(json.loads(buf.split(b"\n")[0]))
            conn.sendall(json.dumps({"topic": "remote.ping", "data": {"x": 1}}).encode() + b"\n")
            served.wait(10.0)

    th = threading.Thread(target=server, daemon=True)
    th.start()
    bus = events.Publisher()
    ctl = rc.RemoteControl("127.0.0.1", srv.getsockname()[1], bus=bus)
    inbound = []
    bus.subscribe(lambda **kw: inbound.append(kw), "remote.ping")
    try:
        ctl.connect()
        bus.send_message("test.topic", value=42)
        assert _wait(lambda: inbound)
    finally:
        served.set()
        ctl.disconnect()
        th.join(timeout=10.0)
        srv.close()
    assert not th.is_alive()
    assert received and received[0] == {"topic": "test.topic", "data": {"value": 42}}
    assert inbound == [{"x": 1}]
    assert bus._hook is None


def test_remote_event_server_roundtrip():
    srv = RemoteEventServer().start()
    bus = events.Publisher()
    ctl = rc.RemoteControl("127.0.0.1", srv.port, bus=bus)
    got = []
    try:
        assert ctl.connect(timeout=5.0)
        bus.subscribe(lambda **kw: got.append(kw), "remote.cmd")
        bus.send_message("markers.added", index=3, value=1.5)
        assert _wait(lambda: srv.received)
        assert srv.received[0] == {"topic": "markers.added", "data": {"index": 3, "value": 1.5}}
        assert _wait(lambda: srv._clients)
        assert srv.send("remote.cmd", action="go") == 1
        assert _wait(lambda: got)
        assert got[0] == {"action": "go"}
    finally:
        ctl.disconnect()
        srv.stop()
    assert srv.send("remote.cmd", action="late") in (0, 1)


def test_mirror_outlives_a_quiet_controller():
    """A controller that sends nothing for longer than the connect timeout
    still receives the app's events (the JAX module's reader stops the
    mirror then; the port's keeps listening)."""
    srv = RemoteEventServer().start()
    bus = events.Publisher()
    ctl = rc.RemoteControl("127.0.0.1", srv.port, bus=bus)
    try:
        ctl.connect(timeout=0.1)
        time.sleep(0.35)
        bus.send_message("after.quiet", n=1)
        assert _wait(lambda: srv.received, timeout=10.0)
    finally:
        ctl.disconnect()
        srv.stop()
    assert srv.received == [{"topic": "after.quiet", "data": {"n": 1}}]


def test_disconnect_joins_the_reader():
    srv = RemoteEventServer().start()
    ctl = rc.RemoteControl("127.0.0.1", srv.port, bus=events.Publisher())
    try:
        ctl.connect(timeout=30.0)
        reader = ctl._reader
    finally:
        ctl.disconnect()
        srv.stop()
    assert not reader.is_alive() and ctl._sock is None


def test_remote_server_main_reads_stdin(monkeypatch, capsys):
    """``python -m invesalius3_tpu_torch.net.remote_server PORT``: lines of
    ``topic {json}`` on stdin go to every client; a bad payload is reported."""
    bus = events.Publisher()
    got, started = [], {}
    real = RemoteEventServer.start

    def start(self):
        started["srv"] = self
        return real(self)

    monkeypatch.setattr(RemoteEventServer, "start", start)

    class Stdin(io.StringIO):
        def __iter__(self):
            assert _wait(lambda: "srv" in started)
            ctl = rc.RemoteControl("127.0.0.1", started["srv"].port, bus=bus)
            ctl.connect()
            started["ctl"] = ctl
            assert _wait(lambda: started["srv"]._clients)
            yield "remote.go {\"x\": 2}\n"
            yield "\n"
            yield "remote.bad {not json\n"
            assert _wait(lambda: got)

    bus.subscribe(lambda **kw: got.append(kw), "remote.go")
    monkeypatch.setattr(sys, "stdin", Stdin())
    try:
        assert remote_server.main(["0"]) == 0
    finally:
        if "ctl" in started:
            started["ctl"].disconnect()
    out = capsys.readouterr().out
    assert got == [{"x": 2}]
    assert "sent to 1 client(s)" in out and "bad JSON payload" in out


def test_jsonable_host_values_and_tensors():
    """Host data converts as in the JAX package; a tensor goes out as its
    ``repr`` (the JAX package's rule for anything else)."""
    payload = {"a": np.arange(3), "b": (np.float32(1.5), np.int64(2), np.bool_(True)),
               "c": [None, "s", 3, 2.5, {"d": np.eye(2)}]}
    assert rc._jsonable(payload) == rc_jax._jsonable(payload)
    t = torch.arange(3)
    assert rc._jsonable({"t": t}) == {"t": repr(t)}


def test_robot_target_flow():
    """The robot's target goes out through the real NeuronavigationApi."""
    bus = events.Publisher()
    nav = Navigation(bus=bus, device="cpu")
    calls = []

    class FakeConnection:
        def update_robot_target(self, robot_id, target):
            calls.append((robot_id, target))

    try:
        nav.tracker.connect(TRACKER_DEBUG_RANDOM, poll_hz=500)
        assert _wait(lambda: nav.tracker.get_coordinates()[0].any())
        nav.m_change = np.eye(4)
        nav.use_dynamic_reference = False
        r = robot.Robot("r0", api=api.NeuronavigationApi(connection=FakeConnection(), bus=bus),
                        bus=bus)
        r.set_objective(robot.RobotObjective.TRACK_TARGET)
        m_trk = r.send_target(nav, np.array([10.0, 20.0, 30.0, 0.0, 0.0, 0.0]))
    finally:
        nav.tracker.disconnect()
    assert calls and calls[0][0] == "r0"
    np.testing.assert_allclose(m_trk[:3, 3], [10, 20, 30], atol=1e-9)
    np.testing.assert_allclose(calls[0][1][:3], [10, 20, 30], atol=1e-9)


def test_api_outbound_calls_and_callbacks():
    """Every outbound call reaches the connection under its reference name;
    a missing method or connection is a no-op; the two inbound callbacks
    post on the bus; the e-field worker asks through the API."""
    calls, cbs = [], {}

    class Conn:
        def __getattr__(self, name):
            if name.startswith("set_callback__"):
                return lambda fn: cbs.__setitem__(name, fn)
            if name == "update_efield_vectorROIMax":
                return lambda **kw: (calls.append((name, kw)), [1.0, 4.0, 2.0])[1]
            return lambda *a, **kw: calls.append((name, kw))

    bus = events.Publisher()
    seen = []
    for topic in ("robot.pose_received", "navigation.stimulation_pulse_received"):
        bus.subscribe(events.wants_topic(lambda topic=None, **kw: seen.append((topic, kw))),
                      topic)
    a = api.NeuronavigationApi(connection=Conn(), bus=bus)
    a.update_coil_pose([1, 2, 3], [0, 0, 1])
    a.update_probe_pose([4, 5, 6], [0, 1, 0])
    a.update_focus([7, 8, 9])
    a.set_target([1, 1, 1])
    a.unset_target()
    a.connect_robot("r", "10.0.0.1")
    a.set_robot_objective("r", 1)
    a.set_robot_target("r", [0] * 6)
    a.set_robot_free_drive("r", True)
    assert [c[0] for c in calls] == [
        "update_coil_pose", "update_probe_pose", "update_focus", "set_target", "unset_target",
        "connect_to_robot", "set_objective", "update_robot_target", "set_free_drive"]
    assert calls[5][1] == {"robot_id": "r", "ip": "10.0.0.1"}
    cbs["set_callback__robot_pose"]([1, 2, 3])
    cbs["set_callback__stimulation_pulse"](intensity=50)
    assert seen == [("robot.pose_received", {"pose": [1, 2, 3]}),
                    ("navigation.stimulation_pulse_received", {"intensity": 50})]
    th = efield.VisualizeEFieldThread(None, api=a, roi_ids=np.arange(3), bus=bus, device="cpu")
    m = np.eye(4)
    m[:3, 3] = [1, 2, 3]
    assert th.compute_once({"coils_img": {0: m}}).tolist() == [1.0, 4.0, 2.0]
    assert calls[-1][1]["position"] == [1.0, 2.0, 3.0] and calls[-1][1]["id_list"].tolist() \
        == [0, 1, 2]
    silent = api.NeuronavigationApi(bus=bus)
    assert silent.update_efield_vector_roi_max([0] * 3, [0] * 3, np.eye(3), [0]) is None
    assert api.NeuronavigationApi(connection=object(), bus=bus).set_target([1]) is None


class _FakePort:
    def __init__(self, data=(b"", b"\x01")):
        self.rts, self.data, self.closed = [], list(data), False

    def setRTS(self, v):
        self.rts.append(v)

    def read(self, n):
        return self.data.pop(0) if self.data else b""

    def close(self):
        self.closed = True


def test_serial_port_fake():
    bus = events.Publisher()
    got = []
    bus.subscribe(lambda **kw: got.append("pulse"), "serial.pulse_sent")
    bus.subscribe(lambda **kw: got.append("trig"), "serial.trigger_received")
    port = _FakePort()
    conn = serial_port.SerialPortConnection(serial_port=port, bus=bus, poll_hz=200)
    conn.start()
    try:
        conn.send_pulse()
        assert _wait(lambda: "trig" in got)
    finally:
        conn.stop()
        conn.join(timeout=5.0)
    assert not conn.is_alive() and port.closed
    assert "pulse" in got and "trig" in got and port.rts == [True, False]


def test_serial_port_needs_pyserial():
    with pytest.raises(RuntimeError, match="pyserial"):
        serial_port.SerialPortConnection(port="/dev/ttyS0", bus=events.Publisher())
    with pytest.raises(RuntimeError, match="pyserial"):
        serial_port_jax.SerialPortConnection(port="/dev/ttyS0", bus=events_jax.Publisher())


# -- one scripted bus sequence through both packages' mirrors ------------------------------

class _FakeTracker:
    def get_coordinates(self):
        coords = np.array([[10.0, 20.0, 30.0, 5.0, -10.0, 15.0],
                           [1.0, -2.0, 0.5, 1.0, 2.0, 3.0],
                           [12.0, 18.0, 31.0, 4.0, -9.0, 14.0]])
        return coords, np.array([True, True, False])


def _script(pkg, monkeypatch, tensors=None):
    """The JSON lines one package's RemoteControl mirrors for the same
    sequence of bus messages."""
    (events_, Slice_, Volume_, Mask_, markers_, Measures_, coreg_, robot_, api_, serial_,
     rc_, host) = pkg
    monkeypatch.setattr(Mask_, "general_index", -1)
    bus = events_.Publisher()
    srv = _LineServer()
    ctl = rc_.RemoteControl("127.0.0.1", srv.port, bus=bus)
    ctl.connect()
    if tensors is not None:  # every leaf of every payload, as sent
        hook = bus._hook

        def scan(topic, kw):
            stack = [kw]
            while stack:
                v = stack.pop()
                if isinstance(v, dict):
                    stack.extend(v.values())
                elif isinstance(v, (list, tuple)):
                    stack.extend(v)
                elif isinstance(v, torch.Tensor):
                    tensors.append(topic)
            hook(topic, kw)

        bus.add_send_message_hook(scan)
    try:
        ct = np.full((8, 12, 12), -1000, np.int16)
        ct[2:6, 3:9, 3:9] = 1200
        slc = Slice_(host(Volume_, ct), bus=bus)
        slc.set_window(400.0, 40.0)
        m = slc.create_new_mask(threshold_range=(226, 3071))
        slc.select_mask(m.index)
        slc.set_mask_threshold(300, 2000)
        mc = markers_.MarkersControl(bus=bus)
        t = mc.add(markers_.Marker(marker_type=markers_.MarkerType.COIL_TARGET,
                                   position=(1.0, 2.0, 3.0), orientation=(0.0, 10.0, 20.0),
                                   label="T1", z_rotation=5.0))
        mc.set_target(t.marker_id)
        mc.unset_target()
        mc.delete(t.marker_id)
        mm = Measures_(bus=bus)
        mm.add_linear([0.0, 0.0, 0.0], [3.0, 4.0, 12.0])
        mm.add_angular([1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
        m_change = np.eye(4)
        m_change[:3, 3] = [1.0, -2.0, 3.0]
        loop = coreg_.CoordinateCorregistrate(
            _FakeTracker(), coreg_.CoregistrationData(m_change=m_change), None)
        item = loop.compute_once()
        item["timestamp"] = 12.5
        bus.send_message("navigation.update_scene", **item)
        bus.send_message("navigation.update_slices", position=item["probe_pose_img"][:3])
        r = robot_.Robot("r0", bus=bus)
        r.connect("10.0.0.9")
        r.set_objective(robot_.RobotObjective.TRACK_TARGET)
        r.set_free_drive(True)
        r.on_force_update(2.5)
        cbs = {}

        class Conn:
            def set_callback__robot_pose(self, fn):
                cbs["pose"] = fn

            def set_callback__stimulation_pulse(self, fn):
                cbs["pulse"] = fn

        api_.NeuronavigationApi(connection=Conn(), bus=bus)
        cbs["pose"]([1.0, 2.0, 3.0, 0.0, 0.0, 90.0])
        cbs["pulse"](intensity=55, timestamp=3.0)
        serial_.SerialPortConnection(serial_port=_FakePort(), bus=bus).send_pulse()
    finally:
        ctl.disconnect()
    return srv.lines()


_PORT = (events, Slice, Volume, Mask, markers, MeasurementManager, coreg, robot, api,
         serial_port, rc, lambda V, ct: V.from_numpy(ct, spacing=(0.5, 0.5, 1.0), device="cpu"))
_JAX = (events_jax, SliceJax, VolumeJax, MaskJax, markers_jax, MeasuresJax, coreg_jax,
        robot_jax, api_jax, serial_port_jax, rc_jax,
        lambda V, ct: V.from_numpy(ct, spacing=(0.5, 0.5, 1.0)))


def test_mirrored_lines_equal_jax(monkeypatch):
    tensors = []
    got = _script(_PORT, monkeypatch, tensors)
    want = _script(_JAX, monkeypatch)
    topics = [json.loads(line)["topic"] for line in got]
    assert {"slice.volume_set", "slice.mask_added", "markers.added", "measures.added",
            "navigation.update_scene", "robot.pose_received", "serial.pulse_sent"} <= set(topics)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a == b
    assert tensors == []

"""The port's hardware tracker drivers (``navigation/serial_drivers.py``), its
pose converters (``navigation/vendor_coords.py``) and the tracker factory's
four hardware branches, on the JAX package's cases
(tests/test_navigation.py: the vendor converters, the Polhemus and Polaris
replays, OptiTrack NatNet and the Claron SDK surface), and against the JAX
modules: the same transcript through both drivers gives identical
coordinate and flag sequences (exact), and the NDI CRC, framing and the
transcript makers are byte-equal on hypothesis-drawn inputs.  pyserial and
pyclaron are absent: opening a real port raises an ImportError naming the
module, as in the JAX package.  Threads are waited on by condition, with a
timeout, and joined."""

import struct
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from invesalius3_tpu.navigation import serial_drivers as sd_jax
from invesalius3_tpu.navigation import tracker as tracker_jax
from invesalius3_tpu.navigation import vendor_coords as vc_jax
from invesalius3_tpu_torch.navigation import serial_drivers as sd
from invesalius3_tpu_torch.navigation import tracker as trk
from invesalius3_tpu_torch.navigation import vendor_coords as vc
from invesalius3_tpu_torch.navigation.tracker import (
    TRACKER_CLARON, TRACKER_OPTITRACK, TRACKER_POLARIS_NDI, TRACKER_POLHEMUS_SERIAL, Tracker)
from invesalius3_tpu_torch.ops import transforms as tr

import chip_smoke


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.01)
    return cond()


# -- vendor pose converters (JAX tests/test_navigation.py:446-500) --------------------

def test_quaternion_pose_roundtrip():
    a, b, g = np.radians([30.0, -40.0, 75.0])
    q = tr.quaternion_from_matrix(tr.euler_matrix(a, b, g, axes="rzyx"))
    pose = vc.quaternion_pose(q, [10.0, -5.0, 2.5])
    np.testing.assert_allclose(pose[:3], [10.0, -5.0, 2.5])
    np.testing.assert_allclose(pose[3:], [30.0, -40.0, 75.0], atol=1e-6)
    np.testing.assert_array_equal(pose, vc_jax.quaternion_pose(q, [10.0, -5.0, 2.5]))


def test_parse_polaris_p4():
    assert vc.parse_polaris_p4("01MISSING_WHATEVER") is None
    rec = "01" + "+10000" + "+00000" + "+00000" + "+00000" + \
          "+001234" + "-000500" + "+000007"
    pose = vc.parse_polaris_p4(rec)
    np.testing.assert_allclose(pose[:3], [12.34, -5.0, 0.07])
    np.testing.assert_allclose(pose[3:], [0, 0, 0], atol=1e-9)
    np.testing.assert_array_equal(pose, vc_jax.parse_polaris_p4(rec))


def test_optitrack_pose_permutation():
    pose = vc.optitrack_pose(1, 0, 0, 0, 0.1, 0.2, 0.3)
    np.testing.assert_allclose(pose[:3], [300.0, 100.0, 200.0])
    np.testing.assert_allclose(pose[3:], [0, 0, 0], atol=1e-9)


def test_polhemus_conversions():
    p = vc.polhemus_usb_pose([1.0, 2.0, 3.0, 10.0, 20.0, 30.0], True)
    np.testing.assert_allclose(p, [10.0, 20.0, -30.0, 10.0, 20.0, 30.0])
    p = vc.polhemus_usb_pose([1.0, 0, 0, 0, 0, 0], False)
    np.testing.assert_allclose(p[0], 25.4)
    p = vc.parse_polhemus_serial(b"1 1.5-2.5 3.0 10.0 0.0 0.0")
    np.testing.assert_allclose(p, [15.0, -25.0, 30.0, 10.0, 0.0, 0.0])
    np.testing.assert_array_equal(vc.polhemus_wrapper_pose([1, 2, 3, 4, 5, 6]),
                                  vc_jax.polhemus_wrapper_pose([1, 2, 3, 4, 5, 6]))
    np.testing.assert_array_equal(vc.claron_pose(1, 2, 3, 4, 5, 6), [1, 2, 3, 4, 5, 6])


def test_polhemus_dynamic_pose_identity_reference():
    out = vc.polhemus_dynamic_pose(np.array([10.0, 5.0, 2.0, 1.0, 2.0, 3.0]), np.zeros(6))
    np.testing.assert_allclose(out, [10.0, 5.0, -2.0, 1.0, 2.0, 3.0])


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(-180, 180), min_size=12, max_size=12))
def test_vendor_converters_equal_jax(v):
    probe, ref = np.array(v[:6]), np.array(v[6:])
    np.testing.assert_array_equal(vc.polhemus_dynamic_pose(probe, ref),
                                  vc_jax.polhemus_dynamic_pose(probe, ref))
    q = tr.quaternion_from_matrix(tr.euler_matrix(*np.radians(v[:3]), axes="rzyx"))
    np.testing.assert_array_equal(vc.quaternion_pose(q, v[3:6]),
                                  vc_jax.quaternion_pose(q, v[3:6]))
    np.testing.assert_array_equal(vc.optitrack_pose(*q, *v[6:9]),
                                  vc_jax.optitrack_pose(*q, *v[6:9]))
    np.testing.assert_array_equal(vc.polhemus_usb_pose(v[:6], v[0] > 0),
                                  vc_jax.polhemus_usb_pose(v[:6], v[0] > 0))


# -- Polhemus serial (JAX :551-607) ------------------------------------------------------

def test_polhemus_serial_replay_protocol():
    poses = [((2.54, -3.10, 10.0, 15.0, -20.0, 30.0), (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)),
             ((3.54, -2.10, 11.0, 16.0, -21.0, 31.0), (1.0, -1.0, 0.5, 5.0, 0.0, 0.0))]
    tp = sd.ReplayTransport(sd.make_isotrak_transcript(poses), loop=False)
    conn = sd.PolhemusSerialConnection(tp, model="isotrak", ref_mode=True)
    assert conn.connect()
    coords, flags = conn.get_coordinates()
    assert flags[0] and flags[1] and not flags[2]
    np.testing.assert_allclose(coords[0, :3], [25.4, -31.0, -100.0])
    np.testing.assert_allclose(coords[0, 3:], [15.0, -20.0, 30.0])
    coords2, _ = conn.get_coordinates()
    assert coords2[1, 0] == 10.0
    assert not np.allclose(coords2[0], coords[0])
    with pytest.raises(EOFError):
        conn.get_coordinates()


def test_polhemus_protocol_mismatch_detected():
    transcript = sd.make_isotrak_transcript([((1, 2, 3, 0, 0, 0), (0, 0, 0, 0, 0, 0))],
                                            model="fastrak")
    conn = sd.PolhemusSerialConnection(sd.ReplayTransport(transcript), model="isotrak")
    with pytest.raises(AssertionError):
        conn.connect()
    with pytest.raises(ValueError):
        sd.PolhemusSerialConnection(sd.ReplayTransport(transcript), model="liberty")


def test_polhemus_negative_field_abutting():
    pose = vc.parse_polhemus_serial(b"1 2.54-3.10 10.00 15.00-20.00 30.00\r\n")
    np.testing.assert_allclose(pose, [25.4, -31.0, 100.0, 15.0, -20.0, 30.0])


def test_navigation_pipeline_on_replayed_capture():
    """The poll thread -> shared coords -> fiducials on a replayed capture."""
    poses = [((float(i), float(-i), 10.0 + i, 0.0, 0.0, 0.0), (0.0,) * 6) for i in range(1, 9)]
    t = Tracker()
    try:
        assert t.connect(TRACKER_POLHEMUS_SERIAL, poll_hz=500,
                         transcript=sd.make_isotrak_transcript(poses))
        assert _wait(lambda: t.get_coordinates()[1][0])
        coords, flags = t.get_coordinates()
        assert coords[0, 0] in [p[0][0] * 10.0 for p in poses] and coords[0, 2] < 0
        for i in range(3):
            t.set_tracker_fiducial(i)
        assert t.are_fiducials_set()
    finally:
        receiver = t._receiver
        t.disconnect()
    assert not t.connected and not receiver.is_alive()


# -- NDI Polaris (JAX :614-705) ----------------------------------------------------------

def _polaris_frames():
    ident, yaw90 = (1.0, 0.0, 0.0, 0.0), (0.7071, 0.0, 0.0, 0.7071)
    return [[(ident, (10.0, -20.0, 30.0)), (ident, (0.0, 0.0, 0.0)), (yaw90, (5.0, 5.0, 5.0))],
            [(ident, (11.0, -21.0, 31.0)), None, (yaw90, (6.0, 6.0, 6.0))]]


def test_polaris_ndi_replay_protocol():
    tp = sd.ReplayTransport(sd.make_polaris_transcript(_polaris_frames()), loop=False)
    conn = sd.NDIPolarisConnection(tp)
    assert conn.connect() and conn.handles == ["0A", "0B", "0C"]
    coords, flags = conn.get_coordinates()
    assert flags.tolist() == [True, True, True]
    np.testing.assert_allclose(coords[0], [10.0, -20.0, 30.0, 0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(coords[2, :3], [5.0, 5.0, 5.0])
    np.testing.assert_allclose(coords[2, 3], 90.0, atol=0.1)
    coords2, flags2 = conn.get_coordinates()
    assert flags2.tolist() == [True, False, True]
    np.testing.assert_allclose(coords2[1], np.zeros(6))
    np.testing.assert_allclose(coords2[0, :3], [11.0, -21.0, 31.0])


def test_polaris_rom_tool_definition_upload():
    roms = [bytes(range(256)) * 3, b"\x55" * 100, b"\xAA" * 64]
    tp = sd.ReplayTransport(sd.make_polaris_transcript(_polaris_frames(), rom_files=roms),
                            loop=False)
    conn = sd.NDIPolarisConnection(tp, rom_files=roms)
    assert conn.connect() and conn.handles == ["0A", "0B", "0C"]
    coords, flags = conn.get_coordinates()
    assert flags.tolist() == [True, True, True]
    np.testing.assert_allclose(coords[0, :3], [10.0, -20.0, 30.0])


def test_polaris_rom_from_file(tmp_path):
    rom = tmp_path / "probe.rom"
    rom.write_bytes(b"\x01\x02" * 40)
    frames = [f[:1] for f in _polaris_frames()]
    conn = sd.NDIPolarisConnection(sd.ReplayTransport(sd.make_polaris_transcript(
        frames, rom_files=[rom.read_bytes()]), loop=False), rom_files=[rom])
    assert conn.connect() and conn.handles == ["0A"]


def test_polaris_reply_crc_verified():
    transcript = sd.make_polaris_transcript(_polaris_frames())
    okay = bytes.fromhex(transcript[0]["lines"][0])
    transcript[0]["lines"][0] = (b"OKAX" + okay[4:]).hex()
    with pytest.raises(AssertionError):
        sd.NDIPolarisConnection(sd.ReplayTransport(transcript)).connect()


def test_polaris_device_error_raised():
    transcript = sd.make_polaris_transcript(_polaris_frames())
    body = b"ERROR01"
    transcript[0]["lines"][0] = (body + f"{sd.crc16_ndi(body):04X}".encode() + b"\r").hex()
    with pytest.raises(sd.NDIProtocolError, match="device error 01"):
        sd.NDIPolarisConnection(sd.ReplayTransport(transcript)).connect()


def test_polaris_via_tracker_factory():
    t = Tracker()
    try:
        assert t.connect(TRACKER_POLARIS_NDI, poll_hz=500,
                         transcript=sd.make_polaris_transcript(_polaris_frames()))
        assert _wait(lambda: t.get_coordinates()[1][0])
        coords, _ = t.get_coordinates()
        assert coords[0, 0] in (10.0, 11.0)
    finally:
        t.disconnect()


# -- OptiTrack NatNet and Claron (JAX :840-892) -------------------------------------------

def _natnet_bodies():
    return [{"id": 1, "pos": (0.10, 0.02, -0.05), "quat": (0.0, 0.0, 0.0, 1.0), "tracked": True},
            {"id": 2, "pos": (0.0, 0.0, 0.0), "quat": (0.0, 0.7071068, 0.0, 0.7071068),
             "tracked": True},
            {"id": 3, "pos": (0.01, 0.01, 0.01), "quat": (0.0, 0.0, 0.0, 1.0),
             "tracked": False}]


def test_optitrack_natnet_replay():
    frame = sd.make_natnet_frame(_natnet_bodies())
    parsed = sd.parse_natnet_frame(frame)
    assert [b["id"] for b in parsed] == [1, 2, 3]
    assert parsed[0]["tracked"] and not parsed[2]["tracked"]
    conn = trk.create_tracker_connection(TRACKER_OPTITRACK, frames=[frame])
    assert conn.connect()
    coords, flags = conn.get_coordinates()
    assert list(flags) == [True, True, False]
    np.testing.assert_allclose(coords[0], vc.optitrack_pose(1.0, 0.0, 0.0, 0.0, 0.10, 0.02,
                                                            -0.05), atol=1e-5)
    np.testing.assert_allclose(coords[0][:3], [-50.0, 100.0, 20.0], atol=1e-3)
    conn.disconnect()


def test_natnet_frame_with_marker_sets_and_bad_id():
    """Marker sets and unlabeled markers are skipped over; another packet
    type is refused."""
    body = struct.pack("<i", 5) + struct.pack("<i", 1) + b"set\x00" + struct.pack("<i", 2) \
        + b"\x00" * 24 + struct.pack("<i", 1) + b"\x00" * 12 + struct.pack("<i", 1) \
        + struct.pack("<ifffffff", 4, 1, 2, 3, 0, 0, 0, 1) + struct.pack("<fh", 0.5, 1)
    frame = struct.pack("<HH", sd.NATNET_FRAME_OF_DATA, len(body)) + body
    assert sd.parse_natnet_frame(frame) == sd_jax.parse_natnet_frame(frame)
    assert sd.parse_natnet_frame(frame)[0]["id"] == 4
    with pytest.raises(ValueError, match="FrameOfMocapData"):
        sd.parse_natnet_frame(struct.pack("<HH", 5, 0))
    empty = sd.ReplayDatagramTransport([])
    conn = sd.OptitrackNatNetConnection(empty)
    coords, flags = conn.get_coordinates()
    assert not coords.any() and not flags.any()


def test_claron_replay_sdk_surface():
    poses = [[[10.0, 20.0, 30.0, 5.0, -3.0, 1.0], [0.0] * 6, [1.0, 2.0, 3.0, 0.5, 0.5, 0.5]]]
    conn = trk.create_tracker_connection(TRACKER_CLARON, poses=poses)
    assert conn.connect()
    coords, flags = conn.get_coordinates()
    assert flags.all()
    np.testing.assert_allclose(coords[0], [10.0, 20.0, 30.0, 5.0, -3.0, 1.0])
    np.testing.assert_allclose(coords[2], [1.0, 2.0, 3.0, 0.5, 0.5, 0.5])
    conn.disconnect()


def test_claron_sdk_lifecycle_and_missing_attributes():
    calls = []

    class SDK:
        def Initialize(self):
            calls.append("init")

        def Close(self):
            calls.append("close")

        def Run(self):
            self.PositionTooltipX1, self.PositionTooltipY1, self.PositionTooltipZ1 = 1, 2, 3
            self.AngleZ1, self.AngleY1, self.AngleX1 = 4, 5, 6

    conn = trk.create_tracker_connection(TRACKER_CLARON, sdk=SDK())
    assert conn.connect()
    coords, flags = conn.get_coordinates()
    conn.disconnect()
    assert calls == ["init", "close"]
    assert flags.tolist() == [True, False, False]
    np.testing.assert_array_equal(coords[0], [1, 2, 3, 4, 5, 6])


# -- the JAX drivers on the same replays: identical sequences ------------------------------

def _sequence(module, tracker_id, kw, n):
    conn = module.create_tracker_connection(tracker_id, **kw)
    assert conn.connect()
    out = [conn.get_coordinates() for _ in range(n)]
    conn.disconnect()
    return out


@pytest.mark.parametrize("tracker_id", chip_smoke.NET_HARDWARE)
def test_drivers_equal_jax_on_one_replay(tracker_id):
    """The phase's replays (a loop and a half of 24 poses, the reference or
    the coil out of view now and then) through the port's and the JAX
    drivers: identical coordinates and flags, each the converter's."""
    kw, want = chip_smoke.hardware_replays(24)[tracker_id]
    kw_jax = dict(kw)
    got = _sequence(trk, tracker_id, dict(kw), 36)
    jax = _sequence(tracker_jax, tracker_id, kw_jax, 36)
    for k, ((c, f), (cj, fj)) in enumerate(zip(got, jax)):
        np.testing.assert_array_equal(c, cj)
        np.testing.assert_array_equal(f, fj)
        np.testing.assert_array_equal(c, want[k % 24][0])
        np.testing.assert_array_equal(f, want[k % 24][1])


# -- NDI framing and the transcript makers, byte for byte -----------------------------------

@settings(max_examples=80, deadline=None)
@given(st.binary(max_size=200))
def test_ndi_crc_and_framing_equal_jax(data):
    assert sd.crc16_ndi(data) == sd_jax.crc16_ndi(data)
    framed = sd.frame_ndi(data)
    assert framed == sd_jax.frame_ndi(data)
    assert sd.unframe_ndi(framed) == sd_jax.unframe_ndi(framed) == data


def test_crc16_ndi_is_crc16_arc():
    assert sd.crc16_ndi(b"123456789") == 0xBB3D  # CRC-16/ARC check value


_pose = st.tuples(*[st.floats(-99.0, 99.0, allow_nan=False)] * 6)
_quat = st.tuples(*[st.floats(-1.0, 1.0, allow_nan=False)] * 4)
_tool = st.one_of(st.none(), st.tuples(_quat, st.tuples(*[st.floats(-999.0, 999.0)] * 3)))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(_pose, _pose), min_size=1, max_size=4),
       st.sampled_from(["isotrak", "fastrak"]))
def test_isotrak_transcript_equal_jax(poses, model):
    assert sd.make_isotrak_transcript(poses, model) == \
        sd_jax.make_isotrak_transcript(poses, model)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.lists(_tool, min_size=3, max_size=3), min_size=1, max_size=3),
       st.one_of(st.none(), st.lists(st.binary(min_size=1, max_size=150), min_size=3,
                                     max_size=3)))
def test_polaris_transcript_equal_jax(frames, roms):
    assert sd.make_polaris_transcript(frames, rom_files=roms) == \
        sd_jax.make_polaris_transcript(frames, rom_files=roms)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.fixed_dictionaries({
    "id": st.integers(0, 99), "pos": st.tuples(*[st.floats(-2.0, 2.0)] * 3),
    "quat": _quat, "tracked": st.booleans()}), max_size=4))
def test_natnet_frame_equal_jax(bodies):
    frame = sd.make_natnet_frame(bodies)
    assert frame == sd_jax.make_natnet_frame(bodies)
    assert sd.parse_natnet_frame(frame) == sd_jax.parse_natnet_frame(frame)


# -- transports --------------------------------------------------------------------------

def test_transcript_recorder_round_trip(tmp_path):
    """A capture through ``TranscriptRecorder`` replays byte for byte."""
    poses = [((1.0, 2.0, 3.0, 0, 0, 0), (0.0,) * 6), ((2.0, 3.0, 4.0, 0, 0, 0), (0.0,) * 6)]
    inner = sd.ReplayTransport(sd.make_isotrak_transcript(poses), loop=False)
    rec = sd.TranscriptRecorder(inner)
    conn = sd.PolhemusSerialConnection(rec)
    assert conn.connect()
    first = [conn.get_coordinates() for _ in range(2)]
    rec.save(tmp_path / "capture.json")
    conn.disconnect()
    replay = sd.PolhemusSerialConnection(
        sd.ReplayTransport.from_file(tmp_path / "capture.json", loop=False))
    assert replay.connect()
    for c, f in first:
        c2, f2 = replay.get_coordinates()
        np.testing.assert_array_equal(c, c2)
        np.testing.assert_array_equal(f, f2)
    assert rec.entries == sd_jax.ReplayTransport.from_file(tmp_path / "capture.json").transcript


def test_replay_transport_loops_over_the_polls():
    poses = [((float(i), 0.0, 0.0, 0, 0, 0), (0.0,) * 6) for i in range(3)]
    conn = sd.PolhemusSerialConnection(sd.ReplayTransport(sd.make_isotrak_transcript(poses)))
    assert conn.connect()
    xs = [conn.get_coordinates()[0][1, 0] for _ in range(7)]
    assert xs == [0.0] * 7  # the reference row: (0, 0, 0) every pose
    xs = [conn.get_coordinates()[0][0, 0] for _ in range(6)]
    assert len(set(xs)) == 3


@pytest.mark.parametrize("tracker_id,kw,missing", [
    (TRACKER_POLHEMUS_SERIAL, {"com_port": "/dev/ttyUSB0"}, "serial"),
    (TRACKER_POLARIS_NDI, {"com_port": "/dev/ttyUSB0"}, "serial"),
    (TRACKER_CLARON, {}, "pyclaron"),
])
def test_real_transport_needs_its_package(tracker_id, kw, missing):
    """Without a transport, transcript or SDK the factory opens the real
    device, which needs its package (absent here), as in the JAX package."""
    with pytest.raises(ImportError, match=missing):
        trk.create_tracker_connection(tracker_id, **kw)
    with pytest.raises(ImportError, match=missing):
        tracker_jax.create_tracker_connection(tracker_id, **kw)


@pytest.mark.parametrize("tracker_id", chip_smoke.NET_HARDWARE)
def test_factory_takes_a_transport(tracker_id):
    """Each hardware branch takes a ready transport (or SDK) as well as the
    data to replay."""
    kw, want = chip_smoke.hardware_replays(6)[tracker_id]
    if "transcript" in kw:
        kw = dict(kw)
        kw["transport"] = sd.ReplayTransport(kw.pop("transcript"))
    elif "frames" in kw:
        kw = {"transport": sd.ReplayDatagramTransport(kw["frames"])}
    else:
        kw = {"sdk": sd.ReplayMTC(kw["poses"])}
    conn = trk.create_tracker_connection(tracker_id, **kw)
    assert isinstance(conn, trk.TrackerConnection) and conn.connect()
    for k in range(8):
        c, f = conn.get_coordinates()
        np.testing.assert_array_equal(c, want[k % 6][0])
        np.testing.assert_array_equal(f, want[k % 6][1])
    conn.disconnect()

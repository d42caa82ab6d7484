"""The port's navigation modules (``navigation/``) on the JAX package's
navigation test cases (tests/test_navigation.py: the tracker, pose math,
the session with its tract and e-field workers, markers, the robot, the
hub, state persistence and MEP mapping), and against the JAX package on the
same inputs: pose math within 1e-12, e-field norms and MEP interpolation
within 1e-5 (float32 on both sides).  The hardware trackers build their
drivers (``navigation/serial_drivers.py``) from replays; the robot and the
e-field worker talk through the real ``NeuronavigationApi``.  Every test
that starts a thread stops and joins it."""

import csv
import queue
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.navigation import coregistration as coreg_jax
from invesalius3_tpu.navigation import efield as efield_jax
from invesalius3_tpu.navigation import mep as mep_jax
from invesalius3_tpu.navigation import tracker as tracker_jax
from invesalius3_tpu.ops import transforms as tr_jax
from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.core.session import Session
from invesalius3_tpu_torch.navigation import coregistration as coreg
from invesalius3_tpu_torch.navigation import efield, mep
from invesalius3_tpu_torch.navigation.markers import Marker, MarkersControl, MarkerType
from invesalius3_tpu_torch.navigation.navigation import (IterativeClosestPoint, Navigation,
                                                         NavigationHub)
from invesalius3_tpu_torch.navigation.record_coords import RecordCoords
from invesalius3_tpu_torch.navigation.robot import Robot, RobotObjective, Robots
from invesalius3_tpu_torch.navigation.tracker import (
    TRACKER_CAMERA, TRACKER_CLARON, TRACKER_DEBUG_APPROACH, TRACKER_DEBUG_RANDOM,
    TRACKER_OPTITRACK, TRACKER_POLARIS_NDI, TRACKER_POLHEMUS_SERIAL, Tracker,
    create_tracker_connection)
from invesalius3_tpu_torch.net.neuronavigation_api import NeuronavigationApi
from invesalius3_tpu_torch.ops import transforms as tr

import chip_smoke

torch.set_num_threads(1)


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def test_debug_tracker_poll_loop():
    t = Tracker()
    assert t.connect(TRACKER_DEBUG_RANDOM, poll_hz=500)
    receiver = t._receiver
    assert _wait(lambda: t.get_coordinates()[0].any())
    coords, flags = t.get_coordinates()
    assert coords.shape == (3, 6) and flags.all()
    for i in range(3):
        t.set_tracker_fiducial(i)
    assert t.are_fiducials_set()
    t.disconnect()
    assert not t.connected and not receiver.is_alive()


@pytest.mark.parametrize("tracker_id", [TRACKER_DEBUG_RANDOM, TRACKER_DEBUG_APPROACH])
def test_debug_connections_match_jax(tracker_id):
    got = create_tracker_connection(tracker_id, seed=3)
    want = tracker_jax.create_tracker_connection(tracker_id, seed=3)
    for _ in range(5):
        (c, f), (wc, wf) = got.get_coordinates(), want.get_coordinates()
        np.testing.assert_array_equal(c, wc)
        np.testing.assert_array_equal(f, wf)


@pytest.mark.parametrize("tracker_id", [TRACKER_POLHEMUS_SERIAL, TRACKER_POLARIS_NDI,
                                        TRACKER_OPTITRACK, TRACKER_CLARON])
def test_hardware_trackers_raise_not_ported(tracker_id):
    """Each hardware id builds its driver from a replay (no tracker id is
    refused any more), and the JAX factory builds the same driver; through
    ``Tracker.connect`` the poll thread serves the replayed poses."""
    kw, want = chip_smoke.hardware_replays(12)[tracker_id]
    conn = create_tracker_connection(tracker_id, **kw)
    conn_jax = tracker_jax.create_tracker_connection(tracker_id, **kw)
    assert type(conn).__name__ == type(conn_jax).__name__
    assert conn.connect() and conn_jax.connect()
    for k in range(3):
        (c, f), (cj, fj) = conn.get_coordinates(), conn_jax.get_coordinates()
        np.testing.assert_array_equal(c, cj)
        np.testing.assert_array_equal(f, fj)
        np.testing.assert_array_equal(c, want[k][0])
    t = Tracker()
    try:
        assert t.connect(tracker_id, poll_hz=500, **kw)
        assert _wait(lambda: t.get_coordinates()[1][0])
        c, _ = t.get_coordinates()
        assert any(np.array_equal(c, w) for w, _ in want)
    finally:
        receiver = t._receiver
        t.disconnect()
    assert not t.connected and not receiver.is_alive()


def test_unknown_tracker_raises():
    with pytest.raises(ValueError, match="not available"):
        create_tracker_connection("no_such_tracker")


def test_camera_tracker_seam():
    class FakeCamera:
        def Run(self):
            return ([[1, 2, 3, 0, 0, 0], [4, 5, 6, 0, 0, 0]], True, True, False)

    t = Tracker()
    assert t.connect(TRACKER_CAMERA, poll_hz=500, camera=FakeCamera())
    assert _wait(lambda: t.get_coordinates()[0].any())
    coords, flags = t.get_coordinates()
    assert coords[0, 0] == 1 and coords[1, 2] == 6
    assert flags.tolist() == [True, True, False]
    t.disconnect()


def test_pose_matrix_roundtrip():
    pose = np.array([10.0, -5.0, 30.0, 20.0, -40.0, 65.0])
    m = coreg.pose_to_matrix(pose)
    np.testing.assert_allclose(coreg.matrix_to_pose(m), pose, atol=1e-9)
    np.testing.assert_allclose(m, coreg_jax.pose_to_matrix(pose), rtol=0, atol=1e-12)


def test_corregistrate_probe_static_and_dynamic():
    m_change = tr.euler_matrix(0.1, 0.2, 0.3)
    m_change[:3, 3] = [5, 6, 7]
    probe = np.array([1.0, 2.0, 3.0, 10.0, 20.0, 30.0])
    m_img = coreg.corregistrate_probe(m_change, probe, ref_pose=None)
    np.testing.assert_allclose(m_img, m_change @ coreg.pose_to_matrix(probe), atol=1e-12)
    np.testing.assert_allclose(coreg.corregistrate_probe(m_change, probe, ref_pose=probe),
                               m_change, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_coregistration_math_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m_change = tr.euler_matrix(*rng.uniform(-1, 1, 3))
    m_change[:3, 3] = rng.uniform(-20, 20, 3)
    m_icp = tr.euler_matrix(*rng.uniform(-0.05, 0.05, 3))
    poses = np.c_[rng.uniform(-100, 100, (3, 3)), rng.uniform(-180, 180, (3, 3))]
    obj = tuple(tr.euler_matrix(*rng.uniform(-1, 1, 3)) for _ in range(4))
    cases = [
        (coreg.corregistrate_probe(m_change, poses[0], poses[1], m_icp),
         coreg_jax.corregistrate_probe(m_change, poses[0], poses[1], m_icp)),
        (coreg.corregistrate_object_dynamic(m_change, obj, poses[2], poses[1], m_icp),
         coreg_jax.corregistrate_object_dynamic(m_change, obj, poses[2], poses[1], m_icp)),
        (coreg.image_to_tracker(m_change, poses[2], poses[1], m_icp),
         coreg_jax.image_to_tracker(m_change, poses[2], poses[1], m_icp)),
        (coreg.dynamic_reference(poses[0], poses[1]),
         coreg_jax.dynamic_reference(poses[0], poses[1])),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_image_to_tracker_inverts_corregistrate():
    m_change = tr.euler_matrix(0.3, -0.1, 0.2)
    m_change[:3, 3] = [4, -2, 9]
    target_img = np.array([12.0, 34.0, 56.0, 5.0, 10.0, 15.0])
    m_trk = coreg.image_to_tracker(m_change, target_img)
    m_img = coreg.corregistrate_probe(m_change, coreg.matrix_to_pose(m_trk))
    np.testing.assert_allclose(m_img, coreg.pose_to_matrix(target_img), atol=1e-6)


def test_lifo_queue_keeps_the_latest():
    q = coreg.LIFOQueue(maxsize=1)
    for i in range(5):
        q.put_latest(i)
    assert q.get_nowait() == 4 and q.empty()


def _registered(bus, **nav_kw):
    nav = Navigation(bus=bus, **nav_kw)
    assert nav.tracker.connect(TRACKER_DEBUG_APPROACH, poll_hz=500)
    assert _wait(lambda: nav.tracker.get_coordinates()[0].any())
    for i in range(3):
        nav.tracker.set_tracker_fiducial(i)
        time.sleep(0.02)
    return nav


def test_full_navigation_session():
    bus = events.Publisher()
    nav = _registered(bus, device="cpu")
    m_true = tr_jax.euler_matrix(0.1, -0.2, 0.15)
    m_true[:3, 3] = [3.0, -7.0, 11.0]
    trk = nav.tracker.tracker_fiducials[:, :3]
    img = (np.c_[trk, np.ones(3)] @ m_true.T)[:, :3]
    for i in range(3):
        nav.image.set(i, img[i])
    registered = []
    bus.subscribe(lambda **kw: registered.append(kw), "navigation.registered")
    fre = nav.estimate_tracker_to_image_transform()
    assert fre < 1e-6 and registered[0]["fre"] == fre
    np.testing.assert_allclose(nav.m_change, m_true, atol=1e-6)

    got = []
    bus.subscribe(lambda **kw: got.append(kw), "navigation.update_scene")
    nav.start_navigation(poll_hz=200)
    threads = [nav._coreg, nav._updater]
    time.sleep(0.3)
    nav.stop_navigation()
    nav.tracker.disconnect()
    assert not any(th.is_alive() for th in threads)
    assert len(got) >= 3 and "probe_pose_img" in got[0]
    assert not nav.is_navigating


def test_navigation_spawns_tract_and_efield_workers():
    bus = events.Publisher()
    nav = _registered(bus, device="cpu")
    for i in range(3):
        nav.image.set(i, nav.tracker.tracker_fiducials[i, :3])
    nav.estimate_tracker_to_image_transform()
    shape = (8, 8, 8)
    field = np.zeros(shape + (3,), np.float32)
    field[..., 0] = 1.0
    nav.tract_params = {
        "direction_field": field, "stop_mask": np.ones(shape, bool),
        "n_tracts_total": 4, "n_steps": 5,
        "world_to_vox": lambda p: np.clip(np.asarray(p)[::-1], 1, 6),
    }
    nav.efield_params = {
        "roi_vertices": np.random.default_rng(0).uniform(0, 8, (16, 3)),
        "roi_ids": np.arange(16), "debug": True,
    }
    tracts, efields = [], []
    bus.subscribe(lambda **kw: tracts.append(kw), "navigation.tracts")
    bus.subscribe(lambda **kw: efields.append(kw), "navigation.efield")
    nav.start_navigation(poll_hz=200)
    workers = [nav._tract_thread, nav._efield_thread]
    assert all(w.device.type == "cpu" for w in workers)
    _wait(lambda: tracts and efields)
    nav.stop_navigation()
    nav.tracker.disconnect()
    assert not any(w.is_alive() for w in workers)
    assert tracts and efields
    paths = np.asarray(tracts[0]["paths"])
    assert paths.shape == (6, 4, 3)
    assert np.asarray(efields[0]["enorms"]).shape == (16,)
    np.testing.assert_array_equal(np.asarray(efields[0]["roi_ids"]), np.arange(16))
    assert efields[0]["timestamp"] <= time.monotonic()


def test_markers_control_roundtrip(tmp_path):
    mc = MarkersControl(bus=events.Publisher())
    m1 = mc.add(Marker(marker_type=MarkerType.FIDUCIAL, position=(1, 2, 3), label="LE"))
    m2 = mc.add(Marker(marker_type=MarkerType.COIL_TARGET, position=(4, 5, 6), label="T1"))
    mc.set_target(m2.marker_id)
    assert mc.target.label == "T1"
    mc.set_target(m1.marker_id)
    assert mc.target.label == "LE" and not m2.is_target
    mc.save_json(tmp_path / "m.json")
    mc2 = MarkersControl(bus=events.Publisher())
    mc2.load_json(tmp_path / "m.json")
    assert len(mc2.markers) == 2 and mc2.markers[1].position == (4.0, 5.0, 6.0)
    mc.save_csv(tmp_path / "m.csv")
    mc3 = MarkersControl(bus=events.Publisher())
    mc3.load_csv(tmp_path / "m.csv")
    assert len(mc3.markers) == 2 and mc3.markers[0].label == "LE"
    mc.delete(m1.marker_id)
    assert len(mc.markers) == 1


def test_marker_files_are_the_jax_packages(tmp_path):
    """The JAX package reads the port's marker files and the other way."""
    from invesalius3_tpu.navigation import markers as markers_jax

    mc = MarkersControl(bus=events.Publisher())
    mc.add(Marker(marker_type=MarkerType.BRAIN_TARGET, position=(1.5, 2, 3),
                  orientation=(10, 20, 30), label="M1", mep_value=420.0, z_offset=2.0))
    mc.save_json(tmp_path / "p.json")
    jc = markers_jax.MarkersControl(bus=markers_jax.MarkersControl().bus)
    jc.load_json(tmp_path / "p.json")
    assert jc.markers[0].to_dict() == mc.markers[0].to_dict()
    jc.save_json(tmp_path / "j.json")
    assert (tmp_path / "j.json").read_text() == (tmp_path / "p.json").read_text()


def test_robot_target_flow():
    bus = events.Publisher()
    nav = Navigation(bus=bus, device="cpu")
    nav.tracker.connect(TRACKER_DEBUG_RANDOM, poll_hz=500)
    _wait(lambda: nav.tracker.get_coordinates()[0].any())
    nav.m_change = np.eye(4)
    nav.use_dynamic_reference = False
    calls = []

    class FakeConnection:  # the external robot controller behind the API
        def set_objective(self, robot_id, objective):
            calls.append(("objective", robot_id, objective))

        def update_robot_target(self, robot_id, target):
            calls.append(("target", robot_id, target))

    api = NeuronavigationApi(connection=FakeConnection(), bus=bus)
    robot = Robots(api=api, bus=bus).get("r0")
    robot.set_objective(RobotObjective.TRACK_TARGET)
    m_trk = robot.send_target(nav, np.array([10.0, 20.0, 30.0, 0.0, 0.0, 0.0]))
    nav.tracker.disconnect()
    assert calls[0] == ("objective", "r0", 1)
    assert calls[1][:2] == ("target", "r0")
    np.testing.assert_allclose(m_trk[:3, 3], [10, 20, 30], atol=1e-9)
    np.testing.assert_allclose(calls[1][2][:3], [10, 20, 30], atol=1e-9)


def test_robot_without_api_keeps_local_state():
    bus = events.Publisher()
    seen = []
    bus.subscribe(lambda **kw: seen.append(kw), "robot")
    r = Robot("r1", bus=bus)
    assert r.connect("10.0.0.2") and r.connected and r.ip == "10.0.0.2"
    r.register_tracker_to_robot(np.eye(4) * 2)
    r.set_free_drive(True)
    r.on_force_update(3.5)
    assert r.force == 3.5 and len(seen) == 4


def test_navigation_hub_composes():
    hub = NavigationHub(bus=events.Publisher(), device="cpu")
    assert hub.tracker is hub.navigation.tracker
    assert hub.markers is not None and hub.icp is hub.navigation.icp
    assert hub.navigation.device == "cpu"
    assert hub.mep.config == mep.DEFAULT_MEP_CONFIG


def test_tracker_state_persistence(tmp_path):
    s = Session(user_dir=tmp_path / "cfg")
    t = Tracker()
    t.connect(TRACKER_DEBUG_RANDOM, poll_hz=500)
    _wait(lambda: t.get_coordinates()[0].any())
    for i in range(3):
        t.set_tracker_fiducial(i)
    t.save_state(s)
    t.disconnect()
    t2 = Tracker()
    assert t2.load_state(s)
    assert t2.connected and t2.tracker_id == TRACKER_DEBUG_RANDOM
    assert t2.are_fiducials_set()
    np.testing.assert_allclose(t2.tracker_fiducials, t.tracker_fiducials)
    t2.disconnect()


def test_icp_state_persistence(tmp_path):
    s = Session(user_dir=tmp_path / "cfg")
    icp = IterativeClosestPoint()
    icp.m_icp = np.eye(4) * 2.0
    icp.use_icp = True
    icp.save_state(s)
    icp2 = IterativeClosestPoint()
    icp2.load_state(s)
    assert icp2.use_icp
    np.testing.assert_allclose(icp2.m_icp, icp.m_icp)


def test_icp_register_refines_the_session():
    rng = np.random.default_rng(0)
    surface = rng.normal(size=(400, 3)) * 4
    m_true = tr.euler_matrix(0.03, -0.02, 0.04)
    m_true[:3, 3] = [0.2, -0.1, 0.15]
    probe = (np.c_[surface[:100], np.ones(100)] @ np.linalg.inv(m_true).T)[:, :3]
    icp = IterativeClosestPoint()
    err = icp.register(surface, probe, device="cpu")
    assert icp.use_icp and err == icp.icp_fre and err < 1e-3
    np.testing.assert_allclose(icp.m_icp, m_true, atol=1e-3)


def test_record_coords_writes_csv(tmp_path):
    t = Tracker()
    t.connect(TRACKER_DEBUG_RANDOM, poll_hz=500)
    _wait(lambda: t.get_coordinates()[0].any())
    rec = RecordCoords(t, tmp_path / "c.csv", poll_hz=200)
    rec.start()
    time.sleep(0.1)
    rec.stop()
    rec.join(timeout=5.0)
    t.disconnect()
    assert not rec.is_alive()
    rows = list(csv.reader(open(tmp_path / "c.csv")))
    assert rows[0][:3] == ["timestamp", "sensor", "x"] and len(rows) >= 4
    assert {r[1] for r in rows[1:4]} == {"0", "1", "2"}


# ---------------------------------------------------------------------------
# e-field and MEP against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_efield_debug_norms_match_jax(seed):
    rng = np.random.default_rng(seed)
    roi = rng.uniform(0, 100, (500, 3)).astype(np.float32)
    pos = rng.uniform(20, 80, 3).astype(np.float32)
    d = rng.normal(size=3)
    d = (d / np.linalg.norm(d)).astype(np.float32)
    got = efield.debug_efield_norms(torch.from_numpy(roi), torch.from_numpy(pos),
                                    torch.from_numpy(d))
    want = np.asarray(efield_jax.debug_efield_norms(jnp.asarray(roi), jnp.asarray(pos),
                                                    jnp.asarray(d)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_efield_thread_compute_once():
    """The JAX test, and the port's worker against the JAX worker on a probe
    pose (no coil registered) and a coil pose."""
    roi = np.random.default_rng(0).uniform(0, 100, (50, 3)).astype(np.float32)
    th = efield.VisualizeEFieldThread(queue.Queue(), roi_vertices=roi, debug=True,
                                      bus=events.Publisher(), device="cpu")
    jt = efield_jax.VisualizeEFieldThread(queue.Queue(), roi_vertices=roi, debug=True)
    m = tr.euler_matrix(0.3, 0.2, -0.4)
    m[:3, 3] = roi[7]
    for item in ({"coils_img": {0: m}}, {"m_probe_img": m, "coils_img": {}}):
        norms = th.compute_once(item)
        assert norms.shape == (50,)
        np.testing.assert_allclose(norms, jt.compute_once(item), rtol=1e-5, atol=1e-5)
    assert norms[7] > norms[np.argmax(np.linalg.norm(roi - roi[7], axis=1))]
    assert th.compute_once({}) is None


def test_efield_thread_calls_the_solver_api():
    calls = []

    class Solver:  # the external e-field solver behind the API
        def update_efield_vectorROIMax(self, **kw):
            calls.append(kw)
            return [1.0, 3.0, 2.0]

    api = NeuronavigationApi(connection=Solver(), bus=events.Publisher())
    th = efield.VisualizeEFieldThread(queue.Queue(), api=api, roi_ids=np.arange(3),
                                      bus=events.Publisher(), device="cpu")
    m = np.eye(4)
    m[:3, 3] = [1, 2, 3]
    assert th.compute_once({"coils_img": {0: m}}).tolist() == [1.0, 3.0, 2.0]
    assert calls[0]["position"] == [1.0, 2.0, 3.0] and calls[0]["orientation"] == [0, 0, 1]


def test_mep_interpolation_and_colormap():
    verts = np.array([[0, 0, 0], [1, 0, 0], [10, 0, 0]], np.float32)
    pts = np.array([[0, 0, 0]], np.float32)
    field = mep.interpolate_mep_surface(verts, pts, np.array([800.0], np.float32),
                                        {"gaussian_radius": 3.0}, device="cpu")
    assert abs(field[0] - 800.0) < 1e-3 and abs(field[1] - 800.0) < 1e-3
    assert field[2] == 0.0
    colors = mep.mep_colors(field)
    assert colors.shape == (3, 3)
    np.testing.assert_allclose(colors[2], mep.CORTEX_COLOR, atol=1e-6)
    cmap = mep.MEP_COLORMAPS["Viridis"]
    lo = np.minimum(cmap["mid"], cmap["max"])
    hi = np.maximum(cmap["mid"], cmap["max"])
    assert ((colors[0] >= lo - 1e-6) & (colors[0] <= hi + 1e-6)).all()


@pytest.mark.parametrize("config", [{}, {"gaussian_radius": 12.0, "gaussian_sharpness": 2.0,
                                         "mep_colormap": "BlueCyanYellowRed"}])
def test_mep_matches_jax(config):
    rng = np.random.default_rng(4)
    verts = rng.uniform(0, 40, (3000, 3)).astype(np.float32)
    pts = rng.uniform(0, 40, (200, 3)).astype(np.float32)
    vals = rng.uniform(0, 1200, 200).astype(np.float32)
    got = mep.interpolate_mep_surface(verts, pts, vals, config, device="cpu")
    want = mep_jax.interpolate_mep_surface(verts, pts, vals, config)
    assert got.dtype == np.float32 and (got > 0).mean() > 0.2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(mep.mep_colors(got, config), mep_jax.mep_colors(got, config))


def test_mep_mapper_with_markers_and_session(tmp_path):
    s = Session(user_dir=tmp_path / "cfg")
    mapper = mep.MEPMapper.from_session(s)
    mapper.config["mep_colormap"] = "GreenYellowOrangeRed"
    mapper.save_to_session(s)
    mapper2 = mep.MEPMapper.from_session(Session(user_dir=tmp_path / "cfg"))
    assert mapper2.config["mep_colormap"] == "GreenYellowOrangeRed"
    verts = np.zeros((5, 3), np.float32)
    markers = [Marker(position=(0, 0, 0), mep_value=500.0), Marker(position=(1, 1, 1))]
    out = mapper2.map_markers(verts, markers, device="cpu")
    assert out["values"].shape == (5,) and out["colors"].shape == (5, 3)
    assert out["values"].max() > 0
    assert mapper2.map_markers(verts, [Marker()], device="cpu")["values"].max() == 0


# ---------------------------------------------------------------------------
# the new entry points run on the card unless asked
# ---------------------------------------------------------------------------


def _entry_points():
    from invesalius3_tpu_torch.navigation import tractography
    from invesalius3_tpu_torch.ops import brain_peel, marching, registration, voronoi

    shape = (6, 6, 6)
    fod = np.zeros(shape + (6,), np.float32)
    ones = np.ones(shape, bool)
    seeds = np.full((2, 3), 3.0, np.float32)
    mask = np.zeros(shape, np.uint8)
    mask[1:5, 1:5, 1:5] = 255
    return {
        "marching.marching_cubes": lambda **kw: marching.marching_cubes(mask, 127.5, **kw),
        "marching.mask_to_surface": lambda **kw: marching.mask_to_surface(mask, **kw),
        "brain_peel.Brain": lambda **kw: brain_peel.Brain(mask, mask, n_peels=1, **kw),
        "voronoi.jump_flooding": lambda **kw: voronoi.jump_flooding(shape, seeds, **kw),
        "voronoi.jump_flooding_normalized": lambda **kw: voronoi.jump_flooding_normalized(
            shape, seeds, **kw),
        "voronoi.floodfill_voronoi": lambda **kw: voronoi.floodfill_voronoi(shape, seeds, **kw),
        "registration.icp": lambda **kw: registration.icp(seeds, seeds + 1, **kw),
        "tractography.track_streamlines": lambda **kw: tractography.track_streamlines(
            np.ones(shape + (3,), np.float32), ones, seeds, n_steps=2, **kw),
        "tractography.track_streamlines_probabilistic":
            lambda **kw: tractography.track_streamlines_probabilistic(
                fod, ones, seeds, n_steps=2, lmax=2, **kw),
        "tractography.ComputeTractsThread": lambda **kw: tractography.ComputeTractsThread(
            queue.Queue(), stop_mask=ones, fod_sh=fod, **kw),
        "efield.VisualizeEFieldThread": lambda **kw: efield.VisualizeEFieldThread(
            queue.Queue(), roi_vertices=seeds, **kw),
        "mep.interpolate_mep_surface": lambda **kw: mep.interpolate_mep_surface(
            seeds, seeds, np.ones(2), **kw),
        "IterativeClosestPoint.register": lambda **kw: IterativeClosestPoint().register(
            seeds + 1, seeds, **kw),
    }


ENTRY_NAMES = sorted(_entry_points())


@pytest.mark.parametrize("name", ENTRY_NAMES)
def test_entry_point_runs_on_the_card_unless_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    call(device="cpu")


def test_navigation_passes_its_device_to_the_workers():
    assert Navigation(bus=events.Publisher()).device == "cuda"
    nav = Navigation(bus=events.Publisher(), device="cpu")
    assert nav.device == "cpu"

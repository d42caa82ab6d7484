"""The port's headless app (``app.main(..., device="cpu")``) against the JAX
package's ``app.main`` on one small NIfTI CT, and on the same CT imported as
a DICOM series (``-i``, ``--import-all``), a bitmap stack
(``--import-folder`` with ``--spacing``) and a PAR/REC pair.

Both runs start from the same process-wide mask and surface counters, so
masks and surfaces get the same indices and names.  Compared: STL files
byte for byte (STL holds no vertex list, so the JAX mesh's padding orphan
does not show); files that hold a vertex list (PLY, the .inv3 surface
members) against the JAX file with its orphan dropped
(``convert.surface_from_jax``); the other .inv3 members byte for byte, and
main.plist and the surface plists by value (volume and area within a
relative 1e-5; date and version excepted); NIfTI and HDF5 exports by
content.  A context-aware smoothed surface's coordinates agree within one
float16 step (see test_torch_surface_project.py).
"""

import plistlib
import tarfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from invesalius3_tpu import app as app_jax
from invesalius3_tpu import events as events_jax
from invesalius3_tpu.core import surface as surface_jax
from invesalius3_tpu.core.mask import Mask as MaskJax
from invesalius3_tpu.io import mesh_io as mesh_io_jax
from invesalius3_tpu.io import nifti as nifti_jax
from invesalius3_tpu_torch import app, convert, events
from invesalius3_tpu_torch.core import surface
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.io import mesh_io
from invesalius3_tpu_torch.net.remote_server import RemoteEventServer

torch.set_num_threads(1)
SPACING = (0.5, 0.6, 0.7)


def _ct(n=20):
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float32)
    c = (n - 1) / 2.0
    r = np.sqrt((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2)
    ct = np.full((n, n, n), -1000, np.int16)
    ct[r < 0.42 * n] = 40
    ct[(r >= 0.32 * n) & (r < 0.42 * n)] = 1200
    ct[r < 0.12 * n] = 900
    return ct + np.random.default_rng(0).integers(-20, 20, ct.shape, dtype=np.int16)


@pytest.fixture
def ct_file(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    path = tmp_path / "ct.nii"
    nifti_jax.write_nifti(path, _ct(), spacing=SPACING)
    return path


def _run(tmp_path, monkeypatch, argv):
    """Run both apps on ``argv`` (``{out}`` in an argument becomes each
    side's output directory) from the same counters; returns the port's and
    the JAX package's output directories."""
    dirs = []
    for name, main in (("port", lambda a: app.main(a, device="cpu")),
                       ("jax", app_jax.main)):
        out = tmp_path / name
        out.mkdir()
        monkeypatch.setattr(Mask, "general_index", -1)
        monkeypatch.setattr(MaskJax, "general_index", -1)
        monkeypatch.setattr(surface.Surface, "_counter", [-1])
        monkeypatch.setattr(surface_jax.Surface, "_counter", [-1])
        assert main([a.format(out=out) for a in argv]) == 0
        dirs.append(out)
    return dirs


def _no_orphan(v, f):
    s = convert.surface_from_jax(surface_jax.Surface(vertices=v, faces=f, index=0))
    return s.vertices, s.faces


def _stl_records(path):
    data = Path(path).read_bytes()
    rec = np.frombuffer(data[84:], np.dtype([("n", "<f4", 3), ("v", "<f4", 9),
                                             ("a", "<u2")]))
    return data[:84], rec


def _same_stl(a, b, smoothed=False):
    if not smoothed:
        assert a.read_bytes() == b.read_bytes()
        return
    (ha, ra), (hb, rb) = _stl_records(a), _stl_records(b)
    assert ha == hb and len(ra) == len(rb)
    step = np.spacing(np.abs(rb["v"]).astype(np.float16)).astype(np.float32)
    assert (np.abs(ra["v"] - rb["v"]) <= step).all()
    np.testing.assert_allclose(ra["n"], rb["n"], atol=0.05)


def _members(path):
    with tarfile.open(path, "r:*") as tar:
        return {Path(m.name).name: tar.extractfile(m).read()
                for m in tar.getmembers() if m.isfile()}


def _same_inv3(a, b):
    ma, mb = _members(a), _members(b)
    assert sorted(ma) == sorted(mb)
    for name in ma:
        if name.endswith(".vtp"):
            want = _no_orphan(*mesh_io.read_vtp_bytes(mb[name]))
            assert ma[name] == mesh_io.vtp_text(*want).encode(), name
        elif name == "main.plist" or name.startswith("surface_"):
            pa, pb = plistlib.loads(ma[name]), plistlib.loads(mb[name])
            for key in ("date", "invesalius_version", "image_fiducials"):
                pa.pop(key, None), pb.pop(key, None)
            for key in ("volume", "area"):
                if key in pa:
                    np.testing.assert_allclose(pa.pop(key), pb.pop(key), rtol=1e-5)
            assert pa == pb, name
        else:
            assert ma[name] == mb[name], name
    return ma


@pytest.mark.parametrize("algorithm", ["Default", "ca_smoothing"])
def test_threshold_export_save_and_export_project(tmp_path, monkeypatch, ct_file,
                                                  algorithm):
    port, jax_ = _run(tmp_path, monkeypatch, [
        "--import-file", str(ct_file), "-t", "Bone", "-e", "{out}/bone.stl",
        "-s", "{out}/proj.inv3", "--export-project", "{out}/proj.nii",
        "--algorithm", algorithm])
    _same_stl(port / "bone.stl", jax_ / "bone.stl", algorithm == "ca_smoothing")
    if algorithm == "Default":
        members = _same_inv3(port / "proj.inv3", jax_ / "proj.inv3")
        assert "surface_0.vtp" in members and "mask_0.dat" in members
    assert (port / "proj.nii").read_bytes() == (jax_ / "proj.nii").read_bytes()


def test_ply_low_quality_and_hdf5(tmp_path, monkeypatch, ct_file):
    import h5py

    port, jax_ = _run(tmp_path, monkeypatch, [
        "--import-file", str(ct_file), "-t", "226,3071", "-e", "{out}/bone.ply",
        "--quality", "Low", "--export-project", "{out}/proj.h5"])
    got = mesh_io.read_ply(port / "bone.ply")
    want = _no_orphan(*mesh_io_jax.read_ply(jax_ / "bone.ply"))
    mesh_io.write_ply(tmp_path / "want.ply", *want)
    assert (port / "bone.ply").read_bytes() == (tmp_path / "want.ply").read_bytes()
    full = surface.create_surface_from_mask(
        convert.mask_from_jax(_jax_bone_mask(), device="cpu"), SPACING)
    assert len(got[1]) == int(len(full.faces) * 0.6)  # decimated by 0.4
    with h5py.File(port / "proj.h5") as fa, h5py.File(jax_ / "proj.h5") as fb:
        np.testing.assert_array_equal(fa["image"][()], fb["image"][()])
        np.testing.assert_array_equal(fa["masks/0"][()], fb["masks/0"][()])
        np.testing.assert_array_equal(fa["image"].attrs["spacing"],
                                      fb["image"].attrs["spacing"])


def test_export_to_all(tmp_path, monkeypatch, ct_file):
    port, jax_ = _run(tmp_path, monkeypatch, [
        "--import-file", str(ct_file), "-a", "{out}/all.stl"])
    names = sorted(p.name for p in port.iterdir())
    assert names == sorted(p.name for p in jax_.iterdir()) and len(names) >= 3
    assert "all_Bone.stl" in names
    for name in names:
        _same_stl(port / name, jax_ / name)


def _open_mesh_file(tmp_path):
    s = surface.create_surface_from_mask(
        convert.mask_from_jax(_jax_bone_mask(), device="cpu"), SPACING,
        keep_largest=True)
    keep = np.ones(len(s.faces), bool)
    keep[[2, len(s.faces) // 2]] = False
    path = tmp_path / "open.stl"
    mesh_io.write_stl(path, s.vertices, s.faces[keep])
    return path


def _jax_bone_mask():
    m = MaskJax(index=0)
    ct = _ct()
    m.data = np.where((ct >= 226) & (ct <= 3071), 255, 0).astype(np.uint8)
    return m


def test_import_surface_standalone_and_into_a_project(tmp_path, monkeypatch, ct_file):
    mesh = _open_mesh_file(tmp_path)
    port, jax_ = _run(tmp_path, monkeypatch, [
        "--import-surface", str(mesh), "-e", "{out}/capped.ply"])
    assert (port / "capped.ply").read_bytes() == (jax_ / "capped.ply").read_bytes()
    for side in ("port", "jax"):
        (tmp_path / side).rename(tmp_path / f"{side}_standalone")
    port, jax_ = _run(tmp_path, monkeypatch, [
        "--import-file", str(ct_file), "-t", "Bone", "--import-surface", str(mesh),
        "-s", "{out}/proj.inv3"])
    members = _same_inv3(port / "proj.inv3", jax_ / "proj.inv3")
    assert [n for n in members if n.endswith(".vtp")] == ["surface_0.vtp"]


def test_reopen_saved_project(tmp_path, monkeypatch, ct_file):
    port, jax_ = _run(tmp_path, monkeypatch, [
        "--import-file", str(ct_file), "-s", "{out}/proj.inv3"])
    # each app reopens the other's project
    assert app.main(["--import-file", str(jax_ / "proj.inv3"), "-t", "Bone",
                     "-e", str(tmp_path / "port.stl")], device="cpu") == 0
    assert app_jax.main(["--import-file", str(port / "proj.inv3"), "-t", "Bone",
                         "-e", str(tmp_path / "jax.stl")]) == 0
    assert (tmp_path / "port.stl").read_bytes() == (tmp_path / "jax.stl").read_bytes()


def _mirrored(tmp_path, monkeypatch, flag):
    """(the events each app mirrors with ``flag`` host:port to its own
    RemoteEventServer, the topics its bus hook was handed) for one import,
    threshold and export."""
    out = {}
    for name, main, bus in (("port", lambda a: app.main(a, device="cpu"), events.bus),
                            ("jax", app_jax.main, events_jax.bus)):
        monkeypatch.setattr(Mask, "general_index", -1)
        monkeypatch.setattr(MaskJax, "general_index", -1)
        monkeypatch.setattr(surface.Surface, "_counter", [-1])
        monkeypatch.setattr(surface_jax.Surface, "_counter", [-1])
        handed, add = [], bus.add_send_message_hook

        def recording(hook, handed=handed, add=add):
            add(lambda topic, kw: (handed.append(topic), hook(topic, kw)))

        monkeypatch.setattr(bus, "add_send_message_hook", recording)
        srv = RemoteEventServer().start()
        try:
            assert main(["--import-file", str(tmp_path / "ct.nii"), "-t", "Bone", "-e",
                         str(tmp_path / f"{name}.stl"), flag, f"127.0.0.1:{srv.port}"]) == 0
            assert bus._hook is None  # disconnected on the way out
            deadline = time.monotonic() + 20
            while len(srv.received) < len(handed) and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            srv.stop()
        out[name] = (srv.received, handed)
    return out


@pytest.mark.parametrize("argv,module", [
    (["--remote-host", "localhost:5000"], "net/remote_control.py"),
])
def test_flags_still_to_port_exit_naming_the_module(tmp_path, monkeypatch, ct_file, argv,
                                                    module):
    """No flag is left to port: ``--remote-host`` (``module``) runs, and
    mirrors the same events as the JAX app's to a RemoteEventServer."""
    assert not hasattr(app, "_NOT_PORTED") and not hasattr(app, "_refuse_not_ported")
    got = _mirrored(tmp_path, monkeypatch, argv[0])
    assert module == "net/remote_control.py"
    assert got["port"] == got["jax"]
    received, handed = got["port"]
    assert [m["topic"] for m in received] == handed == ["slice.volume_set",
                                                        "slice.mask_added"]


def test_remote_host_disconnects_when_the_run_fails(tmp_path, monkeypatch):
    """The mirror's bus hook goes on every exit path: a failed import leaves
    no hook behind for the next app.main in the process."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    srv = RemoteEventServer().start()
    try:
        with pytest.raises(Exception):
            app.main(["--import-file", str(tmp_path / "missing.nii"),
                      "--remote-host", f"127.0.0.1:{srv.port}"], device="cpu")
        assert events.bus._hook is None
    finally:
        srv.stop()
    with pytest.raises(ConnectionRefusedError):
        app.main(["--import-file", str(tmp_path / "missing.nii"),
                  "--remote-host", f"127.0.0.1:{srv.port}"], device="cpu")
    assert events.bus._hook is None


def _started_servers(monkeypatch):
    """The ViewerServers the app starts, recorded as they start."""
    from invesalius3_tpu_torch import server

    started = []
    start = server.ViewerServer.start

    def record(self):
        started.append(self)
        return start(self)

    monkeypatch.setattr(server.ViewerServer, "start", record)
    return started


def _get_json(srv, path):
    import json
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}") as r:
        return json.loads(r.read())


def test_serve_flag_serves_until_stopped(tmp_path, monkeypatch, ct_file):
    """--serve 0 after the batch steps: the port's server answers on a free
    port over the imported CT and its Bone mask, until stopped."""
    import threading
    import time

    started = _started_servers(monkeypatch)
    app.SERVE_STOP.clear()
    rc = []
    t = threading.Thread(target=lambda: rc.append(app.main(
        ["--import-file", str(ct_file), "-t", "Bone", "--serve", "0"], device="cpu")))
    t.start()
    try:
        deadline = time.monotonic() + 60
        while not started and time.monotonic() < deadline:
            time.sleep(0.05)
        assert started, "the server did not start"
        st = _get_json(started[0], "/api/status")
        assert st["volume_shape"] == [20, 20, 20] and st["n_masks"] == 1
        masks = _get_json(started[0], "/api/masks")
        assert masks[0]["threshold_range"] == [226, 3071]  # the CT Bone preset
    finally:
        app.SERVE_STOP.set()
        t.join(60)
        app.SERVE_STOP.clear()
    assert rc == [0]
    with pytest.raises(OSError):  # stopped: the socket is closed
        _get_json(started[0], "/api/status")


@pytest.mark.parametrize("serve", [False, True])
def test_shell_flag_runs_the_console(tmp_path, monkeypatch, ct_file, serve):
    """--shell (alone, or beside --serve) opens an interactive console
    whose namespace holds the app's objects (code.interact stubbed)."""
    import code

    seen = []
    monkeypatch.setattr(code, "interact",
                        lambda banner="", local=None, exitmsg=None: seen.append(
                            (banner, local)))
    started = _started_servers(monkeypatch)
    argv = ["--import-file", str(ct_file), "-t", "Bone", "--shell"]
    assert app.main(argv + (["--serve", "0"] if serve else []), device="cpu") == 0
    (banner, ns), = seen
    assert banner.startswith("invesalius3_tpu_torch shell")
    want = {"np", "torch", "ops", "const", "events", "slc", "project", "session",
            "volume"} | ({"server"} if serve else set())
    assert set(ns) == want
    assert ns["slc"].matrix.device.type == "cpu" and len(ns["slc"].masks) == 1
    if serve:
        assert ns["server"] is started[0]
        with pytest.raises(OSError):  # stopped when the shell returned
            _get_json(started[0], "/api/status")


def test_use_pedal_needs_mido(tmp_path, monkeypatch, ct_file):
    """--use-pedal without mido raises naming it, as the JAX app does."""
    import sys

    monkeypatch.setitem(sys.modules, "mido", None)  # not importable
    with pytest.raises(RuntimeError, match="mido"):
        app.main(["--import-file", str(ct_file), "--use-pedal"], device="cpu")
    with pytest.raises(RuntimeError, match="mido"):
        app_jax.main(["--import-file", str(ct_file), "--use-pedal"])


def test_use_pedal_connects_a_midi_pedal(tmp_path, monkeypatch, ct_file):
    """--use-pedal with a (fake) mido opens its first input port."""
    import sys
    import types

    opened = []

    class Port:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def iter_pending(self):
            return iter(())

    def open_input(name):
        opened.append(name)
        return Port()

    fake = types.SimpleNamespace(get_input_names=lambda: ["pedal-0", "pedal-1"],
                                 open_input=open_input)
    monkeypatch.setitem(sys.modules, "mido", fake)
    from invesalius3_tpu_torch.net import pedal_connection

    made = []
    init = pedal_connection.MidiPedal.__init__

    def record(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(pedal_connection.MidiPedal, "__init__", record)
    assert app.main(["--import-file", str(ct_file), "--use-pedal"], device="cpu") == 0
    (pedal,) = made
    pedal.stop()
    pedal._thread.join(5)
    assert pedal.port_name == "pedal-0" and opened == ["pedal-0"]


def _triangles(path) -> int:
    return (Path(path).stat().st_size - 84) // 50


def _dicom_series(root, ct, series="1.2.826.0.1.3680043.2.1125.1", modality="CT",
                  intercept=0.0, **extra):
    """``ct`` written slice by slice by the JAX package's writer, spacing
    SPACING, file names shuffled (int16 pixels, or uint16 shifted by the
    intercept)."""
    from invesalius3_tpu.io import dicom as dicom_jax

    root.mkdir(parents=True, exist_ok=True)
    order = np.random.default_rng(1).permutation(len(ct))
    for name, z in enumerate(order):
        px = ct[z] if not intercept else (ct[z] - intercept).astype(np.uint16)
        dicom_jax.write_dicom(root / f"IM{name:04d}", px, {
            "PatientID": "P1", "PatientName": "Phantom", "Modality": modality,
            "StudyInstanceUID": "1.2.826.0.1.3680043.2.1125", "SeriesInstanceUID": series,
            "InstanceNumber": int(z) + 1, "ImageOrientationPatient": [1, 0, 0, 0, 1, 0],
            "ImagePositionPatient": [-12.0, -14.4, SPACING[2] * int(z)],
            "PixelSpacing": [SPACING[1], SPACING[0]], "RescaleSlope": 1.0,
            "RescaleIntercept": intercept, **extra})
    return root


@pytest.mark.parametrize("case", ["Default", "ca_smoothing", "MR"])
def test_dicom_import(tmp_path, monkeypatch, case):
    """-i: the series read, thresholded with the modality's preset, its
    surface and the saved project equal the JAX app's."""
    modality = "MR" if case == "MR" else "CT"
    series = _dicom_series(tmp_path / "series", _ct(48), modality=modality)
    algorithm = "ca_smoothing" if case == "ca_smoothing" else "Default"
    port, jax_ = _run(tmp_path, monkeypatch, [
        "-i", str(series), "-t", "Bone", "-e", "{out}/bone.stl", "-s", "{out}/proj.inv3",
        "--algorithm", algorithm])
    _same_stl(port / "bone.stl", jax_ / "bone.stl", algorithm == "ca_smoothing")
    assert _triangles(port / "bone.stl") > 1000
    if algorithm == "Default":
        main = plistlib.loads(_same_inv3(port / "proj.inv3", jax_ / "proj.inv3")["main.plist"])
        assert main["modality"] == modality


def test_dicom_import_takes_the_largest_series(tmp_path, monkeypatch):
    root = tmp_path / "study"
    _dicom_series(root / "a", _ct(20), series="1.2.3.20")
    _dicom_series(root / "b", _ct(24)[:, :22], series="1.2.3.24", intercept=-1024.0)
    port, jax_ = _run(tmp_path, monkeypatch, [
        "-i", str(root), "-t", "Bone", "-e", "{out}/bone.stl", "-s", "{out}/proj.inv3"])
    _same_stl(port / "bone.stl", jax_ / "bone.stl")
    assert _triangles(port / "bone.stl") > 1000
    members = _same_inv3(port / "proj.inv3", jax_ / "proj.inv3")
    assert plistlib.loads(members["main.plist"])["matrix"]["shape"] == [24, 22, 24]


def test_import_all_one_surface_a_series(tmp_path, monkeypatch):
    """--import-all: a surface for each series, named by the last eight
    characters of its UID; the second series is gantry-tilted."""
    root = tmp_path / "study"
    _dicom_series(root, _ct(32), series="1.2.840.99.11111111")
    _dicom_series(root / "tilted", _ct(24), series="1.2.840.99.22222222",
                  intercept=-1024.0, GantryDetectorTilt=12.0)
    port, jax_ = _run(tmp_path, monkeypatch, [
        "-i", str(root), "--import-all", "-t", "Bone", "-e", "{out}/skull.stl"])
    names = sorted(p.name for p in port.iterdir())
    assert names == sorted(p.name for p in jax_.iterdir())
    assert names == ["skull_11111111.stl", "skull_22222222.stl"]
    for name in names:
        _same_stl(port / name, jax_ / name)
        assert _triangles(port / name) > 1000


def test_import_folder_with_spacing(tmp_path, monkeypatch):
    from PIL import Image

    stack = tmp_path / "stack"
    stack.mkdir()
    for z, sl in enumerate(_ct(40) + 1024):
        Image.fromarray(sl.astype(np.uint16)).save(stack / f"slice{z + 1}.png")
    port, jax_ = _run(tmp_path, monkeypatch, [
        "--import-folder", str(stack), "--spacing", "0.5,0.6,0.7", "-t", "2000,3071",
        "-e", "{out}/bone.stl", "-s", "{out}/proj.inv3"])
    _same_stl(port / "bone.stl", jax_ / "bone.stl")
    assert _triangles(port / "bone.stl") > 1000
    members = _same_inv3(port / "proj.inv3", jax_ / "proj.inv3")
    assert plistlib.loads(members["main.plist"])["spacing"] == [0.5, 0.6, 0.7]


@pytest.mark.parametrize("rescale", [False, True])
def test_parrec_import_file(tmp_path, monkeypatch, rescale):
    """A PAR/REC pair through --import-file (the REC file named): int16
    without a rescale, float32 with one."""
    ct = _ct(32)
    nz, ny, nx = ct.shape
    rs, ri = (0.5, -1000.0) if rescale else (1.0, 0.0)
    rows = [" ".join(f"{v:g}" for v in [sl, 1, 1, 1, 0, 0, sl - 1, 16, 100, nx, ny, ri, rs,
                                        1.0, 50, 100] + [0.0] * 12 + [0.6, 0.5] + [0.0] * 3)
            for sl in range(1, nz + 1)]
    (tmp_path / "ct.PAR").write_text("\n".join([
        "# Research image export tool     V4.2",
        f".    Max. number of slices/locations    :   {nz}",
        f".    Recon resolution (x, y)            :   {nx}  {ny}",
        ".    Slice thickness [mm]               :   0.700",
        ".    Slice gap [mm]                     :   0.000"] + rows) + "\n")
    pv = ((ct - ri) / rs).astype("<i2")
    pv.tofile(tmp_path / "ct.REC")
    port, jax_ = _run(tmp_path, monkeypatch, [
        "--import-file", str(tmp_path / "ct.REC"), "-t", "Bone", "-e", "{out}/bone.stl",
        "-s", "{out}/proj.inv3"])
    _same_stl(port / "bone.stl", jax_ / "bone.stl")
    assert _triangles(port / "bone.stl") > 1000
    _same_inv3(port / "proj.inv3", jax_ / "proj.inv3")


def test_import_errors_exit_as_the_jax_app(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    (tmp_path / "empty").mkdir()
    for argv, match in ((["-i", str(tmp_path / "empty")], "no DICOM series"),
                        (["-i", str(tmp_path / "empty"), "--import-all"], "no DICOM series"),
                        (["--import-all"], "no input given"),
                        ([], "no input given")):
        for main in (lambda a: app.main(a, device="cpu"), app_jax.main):
            with pytest.raises(SystemExit, match=match):
                main(argv)


def test_defaults_to_the_card_and_debug_prints_events(tmp_path, monkeypatch, ct_file, capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            app.main(["--import-file", str(ct_file)])
    try:
        assert app.main(["--import-file", str(ct_file), "-t", "Bone", "--debug"],
                        device="cpu") == 0
    finally:
        events.bus.clear(events.ALL_TOPICS)
    err = capsys.readouterr().err
    assert "[event] slice.mask_added" in err and "threshold [226, 3071]" in err
    parsed = app.parse_command_line(["--quality", "Low", "--algorithm", "Binary"])
    assert vars(parsed).keys() == vars(app_jax.parse_command_line([])).keys()

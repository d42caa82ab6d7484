"""The port's viewer server (``invesalius3_tpu_torch.server``) end to end on
the CPU: the JAX package's server tests (tests/test_server.py) run against
it, with ``device="cpu"``, on the same 16x24x24 phantom.  The session and
the translations write under a temporary ``XDG_CONFIG_HOME``.
DICOM series are written by the JAX test helper ``tests.test_io._make_series``."""

import json
import urllib.request

import numpy as np
import pytest

import torch

from invesalius3_tpu_torch.core.slice import Slice
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.net import download
from invesalius3_tpu_torch.server import ViewerServer

torch.set_num_threads(1)


def _refuse(url, *a, **kw):
    raise OSError(f"the tests fetch nothing ({url})")


@pytest.fixture(scope="module", autouse=True)
def config_home(tmp_path_factory):
    """A temporary user directory, the default language, and no download
    (the DL jobs run random weights)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XDG_CONFIG_HOME", str(tmp_path_factory.mktemp("config")))
        mp.delenv("INV3_LANGUAGE", raising=False)
        mp.setattr(download, "download_url_to_file", _refuse)
        yield


def _slice(ct, spacing=(1.0, 1.0, 1.0)):
    return Slice(Volume.from_numpy(ct, spacing=spacing, device="cpu"))


@pytest.fixture(scope="module")
def server():
    zz, yy, xx = np.mgrid[:16, :24, :24].astype(np.float32)
    r = np.sqrt((zz - 8) ** 2 + (yy - 12) ** 2 + (xx - 12) ** 2)
    ct = np.full((16, 24, 24), -1000, np.int16)
    ct[r < 8] = 1400
    srv = ViewerServer(_slice(ct)).start()
    yield srv
    srv.stop()


def _get(server, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}") as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(server, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req) as r:
        return r.status, json.loads(r.read())


def test_status(server):
    code, ctype, body = _get(server, "/api/status")
    assert code == 200
    st = json.loads(body)
    assert st["volume_shape"] == [16, 24, 24]


def test_threshold_and_masks(server):
    code, out = _post(server, "/api/threshold", {"tmin": 226, "tmax": 3071})
    assert code == 200 and out["voxels"] > 0
    code, _, body = _get(server, "/api/masks")
    masks = json.loads(body)
    assert len(masks) >= 1
    assert masks[0]["threshold_range"] == [226, 3071]


def test_slice_png(server):
    code, ctype, body = _get(server, "/api/slice/AXIAL/8?ww=2000&wl=300")
    assert code == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    # MIP projection via query
    code, _, body2 = _get(server, "/api/slice/AXIAL/0?projection=1&slabs=8")
    assert code == 200


def test_render_png(server):
    code, ctype, body = _get(server, "/api/render?size=64&steps=32&preset=Bone")
    assert code == 200 and body[:4] == b"\x89PNG"


def test_surface_create_and_download(server):
    _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    code, out = _post(server, "/api/surface", {"algorithm": "Default"})
    assert code == 200 and out["triangles"] > 0
    idx = out["index"]
    code, ctype, body = _get(server, f"/api/surface/{idx}.stl")
    assert code == 200
    assert len(body) == 84 + 50 * out["triangles"]  # binary STL layout


def test_floodfill_endpoint(server):
    code, out = _post(server, "/api/floodfill",
                      {"seed": [8, 12, 12], "tmin": 226, "tmax": 3071})
    assert code == 200 and out["voxels"] > 0


def test_error_surface(server):
    import urllib.error

    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server, "/api/slice/AXIAL/notanumber")
    assert exc.value.code == 500
    with pytest.raises(urllib.error.HTTPError) as exc2:
        _get(server, "/api/nope")
    assert exc2.value.code == 404


def test_events_endpoint_records(server):
    # trigger a bus event via a threshold POST, then read /api/events
    _post(server, "/api/threshold", {"tmin": 0, "tmax": 100})
    code, _, body = _get(server, "/api/events")
    evs = json.loads(body)
    assert any(e["topic"].startswith("slice.mask") or e["topic"] == "mask.created"
               for e in evs)


def test_client_page_and_presets(server):
    code, ctype, body = _get(server, "/")
    assert code == 200 and "text/html" in ctype
    assert b"invesalius3_tpu" in body and b"/viewer/app.js" in body
    code, ctype, body = _get(server, "/viewer/app.js")
    assert code == 200 and "javascript" in ctype
    assert b"/api/slice/" in body and b"/api/brush" in body
    with pytest.raises(urllib.error.HTTPError):  # no traversal
        _get(server, "/viewer/%2e%2e/server.py")
    code, _, body = _get(server, "/api/presets")
    p = json.loads(body)
    assert "Bone" in p["threshold_ct"] and "Bone" in p["raycast"]


def test_clut_editor_endpoints(server, tmp_path, monkeypatch):
    """CLUT editor flow: load editable nodes, edit, bake, render with the
    custom preset, persist to the user preset dir (reference
    clut_raycasting.py + control.py SaveRaycastingPreset)."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    code, _, body = _get(server, "/api/raycast/nodes?name=Bone")
    assert code == 200
    nodes = json.loads(body)
    assert nodes["lo"] < nodes["hi"] and len(nodes["alpha_nodes"]) >= 2
    # edit: crank alpha, rename, apply (unsaved)
    nodes["alpha_nodes"] = [[nodes["lo"], 0.0], [nodes["hi"], 1.0]]
    nodes["name"] = "My Edit"
    code, r = _post(server, "/api/raycast/preset", nodes)
    assert code == 200 and r["name"] == "My Edit" and r["saved"] is None
    code, _, body = _get(server, "/api/presets")
    assert "My Edit" in json.loads(body)["raycast"]
    code, ctype, body = _get(server,
                             "/api/render?size=48&preset=My%20Edit")
    assert code == 200 and body[:4] == b"\x89PNG"
    # node view of the live custom preset comes back from memory
    code, _, body = _get(server, "/api/raycast/nodes?name=My%20Edit")
    assert code == 200 and json.loads(body)["name"] == "My Edit"
    # save: persists a plist loadable by load_preset
    nodes["save"] = True
    code, r = _post(server, "/api/raycast/preset", nodes)
    assert code == 200 and r["saved"] and r["saved"].endswith(".plist")
    from invesalius3_tpu_torch.ops import raycast

    p = raycast.load_preset("My Edit")
    assert p.rgba.shape[1] == 4 and p.rgba[:, 3].max() > 0.9


def test_get_slice_is_stateless(server):
    slc = server.state.slice
    ww0, wl0, proj0 = slc.window_width, slc.window_level, slc.projection_type
    code, ctype, _ = _get(server, "/api/slice/AXIAL/8?ww=123&wl=45&projection=1&slabs=4")
    assert code == 200 and ctype == "image/png"
    assert (slc.window_width, slc.window_level, slc.projection_type) == (ww0, wl0, proj0)
    # POST /api/window actually mutates
    code, r = _post(server, "/api/window", {"ww": 900, "wl": 100})
    assert code == 200 and slc.window_width == 900


def test_mask_boolean_crop_undo_endpoints(server):
    _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    _post(server, "/api/threshold", {"tmin": -2000, "tmax": 2000})
    masks = json.loads(_get(server, "/api/masks")[2])
    assert len(masks) >= 2
    i1, i2 = masks[-2]["index"], masks[-1]["index"]
    code, r = _post(server, "/api/boolean", {"op": 2, "index1": i2, "index2": i1})
    assert code == 200 and r["voxels"] > 0
    code, r = _post(server, "/api/crop", {"limits": [2, 12, 2, 20, 2, 20]})
    assert code == 200 and r["limits"] == [2, 12, 2, 20, 2, 20]
    code, r = _post(server, "/api/mask/undo", {})
    assert code == 200 and r["ok"] is True
    code, r = _post(server, "/api/mask/redo", {})
    assert code == 200 and r["ok"] is True


def test_measures_endpoints(server):
    code, m = _post(server, "/api/measures",
                    {"kind": "linear", "p1": [0, 0, 0], "p2": [3, 4, 0]})
    assert code == 200 and abs(m["value"] - 5.0) < 1e-6
    code, m2 = _post(server, "/api/measures",
                     {"kind": "angular", "p0": [1, 0, 0], "p1": [0, 0, 0],
                      "p2": [0, 1, 0]})
    assert abs(m2["value"] - 90.0) < 1e-4
    lst = json.loads(_get(server, "/api/measures")[2])
    assert len(lst) >= 2
    code, r = _post(server, "/api/measures/remove", {"index": m["index"]})
    assert code == 200
    lst2 = json.loads(_get(server, "/api/measures")[2])
    assert len(lst2) == len(lst) - 1


def test_image_version_endpoints(server):
    code, r = _post(server, "/api/filter", {"type": 2, "value": 1.0})
    assert code == 200 and r["label"].startswith("Filtered")
    v = json.loads(_get(server, "/api/image_versions")[2])
    assert v["current"] == r["label"] and "original" in v["versions"]
    code, r2 = _post(server, "/api/image_versions/select", {"label": "original"})
    assert code == 200 and r2["current"] == "original"


# ---------------------------------------------------------------------------
# Web-client walkthrough: replay the exact HTTP sequence viewer/app.js
# performs for "load CT -> paint mask -> create surface -> download STL"
# (no browser in this environment; the client's call contract is pinned
# here instead, plus a selector-consistency check of the static files).
# ---------------------------------------------------------------------------


def test_client_walkthrough_sequence(server):
    # init(): status + presets + image_versions + slices + render + lists
    _, _, body = _get(server, "/api/status")
    st = json.loads(body)
    Z, Y, X = st["volume_shape"]
    _, _, body = _get(server, "/api/presets")
    presets = json.loads(body)
    assert "Bone" in presets["threshold_ct"]
    _get(server, "/api/image_versions")
    code, ctype, _ = _get(server, f"/api/slice/axial/{Z // 2}?ww=2000&wl=300"
                                  f"&projection=0&slabs=1&t=1")
    assert code == 200 and "png" in ctype
    code, _, _ = _get(server, "/api/render?azimuth=30&elevation=20&size=64&t=2")
    assert code == 200
    _get(server, "/api/masks")
    _get(server, "/api/measures")

    # threshold preset -> new mask (do-threshold button)
    lo, hi = presets["threshold_ct"]["Bone"]
    _, mask_info = _post(server, "/api/threshold", {"tmin": lo, "tmax": hi})
    assert mask_info["voxels"] > 0

    # paint brush stroke (paint tool drag)
    stroke = [[Z // 2, Y // 2, x] for x in range(4, 12)]
    _, r = _post(server, "/api/brush",
                 {"strokes": stroke, "radius_mm": 3.0, "erase": False})
    assert r["stamps"] == len(stroke) and r["voxels"] > mask_info["voxels"]

    # erase part of it
    _, r2 = _post(server, "/api/brush",
                  {"strokes": stroke[:2], "radius_mm": 3.0, "erase": True})
    assert r2["voxels"] < r["voxels"]

    # a plain paint/erase stroke (no threshold_range in the body) must
    # preserve the mask's stored edition_threshold_range — the viewer
    # only sends the range with threshold ops (reference styles.py 1361
    # keeps the editor config independent of plain draw strokes)
    _post(server, "/api/brush", {"strokes": stroke[:1], "radius_mm": 2.0,
                                 "op": "threshold",
                                 "threshold_range": [100, 900]})
    _post(server, "/api/brush", {"strokes": stroke[:1], "radius_mm": 2.0,
                                 "op": "paint"})
    assert tuple(server.state.slice.current_mask.edition_threshold_range
                 ) == (100, 900)

    # measure placement (linear tool, 2 clicks) + annotation
    _, m = _post(server, "/api/measures",
                 {"kind": "linear", "p1": [10.0, 20.0, float(Z // 2)],
                  "p2": [40.0, 20.0, float(Z // 2)],
                  "location": "AXIAL", "slice_number": Z // 2})
    assert m["value"] == 30.0
    _post(server, "/api/measures",
          {"kind": "annotation", "point": [20.0, 30.0, float(Z // 2)],
           "text": "LESION", "location": "AXIAL", "slice_number": Z // 2})
    # overlays appear on the slice (PNG differs from overlay-free render)
    _, _, with_ovl = _get(server, f"/api/slice/axial/{Z // 2}?t=3")
    _, _, without = _get(server, f"/api/slice/axial/{Z // 2}?overlays=0&t=4")
    assert with_ovl != without

    # surface create + STL download (do-surface button + list link)
    _, surf = _post(server, "/api/surface", {"algorithm": "Default"})
    assert surf["triangles"] > 0
    code, ctype, stl = _get(server, f"/api/surface/{surf['index']}.stl")
    assert code == 200 and len(stl) > 84
    import struct

    n_tris = struct.unpack("<I", stl[80:84])[0]
    assert n_tris == surf["triangles"]


def test_client_static_files_consistent():
    """Every DOM id app.js queries must exist in index.html, and the JS
    braces/parens must balance (no JS runtime in this env)."""
    import pathlib
    import re

    root = pathlib.Path(__file__).parent.parent / "invesalius3_tpu_torch" / "viewer"
    html = (root / "index.html").read_text()
    js = (root / "app.js").read_text()
    ids_used = set(re.findall(r'\$\("#([\w-]+)"\)', js))
    ids_defined = set(re.findall(r'id="([\w-]+)"', html))
    missing = ids_used - ids_defined
    assert not missing, f"app.js references missing ids: {missing}"
    stripped = re.sub(r'"(?:[^"\\]|\\.)*"|\'(?:[^\'\\]|\\.)*\'|`(?:[^`\\]|\\.)*`|//[^\n]*', "", js)
    for o, c in ("{}", "()", "[]"):
        assert stripped.count(o) == stripped.count(c), f"unbalanced {o}{c}"
    # endpoints referenced by the client all exist in the server routing
    srv = (pathlib.Path(__file__).parent.parent / "invesalius3_tpu_torch" /
           "server.py").read_text()
    for ep in set(re.findall(r'"(/api/[\w/]+)"', js)):
        assert ep in srv, f"client calls unrouted endpoint {ep}"


def test_dicom_import_endpoints(server, tmp_path):
    from tests.test_io import _make_series

    _make_series(tmp_path, n=4)
    import urllib.parse

    d = urllib.parse.quote(str(tmp_path))
    _, _, body = _get(server, f"/api/dicom/scan?dir={d}")
    series = json.loads(body)
    assert len(series) == 1 and series[0]["n_slices"] == 4
    code, ctype, png = _get(server,
                            f"/api/dicom/thumb?dir={d}&size=16"
                            f"&series={series[0]['series_uid']}")
    assert code == 200 and png[:4] == b"\x89PNG"


def test_navigation_endpoints(server):
    """Headless navigator-task workflow over HTTP (reference
    task_navigator.py): connect debug tracker -> capture fiducials ->
    register -> navigate -> markers."""
    import time as _t

    code, r = _post(server, "/api/nav/connect", {"tracker_id": "debug_random",
                                                 "poll_hz": 500})
    assert code == 200 and r["connected"]
    _t.sleep(0.05)
    _, _, body = _get(server, "/api/nav/status")
    st = json.loads(body)
    assert st["tracker_connected"] and "debug_random" in st["trackers"]
    for i in range(3):
        _post(server, "/api/nav/fiducial/tracker", {"index": i})
        _t.sleep(0.02)
        _post(server, "/api/nav/fiducial/image",
              {"index": i, "position": [float(i * 10), 0.0, 5.0]})
    code, r = _post(server, "/api/nav/register", {})
    assert code == 200 and r["fre"] >= 0.0
    code, r = _post(server, "/api/nav/start", {"poll_hz": 100})
    assert r["navigating"]
    _t.sleep(0.1)
    code, r = _post(server, "/api/nav/stop", {})
    assert not r["navigating"]
    code, r = _post(server, "/api/nav/markers",
                    {"position": [1.0, 2.0, 3.0], "label": "M1"})
    mid = r["id"]
    lst = json.loads(_get(server, "/api/nav/markers")[2])
    assert any(m["id"] == mid for m in lst)
    _post(server, "/api/nav/markers/remove", {"id": mid})
    lst2 = json.loads(_get(server, "/api/nav/markers")[2])
    assert not any(m["id"] == mid for m in lst2)
    _post(server, "/api/nav/disconnect", {})


def test_nav_tracts_and_efield_workers(server):
    """Tract + e-field workers configured over HTTP run inside the
    navigation pipeline and land results on the bus / scene (reference
    task_tractography.py + task_efield.py spawned by StartNavigation)."""
    import time as _t

    # e-field needs a surface ROI
    _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    _post(server, "/api/surface", {"name": "roi"})
    code, r = _post(server, "/api/nav/tracts", {"enable": True, "n_tracts": 4,
                                                "n_steps": 5})
    assert code == 200 and r["tracts_enabled"] and r["n_tracts"] == 4
    code, r = _post(server, "/api/nav/efield", {"enable": True})
    assert code == 200 and r["efield_enabled"] and r["roi_vertices"] > 0
    st = json.loads(_get(server, "/api/nav/status")[2])
    assert st["tracts_enabled"] and st["efield_enabled"]

    _post(server, "/api/nav/connect", {"tracker_id": "debug_random",
                                       "poll_hz": 500})
    _t.sleep(0.05)
    for i in range(3):
        _post(server, "/api/nav/fiducial/tracker", {"index": i})
        _t.sleep(0.02)
        _post(server, "/api/nav/fiducial/image",
              {"index": i, "position": [float(i * 10), 0.0, 5.0]})
    _post(server, "/api/nav/register", {})
    _post(server, "/api/nav/start", {"poll_hz": 100})
    deadline = _t.monotonic() + 30.0  # first pose compiles both kernels
    seen = set()
    while _t.monotonic() < deadline and seen < {"navigation.tracts",
                                                "navigation.efield"}:
        evs = json.loads(_get(server, "/api/events")[2])
        seen = {e["topic"] for e in evs} & {"navigation.tracts",
                                            "navigation.efield"}
        _t.sleep(0.1)
    assert seen == {"navigation.tracts", "navigation.efield"}
    # scene render composes tract ribbons + e-field texture without error
    code, ctype, png = _get(server,
                            "/api/render_scene?efield=1&size=64")
    assert code == 200 and ctype == "image/png"
    _post(server, "/api/nav/stop", {})
    _post(server, "/api/nav/disconnect", {})
    # disable clears config + cached payloads
    _post(server, "/api/nav/tracts", {"enable": False})
    _post(server, "/api/nav/efield", {"enable": False})
    st = json.loads(_get(server, "/api/nav/status")[2])
    assert not st["tracts_enabled"] and not st["efield_enabled"]


def test_mask_row_ops_and_fill_holes(server):
    """Data-notebook mask row ops + automatic hole fill over HTTP
    (reference data_notebook.py mask page, mask.py:519 fill_holes_auto)."""
    _, r = _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    idx = r["index"]
    # punch a hole through the mask via a brush erase, then auto-fill
    _, r2 = _post(server, "/api/mask/fill_holes", {"max_size": 10000})
    assert r2["filled_voxels"] >= 0
    # duplicate -> rename/recolour -> remove
    _, d = _post(server, "/api/mask/duplicate", {"index": idx})
    assert d["index"] != idx and "copy" in d["name"]
    _, p = _post(server, "/api/mask/props",
                 {"index": d["index"], "name": "renamed",
                  "colour": [0.1, 0.2, 0.3]})
    assert p["name"] == "renamed" and p["colour"] == [0.1, 0.2, 0.3]
    masks = json.loads(_get(server, "/api/masks")[2])
    assert any(m["name"] == "renamed" for m in masks)
    _, rm = _post(server, "/api/mask/remove", {"index": d["index"]})
    assert rm["ok"]
    masks2 = json.loads(_get(server, "/api/masks")[2])
    assert not any(m["index"] == d["index"] for m in masks2)


def test_render_scene_slice_plane(server):
    """?slice=ORIENT:index composes the slice as a textured plane in the
    3D scene (reference viewer_volume.py:4007 SlicePlane)."""
    code, _, plain = _get(server, "/api/render_scene?size=96")
    code2, _, with_plane = _get(server,
                                "/api/render_scene?size=96&slice=AXIAL:8")
    assert code == 200 and code2 == 200
    assert with_plane[:4] == b"\x89PNG" and with_plane != plain
    # sagittal + default index also render
    code3, _, _ = _get(server, "/api/render_scene?size=64&slice=SAGITTAL:")
    assert code3 == 200


def test_mask_cut3d(server):
    """Screen-space polygon cut of the mask through the 3D scene camera
    (reference Mask3DEditorState + mask_cut)."""
    _, r = _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    _, st0 = _post(server, "/api/mask/stats", {})
    # left half of a 128px scene at a frontal view cuts ~half the sphere
    code, c = _post(server, "/api/mask/cut3d",
                    {"polygon": [[0, 0], [63, 0], [63, 127], [0, 127]],
                     "azimuth": 0, "elevation": 0, "size": 128})
    assert code == 200 and 0 < c["cut_voxels"] < st0["voxels"]
    frac = c["cut_voxels"] / st0["voxels"]
    assert 0.25 < frac < 0.75
    _, st1 = _post(server, "/api/mask/stats", {})
    assert st1["voxels"] == st0["voxels"] - c["cut_voxels"]
    _post(server, "/api/mask/undo", {})
    _, st2 = _post(server, "/api/mask/stats", {})
    assert st2["voxels"] == st0["voxels"]
    _post(server, "/api/mask/remove", {"index": r["index"]})


def test_mask_part_select_remove(server):
    """Connected-part select/remove by seed click (reference styles.py
    Select/RemoveMaskParts)."""
    _, r = _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    code, sel = _post(server, "/api/mask/part",
                      {"seed": [8, 12, 12], "op": "remove"})
    assert code == 200 and sel["voxels"] > 0
    _, st = _post(server, "/api/mask/stats", {})
    assert st["voxels"] == 0  # single sphere component fully removed
    _, _ = _post(server, "/api/mask/undo", {})
    _, st2 = _post(server, "/api/mask/stats", {})
    assert st2["voxels"] == sel["voxels"]  # undo restores the part
    _post(server, "/api/mask/remove", {"index": r["index"]})


def test_floodfill_methods(server):
    """Region-grow methods over HTTP: dynamic range + confidence
    (reference FFillSegmentationConfig styles.py:2991-3015)."""
    _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    code, r = _post(server, "/api/floodfill",
                    {"seed": [8, 12, 12], "method": "dynamic",
                     "dev_min": 300, "dev_max": 300})
    assert code == 200 and r["voxels"] > 0
    code, r2 = _post(server, "/api/floodfill",
                     {"seed": [8, 12, 12], "method": "confidence",
                      "mult": 2.5, "iters": 2})
    assert code == 200 and r2["voxels"] > 0


def test_mask_stats_endpoint(server):
    """POST /api/mask/stats: surface area + under-mask density stats
    (reference calc_mask_area / calc_image_density)."""
    _, r = _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    code, s = _post(server, "/api/mask/stats", {})
    assert code == 200 and s["voxels"] > 0 and s["area_mm2"] > 0
    assert 1000 <= s["density"]["min"] <= s["density"]["mean"] \
        <= s["density"]["max"] <= 2000
    _post(server, "/api/mask/remove", {"index": r["index"]})


def test_mask_nifti_import_export(server, tmp_path):
    """Mask round-trip through NIfTI label maps over HTTP (reference
    control.py:264/:353 mask import/export)."""
    _, r = _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    p = str(tmp_path / "mask.nii.gz")
    code, e = _post(server, "/api/mask/export", {"path": p})
    assert code == 200 and e["voxels"] > 0
    code, i = _post(server, "/api/mask/import", {"path": p,
                                                 "name": "from_nifti"})
    assert code == 200 and i["name"] == "from_nifti"
    masks = json.loads(_get(server, "/api/masks")[2])
    assert any(m["name"] == "from_nifti" for m in masks)
    _post(server, "/api/mask/remove", {"index": i["index"]})
    _post(server, "/api/mask/remove", {"index": r["index"]})


def test_image_transform_endpoints():
    """Image-menu flip / axis swap / reorient over HTTP (reference
    frame.py menu + slice_.py flip/swap/apply_reorientation)."""
    ct = np.zeros((8, 12, 16), np.int16)
    ct[1, 2, 3] = 500  # asymmetric witness voxel
    srv = ViewerServer(_slice(ct, spacing=(1.0, 2.0, 3.0))).start()
    try:
        code, r = _post(srv, "/api/image/flip", {"axis": 0})
        assert code == 200
        assert float(srv.state.slice.matrix.numpy()[6, 2, 3]) == 500
        _, r = _post(srv, "/api/image/swap", {"axes": [0, 2]})
        assert r["shape"] == [16, 12, 8]
        assert float(srv.state.slice.matrix.numpy()[3, 2, 6]) == 500
        code, r = _post(srv, "/api/image/reorient",
                        {"angles": [0.0, 0.0, 0.3]})
        assert code == 200
        m = srv.state.slice.matrix.numpy()
        assert m.shape == (16, 12, 8) and m.max() > 0  # resampled in place
    finally:
        srv.stop()


def test_session_crash_recovery_endpoints(server, tmp_path):
    """GET /api/session reports crash state; POST /api/session/recover
    opens the auto-backup (reference splash CheckCrashRecovery)."""
    from invesalius3_tpu_torch.core.project import Project
    from invesalius3_tpu_torch.core.session import Session

    # stage a crashed session with a backup in an isolated user dir
    s = Session(user_dir=tmp_path / "cfg")
    proj = Project()
    proj.volume = Volume.from_numpy(np.full((4, 4, 4), 7, np.int16), device="cpu")
    proj.name = "crashcase"
    s.mark_running()
    s.create_auto_backup(proj, interval_s=0.1)
    import time as _t

    _t.sleep(0.4)
    s.stop_auto_backup()
    # a NEW session object sees the unclean exit (simulated crash)
    old = getattr(server.state, "_session", None)
    orig_vol = server.state.slice.volume
    server.state._session = Session(user_dir=tmp_path / "cfg")
    try:
        st = json.loads(_get(server, "/api/session")[2])
        assert not st["exited_successfully_last_time"]
        assert st["backup_path"] and st["backup_path"].endswith(".inv3")
        code, r = _post(server, "/api/session/recover", {})
        assert code == 200 and r["name"] == "crashcase"
        assert r["shape"] == [4, 4, 4]
    finally:  # restore the shared fixture volume for later tests
        server.state._session = old
        server.state.slice.load_new_volume(orig_vol)
        server.state.slice.masks.clear()
        server.state.slice.current_mask = None
        server.state.surfaces = {}


def test_histogram_endpoint(server):
    """GET /api/histogram returns the intensity histogram backing the
    WW/WL curve widget (reference clut_imagedata.py)."""
    code, _, body = _get(server, "/api/histogram?bins=32")
    h = json.loads(body)
    assert code == 200 and len(h["counts"]) == 32 and len(h["edges"]) == 33
    # fixture volume: air background dominates the lowest bin
    assert h["counts"][0] == max(h["counts"])
    assert sum(h["counts"]) == 16 * 24 * 24
    assert h["ww"] > 0


def test_surface_export_all_merged(server):
    """GET /api/surface/all.stl merges every visible surface before
    exporting (reference surface.py:1782 + polydata_utils Merge)."""
    _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    _, a = _post(server, "/api/surface", {})
    _, b = _post(server, "/api/surface", {})
    visible_tris = sum(s["triangles"] for s in
                       json.loads(_get(server, "/api/surfaces")[2])
                       if s["visible"])  # incl. other tests' leftovers
    code, ctype, data = _get(server, "/api/surface/all.stl")
    assert code == 200
    n_tris = int.from_bytes(data[80:84], "little")
    assert n_tris == visible_tris >= a["triangles"] + b["triangles"]
    # hidden surfaces are excluded
    _post(server, "/api/surface/props", {"index": b["index"],
                                         "visible": False})
    _, _, data2 = _get(server, "/api/surface/all.stl")
    assert int.from_bytes(data2[80:84], "little") \
        == visible_tris - b["triangles"]
    for idx in (a["index"], b["index"]):
        _post(server, "/api/surface/remove", {"index": idx})


def test_surface_remove_non_visible(server):
    """POST /api/surface/remove_non_visible culls enclosed faces
    (reference task_navigator.py:916 / polydata_utils.py:363)."""
    _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    _, out = _post(server, "/api/surface", {"algorithm": "Default"})
    code, r = _post(server, "/api/surface/remove_non_visible",
                    {"index": out["index"]})
    assert code == 200 and 0.0 < r["kept_ratio"] <= 1.0
    assert r["triangles"] <= out["triangles"]
    surfs = json.loads(_get(server, "/api/surfaces")[2])
    s = next(x for x in surfs if x["index"] == out["index"])
    assert s["triangles"] == r["triangles"]
    _post(server, "/api/surface/remove", {"index": out["index"]})


def test_density_polygon_measure(server):
    """kind=density_polygon computes ROI stats over the polygon interior
    (reference measures.py:2138 PolygonDensityMeasure)."""
    code, m = _post(server, "/api/measures",
                    {"kind": "density_polygon", "location": "AXIAL",
                     "slice_number": 8,
                     "points_yx": [[6, 6], [6, 18], [18, 18], [18, 6]]})
    assert code == 200 and m["type"] == "density_polygon"
    # fixture sphere (r<8 at slice 8 = equator) => mix of 1400 and -1000
    assert -1000 <= m["extra"]["mean"] <= 1400
    assert m["extra"]["area_px"] > 50
    _post(server, "/api/measures/remove", {"index": m["index"]})


def test_measure_props_visibility(server):
    """Measure row visibility toggle hides the overlay in rendered slices
    (reference data_notebook.py measures page + canvas layer)."""
    _, m = _post(server, "/api/measures",
                 {"kind": "linear", "p1": [2.0, 2.0, 2.0],
                  "p2": [20.0, 18.0, 2.0], "location": "AXIAL",
                  "slice_number": 8})
    shown = _get(server, "/api/slice/AXIAL/8")[2]
    _, r = _post(server, "/api/measures/props",
                 {"index": m["index"], "visible": False,
                  "name": "hidden measure"})
    assert r["visible"] is False and r["name"] == "hidden measure"
    hidden = _get(server, "/api/slice/AXIAL/8")[2]
    assert shown != hidden  # overlay disappeared from the render
    # colour edit (viewer colour swatch, reference measures.py:290-302
    # per-measure colour): re-show, recolour, render must change
    _, r = _post(server, "/api/measures/props",
                 {"index": m["index"], "visible": True,
                  "colour": [0.1, 0.9, 0.2]})
    assert r["colour"] == [0.1, 0.9, 0.2]
    green = _get(server, "/api/slice/AXIAL/8")[2]
    assert green != shown and green != hidden
    _post(server, "/api/measures/remove", {"index": m["index"]})


def test_project_props(server):
    """Project name/modality editing (reference project_properties.py)."""
    code, r = _post(server, "/api/project/props",
                    {"name": "case7", "modality": "MR"})
    assert code == 200 and r == {"name": "case7", "modality": "MR"}
    _, r = _post(server, "/api/project/props", {})  # read-back, no change
    assert r == {"name": "case7", "modality": "MR"}
    _post(server, "/api/project/props", {"modality": "CT"})


def test_pedal_marks_probe_position(server):
    """Programmatic pedal over HTTP: press during navigation drops a
    marker at the coregistered probe position (reference
    pedal_connection.py + task_navigator pedal seam)."""
    import time as _t

    _post(server, "/api/nav/connect", {"tracker_id": "debug_random",
                                       "poll_hz": 500})
    _t.sleep(0.05)
    for i in range(3):
        _post(server, "/api/nav/fiducial/tracker", {"index": i})
        _t.sleep(0.02)
        _post(server, "/api/nav/fiducial/image",
              {"index": i, "position": [float(i * 10), 0.0, 5.0]})
    _post(server, "/api/nav/register", {})
    _post(server, "/api/nav/start", {"poll_hz": 200})
    deadline = _t.monotonic() + 5.0
    r = {}
    while _t.monotonic() < deadline and "marker_id" not in r:
        _t.sleep(0.1)  # wait for the first scene pose
        _, r = _post(server, "/api/pedal", {"pressed": True})
    assert r["pressed"] and "marker_id" in r
    _, r2 = _post(server, "/api/pedal", {"pressed": False})
    assert not r2["pressed"] and "marker_id" not in r2
    markers = json.loads(_get(server, "/api/nav/markers")[2])
    assert any(m["label"] == "pedal" for m in markers)
    _post(server, "/api/nav/stop", {})
    _post(server, "/api/nav/markers/remove", {"id": r["marker_id"]})
    _post(server, "/api/nav/disconnect", {})


def test_nav_mtms_endpoints(server, tmp_path):
    """mTMS over HTTP: parameter-table load, offset mapping + dry-run
    pulse, randomized sequence with CSV log (reference mtms.py +
    task panel)."""
    pp = tmp_path / "pp.txt"
    lines = [f"# header {i}" for i in range(18)]
    for x in range(-3, 4):
        for y in range(-3, 4):
            lines.append(f"{x}_{y}_0\tcap1\tcap2")
    pp.write_text("\n".join(lines) + "\n")

    code, r = _post(server, "/api/nav/mtms/load", {"path": str(pp)})
    assert code == 200 and r["n_keys"] == 49
    coil = [10.0, 20.0, 30.0, 0.0, 0.0, 0.0]
    _, r = _post(server, "/api/nav/mtms/target",
                 {"coil_pose": coil,
                  "brain_target": [11.0, 22.0, 30.0, 0.0, 0.0, 0.0]})
    assert r["fired"] and len(r["offset"]) == 3
    _, r = _post(server, "/api/nav/mtms/sequence",
                 {"coil_pose": coil,
                  "brain_targets": [[11.0, 21.0, 30.0, 0.0, 0.0, 0.0],
                                    [9.0, 19.0, 30.0, 0.0, 0.0, 0.0]],
                  "number_of_stim": 2, "save_dir": str(tmp_path)})
    assert r["ok"] and r["pulses"] >= 5  # 1 target pulse + 2x2 sequence
    log = r["log"]
    assert log.endswith(".csv") and "mTMS_target" in open(log).read()


def test_nav_icp_refinement(server):
    """ICP refinement over HTTP: live probe samples against a surface
    (reference iterativeclosestpoint.py + refine dialog)."""
    import time as _t

    _post(server, "/api/threshold", {"tmin": 1000, "tmax": 2000})
    _post(server, "/api/surface", {"name": "head"})
    _post(server, "/api/nav/connect", {"tracker_id": "debug_random",
                                       "poll_hz": 500})
    _t.sleep(0.05)
    for i in range(3):
        _post(server, "/api/nav/fiducial/tracker", {"index": i})
        _t.sleep(0.02)
        _post(server, "/api/nav/fiducial/image",
              {"index": i, "position": [float(i * 10), 0.0, 5.0]})
    _post(server, "/api/nav/register", {})
    code, r = _post(server, "/api/nav/icp",
                    {"n_samples": 5, "poll_hz": 200})
    assert code == 200 and r["use_icp"] and r["n_samples"] == 5
    assert np.isfinite(r["icp_error_mm"])
    _, r = _post(server, "/api/nav/icp", {"enable": False})
    assert not r["use_icp"]
    _post(server, "/api/nav/disconnect", {})


def test_nav_robot_endpoints(server):
    """Robot panel workflow over HTTP (reference task_navigator.py robot
    rows + navigation/robot.py): connect -> objective -> marker target ->
    free drive."""
    import time as _t

    _post(server, "/api/nav/connect", {"tracker_id": "debug_random",
                                       "poll_hz": 500})
    _t.sleep(0.05)
    for i in range(3):
        _post(server, "/api/nav/fiducial/tracker", {"index": i})
        _t.sleep(0.02)
        _post(server, "/api/nav/fiducial/image",
              {"index": i, "position": [float(i * 10), 0.0, 5.0]})
    _post(server, "/api/nav/register", {})

    code, r = _post(server, "/api/nav/robot/connect",
                    {"ip": "192.168.0.5"})
    assert code == 200 and r["connected"]
    _, r = _post(server, "/api/nav/robot/objective",
                 {"objective": "TRACK_TARGET"})
    assert r["objective"] == "TRACK_TARGET"
    _, mk = _post(server, "/api/nav/markers",
                  {"position": [5.0, 6.0, 7.0], "label": "tgt"})
    _, r = _post(server, "/api/nav/robot/target", {"marker_id": mk["id"]})
    m = np.asarray(r["target_tracker"])
    assert m.shape == (4, 4) and np.isfinite(m).all()
    _, r = _post(server, "/api/nav/robot/free_drive", {"enabled": True})
    assert r["free_drive"]
    robots = json.loads(_get(server, "/api/nav/robots")[2])
    assert robots and robots[0]["connected"] \
        and robots[0]["objective"] == "TRACK_TARGET" \
        and robots[0]["has_target"]
    _post(server, "/api/nav/markers/remove", {"id": mk["id"]})
    _post(server, "/api/nav/disconnect", {})


def test_tract_streamline_grid_mapping(tmp_path):
    """Demo tract fields coarser than the volume (f>1) must render
    streamlines through the FIELD-grid -> world converter, not the image
    grid (regression: ribbons rendered f-times compressed)."""
    import time as _t

    zz = np.zeros((80, 80, 80), np.int16)
    srv = ViewerServer(_slice(zz)).start()
    try:
        _, r = _post(srv, "/api/nav/tracts", {"enable": True,
                                              "n_tracts": 2, "n_steps": 4})
        assert r["tracts_enabled"]
        st = srv.state
        conv = st._tract_vox_to_world
        # field is 80//2=40 per axis: coarse voxel (40,40,40) must map to
        # the volume's world center (80 mm voxel * 1 mm spacing)
        w = np.asarray(conv(np.array([[40.0, 40.0, 40.0]])))
        np.testing.assert_allclose(w[0], [80.0, 80.0, 80.0], atol=1e-6)
        # and the worker's world->vox is its inverse on the same grid
        back = st.nav.navigation.tract_params["world_to_vox"](w[0])
        np.testing.assert_allclose(np.asarray(back), [40.0, 40.0, 40.0],
                                   atol=1e-6)
    finally:
        srv.stop()


def test_nav_record_coords(server, tmp_path):
    """Tracker-coordinate CSV recording over HTTP (reference
    record_coords.py checkbox in task_navigator)."""
    import time as _t

    _post(server, "/api/nav/connect", {"tracker_id": "debug_random",
                                       "poll_hz": 500})
    path = str(tmp_path / "coords.csv")
    code, r = _post(server, "/api/nav/record",
                    {"enable": True, "path": path, "poll_hz": 100})
    assert code == 200 and r["recording"] and r["path"] == path
    _t.sleep(0.3)
    code, r = _post(server, "/api/nav/record", {"enable": False})
    assert code == 200 and not r["recording"]
    lines = open(path).read().strip().splitlines()
    assert lines[0].startswith("timestamp,sensor")
    assert len(lines) > 3  # several samples x 3 sensors
    _post(server, "/api/nav/disconnect", {})


def test_overlay_endpoint(server, tmp_path):
    from invesalius3_tpu_torch.io import nifti

    Z, Y, X = server.state.slice.matrix.shape
    act = np.zeros((Z, Y, X), np.float32)
    act[Z // 2, 4:10, 4:10] = 3.0
    act[0, 0, 0] = -1.0
    p = tmp_path / "act.nii"
    nifti.write_nifti(p, act, spacing=(1.0, 1.0, 1.0))
    _, _, before = _get(server, f"/api/slice/axial/{Z // 2}?overlays=0&t=91")
    code, r = _post(server, "/api/overlay",
                    {"path": str(p), "colormap": "hot"})
    assert code == 200
    _, _, after = _get(server, f"/api/slice/axial/{Z // 2}?overlays=0&t=92")
    assert before != after
    _post(server, "/api/overlay/clear", {})
    _, _, cleared = _get(server, f"/api/slice/axial/{Z // 2}?overlays=0&t=93")
    assert cleared == before


def test_config_endpoints(server, tmp_path, monkeypatch):
    # isolate the session dir from the real user config
    import invesalius3_tpu_torch.core.session as sess_mod

    server.state._session = sess_mod.Session(user_dir=tmp_path)
    _, _, body = _get(server, "/api/config")
    cfg = json.loads(body)["config"]
    assert isinstance(cfg, dict)
    code, r = _post(server, "/api/config", {"language": "fr", "slice_interp": 1})
    assert r["config"]["language"] == "fr"
    cfg2 = json.loads(_get(server, "/api/config")[2])["config"]
    assert cfg2["slice_interp"] == 1


def test_import_endpoint_replaces_study(server, tmp_path):
    from tests.test_io import _make_series

    _make_series(tmp_path, n=6)
    # state from the old study
    _post(server, "/api/threshold", {"tmin": 0, "tmax": 100})
    code, r = _post(server, "/api/import", {"path": str(tmp_path)})
    assert code == 200 and r["shape"] == [6, 16, 16]
    st = json.loads(_get(server, "/api/status")[2])
    assert st["volume_shape"] == [6, 16, 16]
    assert st["n_masks"] == 0  # masks dropped with the old study
    code, ctype, _ = _get(server, "/api/slice/axial/3?t=77")
    assert code == 200 and "png" in ctype


def test_render_scene_includes_navigation(server):
    # connect tracker + add a marker; render_scene must still produce PNG
    _post(server, "/api/nav/connect", {"tracker_id": "debug_random",
                                       "poll_hz": 500})
    import time as _t

    _t.sleep(0.05)
    _post(server, "/api/nav/markers", {"position": [10.0, 10.0, 10.0]})
    code, ctype, png = _get(server, "/api/render_scene?size=64&t=55")
    assert code == 200 and png[:4] == b"\x89PNG"
    _post(server, "/api/nav/disconnect", {})


def test_project_save_open_roundtrip(tmp_path):
    # dedicated server: /api/project/open replaces the whole session
    zz, yy, xx = np.mgrid[:12, :16, :16].astype(np.float32)
    r = np.sqrt((zz - 6) ** 2 + (yy - 8) ** 2 + (xx - 8) ** 2)
    ct = np.where(r < 5, 1200, -900).astype(np.int16)
    srv = ViewerServer(_slice(ct)).start()
    try:
        _post(srv, "/api/threshold", {"tmin": 300, "tmax": 3071})
        _post(srv, "/api/surface", {})
        _post(srv, "/api/measures", {"kind": "linear",
                                     "p1": [2, 2, 2], "p2": [2, 2, 10]})
        path = str(tmp_path / "web.inv3")
        code, out = _post(srv, "/api/project/save",
                          {"path": path, "name": "roundtrip"})
        assert code == 200 and out["masks"] == 1 and out["surfaces"] == 1
        assert out["measures"] == 1

        # wipe the session by loading a different study, then reopen
        import invesalius3_tpu_torch.io.nifti as nifti

        other = np.zeros((4, 8, 8), np.int16)
        nii = str(tmp_path / "other.nii")
        nifti.write_nifti(nii, other, spacing=(1, 1, 1))
        _post(srv, "/api/import", {"path": nii})
        st = json.loads(_get(srv, "/api/status")[2])
        assert st["n_masks"] == 0

        code, out = _post(srv, "/api/project/open", {"path": path})
        assert code == 200 and out["name"] == "roundtrip"
        assert out["shape"] == [12, 16, 16]
        assert out["masks"] == 1 and out["surfaces"] == 1 and out["measures"] == 1
        st = json.loads(_get(srv, "/api/status")[2])
        assert st["volume_shape"] == [12, 16, 16]
        masks = json.loads(_get(srv, "/api/masks")[2])
        assert masks[0]["threshold_range"] == [300, 3071]
        # measures restored with values
        meas = json.loads(_get(srv, "/api/measures")[2])
        assert abs(meas[0]["value"] - 8.0) < 1e-3
    finally:
        srv.stop()


def test_surface_management_endpoints(server):
    """Per-surface ops the reference exposes via task_surface +
    data_notebook: list, props, split, smooth, decimate, remove,
    multi-format download."""
    # full-range threshold: guaranteed non-empty whatever study earlier
    # tests left loaded (test_import_endpoint_replaces_study swaps it)
    _post(server, "/api/threshold", {"tmin": -32768, "tmax": 32767})
    code, out = _post(server, "/api/surface", {"algorithm": "Default"})
    assert out["triangles"] > 0
    idx = out["index"]

    code, _, body = _get(server, "/api/surfaces")
    rows = json.loads(body)
    row = [r for r in rows if r["index"] == idx][0]
    assert row["triangles"] == out["triangles"] and row["visible"]

    code, res = _post(server, "/api/surface/props",
                      {"index": idx, "colour": [0.2, 0.4, 0.6],
                       "transparency": 0.5, "name": "Skull",
                       "visible": False})
    assert code == 200
    _, _, body = _get(server, "/api/surfaces")
    row = [r for r in json.loads(body) if r["index"] == idx][0]
    assert row["name"] == "Skull" and not row["visible"]
    assert row["colour"] == [0.2, 0.4, 0.6]

    code, parts = _post(server, "/api/surface/split", {"index": idx})
    assert code == 200 and len(parts) >= 1 and parts[0]["triangles"] > 0

    code, sm = _post(server, "/api/surface/smooth",
                     {"index": idx, "iterations": 3})
    assert code == 200

    code, dec = _post(server, "/api/surface/decimate",
                      {"index": idx, "reduction": 0.5})
    assert code == 200 and dec["triangles"] < out["triangles"]

    # multi-format download: PLY header + OBJ text
    _, _, ply = _get(server, f"/api/surface/{idx}.ply")
    assert ply[:3] == b"ply"
    _, _, obj = _get(server, f"/api/surface/{idx}.obj")
    assert obj.lstrip()[:1] in (b"#", b"v")

    code, res = _post(server, "/api/surface/remove", {"index": idx})
    assert code == 200
    _, _, body = _get(server, "/api/surfaces")
    assert idx not in [r["index"] for r in json.loads(body)]


def test_render_scene_mep_overlay(server):
    """GET /api/render_scene?mep=1 textures the surface with the MEP
    heat map interpolated from markers carrying mep_value (reference
    mep_visualizer.py + task_mepmapping.py)."""
    _post(server, "/api/threshold", {"tmin": -32768, "tmax": 32767})
    _post(server, "/api/surface", {"algorithm": "Default"})
    _post(server, "/api/nav/connect", {"tracker": "debug_random"})
    _post(server, "/api/nav/markers",
          {"position": [12, 12, 8], "mep_value": 900.0})
    _post(server, "/api/nav/markers",
          {"position": [4, 4, 4], "mep_value": 50.0})
    code, ctype, plain = _get(server, "/api/render_scene?size=96")
    code2, _, mep = _get(server, "/api/render_scene?size=96&mep=1")
    assert code == 200 and code2 == 200 and mep[:4] == b"\x89PNG"
    assert mep != plain  # the heat map changed surface colouring
    _post(server, "/api/nav/disconnect", {})


def test_render_scene_efield_overlay(server):
    """GET /api/render_scene?efield=1 textures the ROI surface with the
    latest e-norm field published on the bus (reference task_efield.py)."""
    _post(server, "/api/threshold", {"tmin": -32768, "tmax": 32767})
    _post(server, "/api/surface", {"algorithm": "Default"})
    # publish a fake e-field like VisualizeEFieldThread would, bound to
    # the surface it was computed for (surfaces left by other tests must
    # not soak up the texture)
    last = json.loads(_get(server, "/api/surfaces")[2])[-1]
    server.state._efield_surface_index = last["index"]
    server.state.slice.bus.send_message(
        "navigation.efield",
        enorms=np.linspace(0, 120, last["vertices"]), focal_factor=1.0)
    code, _, plain = _get(server, "/api/render_scene?size=96")
    code2, _, ef = _get(server, "/api/render_scene?size=96&efield=1")
    assert code == 200 and code2 == 200 and ef[:4] == b"\x89PNG"
    assert ef != plain
    server.state._efield_surface_index = None
    server.state.last_efield = None


def test_dl_segmentation_job_endpoints(server):
    """DL segmentation over HTTP: start -> poll progress -> mask lands
    (reference deep_learning_seg_dialog.py + SegmentProcess comm array).
    Random-init weights (env has no checkpoint): output is noise, but the
    job/progress/mask plumbing is the contract under test."""
    import time as _time

    code, r = _post(server, "/api/segment/dl",
                    {"model": "brain", "threshold": 0.5,
                     "allow_random_init": True, "batch_size": 2})
    assert code == 200 and r["started"] and r["model"] == "brain"
    for _ in range(600):
        code, st = _post(server, "/api/segment/dl/status", {})
        assert code == 200
        if st["done"]:
            break
        _time.sleep(0.2)
    assert st["done"] and st["error"] is None
    assert st["progress"] == 1.0
    assert "mask_index" in st
    masks = json.loads(_get(server, "/api/masks")[2])
    assert any(m["index"] == st["mask_index"] for m in masks)
    # second status poll does not re-add the mask
    _, st2 = _post(server, "/api/segment/dl/status", {})
    assert "mask_index" not in st2
    # interactive rethreshold: slider-speed, no re-inference (reference
    # segment.py:350 apply_segment_threshold on the cached probability)
    code, lo = _post(server, "/api/segment/dl/threshold", {"threshold": 0.01})
    assert code == 200 and lo["mask_index"] == st["mask_index"]
    code, hi = _post(server, "/api/segment/dl/threshold", {"threshold": 0.99})
    assert code == 200
    # random-init probabilities span (0,1): lower threshold keeps >= voxels,
    # and the mask object in state reflects the LAST rethreshold
    assert lo["voxels"] >= hi["voxels"]
    m = server.state.slice.masks[st["mask_index"]]
    assert int((np.asarray(m.data) > 0).sum()) == hi["voxels"]


def test_dl_subpart_job_lands_structure_masks(server):
    """FastSurfer parcellation over HTTP: whole-brain mask + per-category
    structure masks (reference SubpartSegmentProcess + the DL dialog)."""
    import time as _t

    n_before = json.loads(_get(server, "/api/masks")[2])
    code, r = _post(server, "/api/segment/dl",
                    {"model": "subpart", "allow_random_init": True,
                     "filters": 4, "conform_size": 16, "batch_size": 4,
                     "structures": ["ventricles", "cerebellum"]})
    assert code == 200 and r["model"] == "subpart"
    deadline = _t.monotonic() + 120.0
    st = {}
    while _t.monotonic() < deadline:
        _, st = _post(server, "/api/segment/dl/status", {})
        if st["done"]:
            break
        _t.sleep(0.5)
    assert st["done"] and st["error"] is None
    assert "mask_index" in st  # whole-brain mask landed
    # random weights: structure masks may or may not be non-empty, but the
    # key must be present and each returned index must exist
    masks = json.loads(_get(server, "/api/masks")[2])
    names = {m["index"]: m["name"] for m in masks}
    assert st["mask_index"] in names
    for idx in st.get("structure_mask_indices", []):
        assert idx in names
    assert len(masks) > len(n_before)


def test_dl_per_model_probability_cache(server):
    """Rethresholding a PREVIOUS model's output after a model switch does
    no inference: one probability cache per model (reference keeps one
    memmap per DL dialog, segment.py:350).  Depends on the two job tests
    above having populated the brain and subpart caches."""
    jobs = getattr(server.state, "_dl_jobs", {})
    if "brain" not in jobs or "subpart" not in jobs:
        pytest.skip("needs the brain+subpart DL jobs above")
    brain_job = jobs["brain"]
    # the LAST job is subpart, but addressing model=brain rethresholds the
    # brain cache in place — no new job, no inference
    code, r = _post(server, "/api/segment/dl/threshold",
                    {"threshold": 0.42, "model": "brain"})
    assert code == 200 and r["mask_index"] == brain_job.mask_index
    assert jobs["brain"] is brain_job and brain_job.threshold == 0.42
    # a model that never ran is a clean 404
    with pytest.raises(Exception):
        _post(server, "/api/segment/dl/threshold",
              {"threshold": 0.5, "model": "implant"})


def test_log_endpoint_and_export(server):
    """Log-viewer API over the in-memory ring: level/search filters + text
    export (reference enhanced_logging.py:177-212 LogViewerFrame)."""
    from invesalius3_tpu_torch.utils import logging as ilog

    ilog.get_logger("server").info("log-panel probe message")
    ilog.get_logger("server").warning("log-panel WARN probe")
    code, _, body = _get(server, "/api/log?limit=50")
    assert code == 200
    entries = json.loads(body)
    assert any("log-panel probe message" == e["message"] for e in entries)
    code, _, body = _get(server, "/api/log?level=WARNING")
    assert all(e["levelno"] >= 30 for e in json.loads(body))
    code, _, body = _get(server, "/api/log?q=WARN%20probe")
    assert len(json.loads(body)) >= 1
    code, ctype, body = _get(server, "/api/log/export")
    assert code == 200 and ctype == "text/plain"
    assert b"log-panel probe message" in body


@pytest.mark.parametrize("endpoint", ["echo", "find", "move"])
def test_pacs_endpoints_refuse_until_dicom_net_is_ported(server, endpoint, tmp_path):
    """The PACS endpoints reach DicomNet as the JAX server's do
    (tests/test_server.py:1148): with nothing listening, echo is false,
    find empty, and move an error naming the refused connection, and the
    served volume stays."""
    import urllib.error

    import chip_smoke

    body = {"host": "127.0.0.1", "port": chip_smoke._free_port(), "timeout": 0.5}
    volume = server.state.slice.volume
    if endpoint == "move":
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server, "/api/pacs/move", {**body, "study_uid": "1.2.3",
                                             "dest": str(tmp_path / "moved")})
        assert exc.value.code == 500
        assert "ConnectionRefusedError" in json.loads(exc.value.read())["error"]
    else:
        code, out = _post(server, f"/api/pacs/{endpoint}", body)
        assert code == 200 and out == ({"ok": False} if endpoint == "echo" else [])
    assert server.state.slice.volume is volume


def test_i18n_language_switch(server):
    """POST /api/i18n switches the runtime catalog and persists the choice
    (reference language_dialog.py + session SetLanguage)."""
    code, before = _get(server, "/api/i18n")[0], json.loads(
        _get(server, "/api/i18n")[2])
    assert "pt_BR" in before["locales"]
    _, r = _post(server, "/api/i18n", {"language": "pt_BR"})
    assert r["current"] == "pt_BR" and isinstance(r["catalog"], dict)
    after = json.loads(_get(server, "/api/i18n")[2])
    assert after["current"] == "pt_BR"
    # unknown locale is a clean JSON error, not a server crash
    try:
        _post(server, "/api/i18n", {"language": "xx_XX"})
        assert False, "expected HTTPError"
    except Exception as exc:  # urllib raises HTTPError
        assert getattr(exc, "code", None) == 500
    _, back = _post(server, "/api/i18n", {"language": before["current"]})
    assert back["current"] == before["current"]


def test_chip_smoke_phase15_rehearsal(tmp_path, monkeypatch):
    """chip_smoke.py's phase [15] on the CPU at 32^3: every endpoint it
    drives answers, and every equality it states holds (the launch counts
    are asserted on the card only: on the CPU the wrappers take their plain
    versions)."""
    import chip_smoke

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    monkeypatch.delenv("INV3_LANGUAGE", raising=False)
    monkeypatch.setattr(download, "download_url_to_file", _refuse)
    out = chip_smoke.viewer_server_phase(torch.device("cpu"), tmp_path, n=32, reps=1)
    assert out["ms"]["GET /api/histogram?bins=128"][1] == 1
    assert "DL job, start to landed mask" in out["ms"]
    assert len([k for k in out["ms"] if k.startswith("GET /api/slice/")]) == 12

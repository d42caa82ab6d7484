"""The port's viewer client (``invesalius3_tpu_torch/viewer/``) and server
on the CPU: the JAX package's client tests (tests/test_viewer_client.py)
against the port's own copy of the static files and the port's server,
with ``device="cpu"``.  The client-side raycast feed checks the volume
brick on a fresh server: the module fixture's server has been cropped and
reoriented by the tests before it.  The copy is also held byte for byte to
the JAX package's files.

The tests run no JS, so ``viewer/app.js`` is validated two ways:

1. static cross-checks — every element id / API path the JS references
   must exist in ``index.html`` / the port's ``server.py`` (breaks when
   HTML/JS/server drift apart), plus a token-balance sanity pass over the
   JS;
2. a scripted walkthrough that drives the same HTTP sequence the client
   sends for the documented flow (the reference GUI's default task
   workflow, gui/default_tasks.py): import -> threshold -> paint ->
   watershed -> surface -> WebGL mesh stream -> measure -> STL download.
"""

import json
import re
import struct
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import torch

from invesalius3_tpu_torch.core.slice import Slice
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.net import download
from invesalius3_tpu_torch.server import ViewerServer

torch.set_num_threads(1)
VIEWER = Path(__file__).resolve().parents[1] / "invesalius3_tpu_torch" / "viewer"
JAX_VIEWER = Path(__file__).resolve().parents[1] / "invesalius3_tpu" / "viewer"
SERVER_PY = VIEWER.parent / "server.py"
APP_JS = (VIEWER / "app.js").read_text()
INDEX_HTML = (VIEWER / "index.html").read_text()


# ---------------------------------------------------------------------------
# static cross-checks
# ---------------------------------------------------------------------------


def test_js_element_ids_exist_in_html():
    """Every `$("#id")` / `querySelector("#id")` in app.js must resolve."""
    used = set(re.findall(r"""[$ (]\(\s*["'`]#([\w-]+)["'`]\s*\)""", APP_JS))
    used |= set(re.findall(r"""getElementById\(["']([\w-]+)["']\)""", APP_JS))
    defined = set(re.findall(r"""id=["']([\w-]+)["']""", INDEX_HTML))
    missing = sorted(used - defined)
    assert not missing, f"app.js references ids missing from index.html: {missing}"


def test_js_data_attrs_exist_in_html():
    """Selector queries for data-* attribute values must match the HTML."""
    used = set(re.findall(r"""\[data-(tool|orient)=["']?\$?\{?""", APP_JS))
    for attr in used:
        assert re.search(rf"data-{attr}=", INDEX_HTML), (
            f"app.js queries [data-{attr}] but index.html defines none")


def test_js_api_paths_exist_in_server():
    """Every literal /api/... path fetched by app.js must be a server route."""
    server_src = SERVER_PY.read_text()
    routes = set(re.findall(r'"(/api/[\w/.{}-]*)"', server_src))
    # parts-based routes (slice/surface downloads, thumbs, jobs) are
    # assembled from path segments, not literal matches
    dynamic_prefixes = (
        "/api/slice/", "/api/surface/", "/api/dicom/thumb", "/api/mask/",
    )
    used = set(re.findall(r"""["'`](/api/[\w/-]+)["'`?]""", APP_JS))
    used |= set(re.findall(r"""[\"'`](/api/[\w/-]+)\?""", APP_JS))
    missing = sorted(
        p for p in used
        if p not in routes and not p.startswith(dynamic_prefixes))
    assert not missing, f"app.js calls unknown API paths: {missing}"


def test_js_token_balance():
    """Brace/paren/bracket balance outside strings & comments — catches
    truncated edits that a browser would reject at parse time."""
    src = APP_JS
    depth = {"(": 0, "{": 0, "[": 0}
    close = {")": "(", "}": "{", "]": "["}
    i, n, mode = 0, len(src), None  # mode: None | '"' | "'" | '`' | '//' | '/*'
    while i < n:
        c = src[i]
        two = src[i:i + 2]
        if mode is None:
            if two == "//":
                mode = "//"
                i += 2
                continue
            if two == "/*":
                mode = "/*"
                i += 2
                continue
            if c in "\"'`":
                mode = c
            elif c in depth:
                depth[c] += 1
            elif c in close:
                depth[close[c]] -= 1
                assert depth[close[c]] >= 0, f"unbalanced {c} at byte {i}"
        elif mode == "//":
            if c == "\n":
                mode = None
        elif mode == "/*":
            if two == "*/":
                mode = None
                i += 2
                continue
        else:  # inside a string/template literal
            if c == "\\":
                i += 2
                continue
            if c == mode:
                mode = None
        i += 1
    assert mode is None, f"unterminated {mode}"
    assert all(v == 0 for v in depth.values()), f"unbalanced: {depth}"


def test_html_references_app_js():
    assert re.search(r'<script[^>]+app\.js', INDEX_HTML)
    assert "gl3d" in INDEX_HTML  # WebGL pane canvas present


def test_i18n_viewer_catalog_coverage():
    """Viewer chrome strings (sidebar headers, tool buttons, app.js T()
    statuses) are translated in every locale, and the 24 reference-parity
    locales all ship (VERDICT r3 item 5; reference locale/ has 24 + en).
    ?lang=de therefore renders a German UI via app.js initI18n."""
    from invesalius3_tpu_torch.utils.i18n import get_locales, parse_po

    locales = get_locales()
    ref_locales = {"be", "ca", "cs", "de", "el", "en", "es", "fa", "fr",
                   "it", "ja", "ko", "ms", "nl", "pt", "pt_BR", "ro", "ru",
                   "sr", "tr_TR", "ur_PK", "uz", "zh_CN", "zh_TW"}
    assert ref_locales.issubset(set(locales)), sorted(
        ref_locales - set(locales))

    wanted = set(re.findall(r"<h3>([^<]+)</h3>", INDEX_HTML))
    wanted |= set(re.findall(r'<button data-tool="[\w-]+"[^>]*>([\w .]+)<',
                             INDEX_HTML))
    wanted |= set(re.findall(r'T\("([^"]+)"\)', APP_JS))
    wanted.discard("")
    assert len(wanted) >= 20
    locale_root = VIEWER.parent / "locale"
    for lang in locales:
        if lang == "en":
            continue
        po = locale_root / lang / "LC_MESSAGES" / "invesalius3_tpu.po"
        cat = parse_po(po.read_text(encoding="utf-8"))
        missing = {m for m in wanted if not cat.get(m)}
        assert not missing, f"{lang} missing viewer strings: {sorted(missing)[:5]}"


# ---------------------------------------------------------------------------
# scripted walkthrough (the client's HTTP sequence)
# ---------------------------------------------------------------------------


def _refuse(url, *a, **kw):
    raise OSError(f"the tests fetch nothing ({url})")


@pytest.fixture(scope="module", autouse=True)
def config_home(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XDG_CONFIG_HOME", str(tmp_path_factory.mktemp("config")))
        mp.delenv("INV3_LANGUAGE", raising=False)
        mp.setattr(download, "download_url_to_file", _refuse)
        yield


def _phantom():
    zz, yy, xx = np.mgrid[:24, :32, :32].astype(np.float32)
    r = np.sqrt((zz - 12) ** 2 + (yy - 16) ** 2 + (xx - 16) ** 2)
    ct = np.full((24, 32, 32), -1000, np.int16)
    ct[r < 11] = 60        # soft tissue ball
    ct[(r >= 8) & (r < 11)] = 1400  # bone shell
    return ct


def _new_server():
    return ViewerServer(Slice(Volume.from_numpy(_phantom(), spacing=(1.0, 1.0, 1.0),
                                                device="cpu"))).start()


@pytest.fixture(scope="module")
def server():
    srv = _new_server()
    yield srv
    srv.stop()


@pytest.mark.parametrize("name", ["app.js", "index.html", "style.css"])
def test_viewer_copy_equals_the_jax_package(name):
    assert (VIEWER / name).read_bytes() == (JAX_VIEWER / name).read_bytes()


def _get(server, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}") as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(server, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return r.status, json.loads(r.read())


def test_walkthrough(server):
    # 1. the page and the client script are served
    code, ctype, body = _get(server, "/")
    assert code == 200 and "text/html" in ctype and b"pane3d" in body
    code, _, js = _get(server, "/viewer/app.js")
    assert code == 200 and js.decode() == APP_JS

    # 2. threshold (segmentation panel: Bone preset)
    code, out = _post(server, "/api/threshold", {"tmin": 226, "tmax": 3071})
    assert code == 200 and out["voxels"] > 0

    # 3. paint a brush stroke (slice pane tool; payload = app.js:540)
    code, out = _post(server, "/api/brush", {
        "strokes": [[12, 16, 16], [12, 17, 17]], "radius_mm": 2.0,
        "erase": False})
    assert code == 200 and out["stamps"] == 2

    # 4. watershed from markers (segmentation panel; payload = app.js:1128)
    code, out = _post(server, "/api/watershed", {
        "markers": [{"position": [12, 16, 16], "label": 1},
                    {"position": [2, 2, 2], "label": 2}]})
    assert code == 200 and out["voxels"] > 0

    # 5. surface creation (surface task panel)
    code, out = _post(server, "/api/surface", {"algorithm": "Default"})
    assert code == 200 and out["triangles"] > 0
    n_tris_full = out["triangles"]
    sidx = out["index"]  # Surface indices are global across the process
    # (class counter), so never hardcode 0 — the client uses the
    # /api/surfaces listing the same way

    # 6. WebGL mesh stream: typed arrays the gl3d pane consumes
    code, ctype, blob = _get(server, f"/api/surface/{sidx}/mesh.bin")
    assert code == 200 and ctype == "application/octet-stream"
    assert blob[:4] == b"IVM1"
    jlen = struct.unpack("<I", blob[4:8])[0]
    meta = json.loads(blob[8:8 + jlen])
    assert meta["n_tris"] <= max(200000, n_tris_full)
    voff = 8 + jlen
    verts = np.frombuffer(blob, np.float16, meta["n_verts"] * 3, voff)
    foff = voff + meta["n_verts"] * 3 * 2
    foff += (-foff) % 4
    faces = np.frombuffer(blob, np.uint32, meta["n_tris"] * 3, foff)
    assert np.isfinite(verts.astype(np.float32)).all()
    assert int(faces.max()) < meta["n_verts"]
    # decimation kicks in above the cap
    code, _, blob_small = _get(server,
                               f"/api/surface/{sidx}/mesh.bin?max_tris=1000")
    jlen2 = struct.unpack("<I", blob_small[4:8])[0]
    meta2 = json.loads(blob_small[8:8 + jlen2])
    assert meta2["n_tris"] <= 1100

    # 7. a linear measure on the axial pane (payload = app.js:424)
    code, out = _post(server, "/api/measures", {
        "kind": "linear", "p1": [4.0, 4.0, 12.0], "p2": [20.0, 20.0, 12.0],
        "location": "AXIAL", "slice_number": 12})
    assert code == 200
    code, _, body = _get(server, "/api/measures")
    assert json.loads(body)

    # 8. STL download (exporter)
    code, ctype, stl = _get(server, f"/api/surface/{sidx}.stl")
    assert code == 200
    n_tris = struct.unpack("<I", stl[80:84])[0]
    assert len(stl) == 84 + 50 * n_tris

    # 9. the activity trail reached the log panel's ring (reference
    # enhanced_logging session log): state-changing POSTs above are
    # recorded, high-frequency gestures (/api/brush) stay quiet
    code, _, body = _get(server, "/api/log")
    assert code == 200
    msgs = [e["message"] for e in json.loads(body)]
    assert "/api/threshold" in msgs and "/api/watershed" in msgs
    assert "/api/brush" not in msgs


def test_walkthrough_tools(server):
    """The round-4 tool wiring: region-grow config, mask part ops, crop
    box, 3D polygon cut, reorient — the exact payloads app.js issues."""
    # region grow with dynamic-range config (app.js floodfill branch)
    code, out = _post(server, "/api/floodfill", {
        "seed": [12, 16, 16], "method": "dynamic",
        "dev_min": 30, "dev_max": 30})
    assert code == 200 and out["voxels"] > 0

    # keep the clicked connected part (tool part+)
    code, out = _post(server, "/api/mask/part", {
        "seed": [12, 16, 16], "op": "select"})
    assert code == 200 and out["voxels"] > 0

    # crop: drag sets the box (apply:false shows the overlay), apply crops
    code, out = _post(server, "/api/crop", {
        "limits": [2, 21, 2, 29, 2, 29], "apply": False})
    assert code == 200 and out["limits"] == [2, 21, 2, 29, 2, 29]
    code, out = _post(server, "/api/crop", {
        "limits": [2, 21, 2, 29, 2, 29], "apply": True})
    assert code == 200

    # 3D polygon cut through the scene camera (tool cut3d)
    code, out = _post(server, "/api/mask/cut3d", {
        "polygon": [[60, 60], [200, 60], [200, 200], [60, 200]],
        "azimuth": 30, "elevation": 20, "size": 256, "edit_mode": 1})
    assert code == 200 and out["cut_voxels"] >= 0

    # WebGL mesh cache invalidates on surface change (content + props
    # fingerprint, not id()): a colour change must serve a fresh blob
    code, out = _post(server, "/api/surface", {"algorithm": "Default"})
    sidx = out["index"]
    _, _, before = _get(server, f"/api/surface/{sidx}/mesh.bin")
    code, _ = _post(server, "/api/surface/props",
                    {"index": sidx, "colour": [0.1, 0.9, 0.1]})
    assert code == 200
    _, _, after = _get(server, f"/api/surface/{sidx}/mesh.bin")
    assert before != after, "stale WebGL mesh served after props change"
    _post(server, "/api/surface/remove", {"index": sidx})

    # surface-creation dialog options (quality preset, decimation,
    # keep-largest, name, overwrite — the exact body app.js builds)
    code, out = _post(server, "/api/surface", {
        "algorithm": "Default", "quality": "Low",
        "decimate_reduction": 0.5, "keep_largest": True,
        "name": "dialog opts", "overwrite": True})
    assert code == 200 and out["triangles"] > 0
    code, _, body = _get(server, "/api/surfaces")
    surfaces = json.loads(body)
    assert any(s["name"] == "dialog opts" for s in surfaces)
    # overwrite=True replaced the newest slot instead of adding
    assert len(surfaces) == 1

    # reorient (degrees -> radians done client-side; radians on the wire)
    code, out = _post(server, "/api/image/reorient", {
        "angles": [0.0, 0.0, 0.1]})
    assert code == 200 and out["ok"]


def test_walkthrough_threshold_brush_and_geodesic():
    """Round-5 tool wiring, on a fresh server (the module fixture's volume
    is crop/reorient-mutated by the tests above): the threshold-gated
    brush ops (reference styles.py:1361 editor BRUSH_THRESH*) and the
    geodesic surface measure driven by a camera-ray pick (reference
    measures.py:1068) — the exact payloads app.js issues."""
    srv = _new_server()
    try:
        # empty mask, then a threshold_add brush stamp over the bone rim:
        # only in-range voxels may be painted
        _post(srv, "/api/threshold", {"tmin": 5000, "tmax": 6000})
        code, out = _post(srv, "/api/brush", {
            "strokes": [[12, 16, 25]], "radius_mm": 4.0,
            "op": "threshold_add", "threshold_range": [1300, 1500]})
        assert code == 200
        n_gated = out["voxels"]
        assert n_gated > 0
        # the same stamp with plain paint covers strictly more voxels
        _post(srv, "/api/threshold", {"tmin": 5000, "tmax": 6000})
        code, out = _post(srv, "/api/brush", {
            "strokes": [[12, 16, 25]], "radius_mm": 4.0, "op": "paint"})
        assert out["voxels"] > n_gated
        # two-sided threshold op erases out-of-range voxels it covers:
        # visible count equals the gated add (in-range set identical)
        code, out = _post(srv, "/api/brush", {
            "strokes": [[12, 16, 25]], "radius_mm": 4.0,
            "op": "threshold", "threshold_range": [1300, 1500]})
        assert out["voxels"] == n_gated
        # threshold_erase_only erases only the out-of-range part of a
        # painted footprint
        _post(srv, "/api/threshold", {"tmin": 5000, "tmax": 6000})
        _post(srv, "/api/brush", {
            "strokes": [[12, 16, 25]], "radius_mm": 4.0, "op": "paint"})
        code, out = _post(srv, "/api/brush", {
            "strokes": [[12, 16, 25]], "radius_mm": 4.0,
            "op": "threshold_erase_only", "threshold_range": [1300, 1500]})
        assert out["voxels"] == n_gated

        # surface, then a camera-ray pick (app.js geodesicPick payload)
        _post(srv, "/api/threshold", {"tmin": 226, "tmax": 3071})
        code, out = _post(srv, "/api/surface", {"algorithm": "Default"})
        sidx = out["index"]
        code, hit = _post(srv, "/api/surface/pick", {
            "origin": [16.0, 16.0, 200.0], "dir": [0.0, 0.0, -1.0]})
        assert code == 200 and hit["hit"]
        assert hit["surface"] == sidx
        code, hit2 = _post(srv, "/api/surface/pick", {
            "origin": [16.0, 16.0, -200.0], "dir": [0.0, 0.0, 1.0]})
        assert hit2["hit"] and hit2["vertex"] != hit["vertex"]
        # a ray that misses everything
        code, miss = _post(srv, "/api/surface/pick", {
            "origin": [500.0, 500.0, 200.0], "dir": [0.0, 0.0, -1.0]})
        assert not miss["hit"]

        # geodesic measure between the two picked vertices: at least the
        # chord length (straight line through the interior is shorter
        # than any on-surface path between opposite poles)
        code, m = _post(srv, "/api/measures", {
            "kind": "geodesic", "surface": sidx,
            "v0": hit["vertex"], "v1": hit2["vertex"]})
        assert code == 200 and m["type"] == "geodesic"
        chord = float(np.linalg.norm(
            np.asarray(hit["position"]) - np.asarray(hit2["position"])))
        assert m["value"] >= chord - 1e-6
        assert m["value"] < 10 * chord
        code, _, body = _get(srv, "/api/measures")
        assert any(mm["type"] == "geodesic" for mm in json.loads(body))
    finally:
        srv.stop()


def test_walkthrough_progressive_render_and_ssao(server):
    """Progressive-refinement volume rendering (VERDICT r4 item 3) + the
    SSAO pass: the pooled interactive frame and the full-quality frame the
    client swaps in on drag end must both serve, and differ; the SSAO
    query must change the shaded surface scene (reference
    viewer_volume.py:636-646 live raycast + vtkSSAOPass :374)."""
    q = "azimuth=30&elevation=20&size=128"
    code, ctype, pooled = _get(server, f"/api/render?{q}&downsample=2")
    assert code == 200 and "image/png" in ctype
    code, _, full = _get(server, f"/api/render?{q}&downsample=1")
    assert code == 200
    assert pooled != full  # the upgrade actually adds information
    # the client's exact payloads: interactive (server default) + refine
    code, _, _ = _get(server, f"/api/render?preset=Bone&{q}")
    assert code == 200
    # SSAO on the surface scene (ensure a surface with crevices exists:
    # two offset spheres via threshold + brush give rim discontinuities)
    _post(server, "/api/threshold", {"tmin": 226, "tmax": 3071})
    _post(server, "/api/brush", {"strokes": [[2, 2, 2], [2, 28, 28]],
                                 "radius_mm": 5.0, "op": "paint"})
    code, out = _post(server, "/api/surface", {"algorithm": "Default"})
    assert code == 200 and out["triangles"] > 0
    code, _, plain = _get(server, "/api/render_scene?size=96")
    code2, _, ao = _get(server, "/api/render_scene?size=96&ssao=1")
    assert code == 200 and code2 == 200
    assert ao != plain
    _post(server, "/api/surface/remove", {"index": out["index"]})


def test_walkthrough_client_volume_raycast():
    """Client-side GPU volume raycast feed (the app.js ``volume-gl`` 3D
    mode; reference live vtkVolume mapper, viewer_volume.py:129): the
    server streams one downsampled u8 brick + the preset's baked RGBA LUT
    and the browser composites locally.  Validates the exact binary
    protocol app.js volGLEnsure parses, on a fresh server (the module's
    has been cropped and reoriented)."""
    server = _new_server()
    try:
        _client_volume_raycast(server)
    finally:
        server.stop()


def _client_volume_raycast(server):
    code, ctype, blob = _get(server, "/api/volume/brick?max_dim=16")
    assert code == 200 and "octet-stream" in ctype
    assert blob[:4] == b"IVB1"
    (jlen,) = struct.unpack("<I", blob[4:8])
    meta = json.loads(blob[8:8 + jlen])
    z, y, x = meta["dims"]
    assert max(meta["dims"]) <= 16 and meta["step"] == 2  # 32 -> 16
    data = np.frombuffer(blob[8 + jlen:], np.uint8).reshape(z, y, x)
    # u8 quantization of the real image: lo->0, hi->255, bone shell bright
    assert meta["lo"] == -1000.0 and meta["hi"] == 1400.0
    assert data.min() == 0 and data.max() == 255
    raw = meta["lo"] + data[z // 2].astype(np.float32) / 255.0 \
        * (meta["hi"] - meta["lo"])
    assert abs(raw[0, 0] - -1000) < 6          # air corner survives rounding
    assert raw.max() > 1300                    # bone shell present mid-slice
    assert meta["spacing"] == [2.0, 2.0, 2.0]  # 1 mm * step, X-first

    # the LUT the shader composites with: preset window + RGBA rows
    code, _, body = _get(server, "/api/raycast/lut?name=Bone&n=64")
    assert code == 200
    lut = json.loads(body)
    assert lut["name"] == "Bone" and lut["hi"] > lut["lo"]
    assert len(lut["rgba"]) == 64 * 4
    assert all(0 <= v <= 255 for v in lut["rgba"])
    a = lut["rgba"][3::4]
    assert max(a) > 0                          # something is visible

    # a live CLUT edit (save=False) must win over the stock preset table
    code, saved = _post(server, "/api/raycast/preset", {
        "name": "Bone", "lo": 0.0, "hi": 100.0, "save": False,
        "alpha_nodes": [[0.0, 1.0], [100.0, 1.0]],
        "color_nodes": [[0.0, [1, 0, 0]], [100.0, [1, 0, 0]]]})
    assert code == 200
    code, _, body2 = _get(server, "/api/raycast/lut?name=Bone&n=64")
    lut2 = json.loads(body2)
    assert (lut2["lo"], lut2["hi"]) == (0.0, 100.0)
    assert lut2["rgba"] != lut["rgba"]

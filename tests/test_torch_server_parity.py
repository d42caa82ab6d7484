"""The slice as a whole: the port's viewer server against the JAX package's,
side by side on the CPU, on the same seeded 24x32x32 CT phantom, driven by
the same scripted walkthrough over HTTP.  The JAX server runs as its own
tests run it on the CPU (its ray projections through their plain scans).

Tolerances:
- exact: the status and mask JSON, mask voxel counts, the watershed mask
  (labels), histogram counts and edges, the surface's STL bytes, the slice
  PNGs for Normal, MaxIP, MinIP, MeanIP and LMIP, the mask after every
  edit;
- MIDA slices: atol 1 on the projected plane, so at most 2 RGB levels at
  the window used (WW 400); the contour types: atol 2 on the plane, at most
  3 levels;
- measures and mask statistics: relative 1e-5 (ROADMAP Queue 3);
- volume-render PNGs: mean |diff| at most 0.1 level and at most 2 levels on
  99.9% of pixels; the scene (splat) PNG: at most 0.5% of pixels differ
  from the JAX renderer's on the port's surfaces (tests/test_torch_render.py;
  the JAX mesh's padding orphan vertex would move the scene's frame);
- a surface pick: the same hit; the JAX mesh's vertex ids are the port's
  plus one where the JAX mesh keeps its padding orphan vertex.
"""

import io
import json
import struct
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from invesalius3_tpu.core.mask import Mask as MaskJax
from invesalius3_tpu.core.slice import Slice as SliceJax
from invesalius3_tpu.core.surface import Surface as SurfaceJax
from invesalius3_tpu.core.volume import Volume as VolumeJax
from invesalius3_tpu.net import download as download_jax
from invesalius3_tpu.ops import render_mesh as rm_jax
from invesalius3_tpu.server import ViewerServer as ServerJax
from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.core.slice import Slice
from invesalius3_tpu_torch.core.surface import Surface
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.net import download
from invesalius3_tpu_torch.server import ViewerServer

torch.set_num_threads(1)
SHAPE = (24, 32, 32)
WW, WL = 400.0, 40.0


def _phantom():
    zz, yy, xx = np.mgrid[:24, :32, :32].astype(np.float32)
    r = np.sqrt((zz - 12) ** 2 + (yy - 16) ** 2 + (xx - 15) ** 2)
    ct = np.full(SHAPE, -1000, np.int16)
    ct[r < 11] = 40
    ct[(r >= 8) & (r < 11)] = 1200
    ct[(zz > 9) & (zz < 14) & (yy > 5) & (yy < 10)] = 300
    noise = np.random.default_rng(0).integers(-30, 30, SHAPE)
    return (ct + noise).astype(np.int16)


def _refuse(url, *a, **kw):
    raise OSError(f"the tests fetch nothing ({url})")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(port server, JAX server) over the same phantom, from the same mask
    and surface counters."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XDG_CONFIG_HOME", str(tmp_path_factory.mktemp("config")))
        mp.delenv("INV3_LANGUAGE", raising=False)
        mp.setattr(download, "download_url_to_file", _refuse)
        mp.setattr(download_jax, "download_url_to_file", _refuse)
        for cls in (Mask, MaskJax):
            mp.setattr(cls, "general_index", -1)
        for cls in (Surface, SurfaceJax):
            mp.setattr(cls, "_counter", [-1])
        ct = _phantom()
        port = ViewerServer(Slice(Volume.from_numpy(ct, spacing=(0.9, 1.0, 1.1),
                                                    device="cpu"))).start()
        jax_ = ServerJax(SliceJax(VolumeJax.from_numpy(ct, spacing=(0.9, 1.0, 1.1)))).start()
        try:
            yield port, jax_
        finally:
            port.stop()
            jax_.stop()


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}") as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(srv, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return r.status, json.loads(r.read())


def _both_get(pair, path):
    (c1, t1, b1), (c2, t2, b2) = (_get(s, path) for s in pair)
    assert (c1, t1) == (c2, t2) == (200, t1)
    return b1, b2


def _both_post(pair, path, body):
    (c1, r1), (c2, r2) = (_post(s, path, body) for s in pair)
    assert c1 == c2 == 200
    return r1, r2


def _close(got, want, rtol=1e-5, path="$"):
    """JSON values equal, floats within ``rtol``."""
    if isinstance(want, float) or isinstance(got, float):
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=path)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, rtol, f"{path}[{i}]")
    else:
        assert got == want, path


def _png(data) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _masks_equal(pair):
    port, jax_ = pair
    got = port.state.slice.current_mask.data.numpy()
    want = np.asarray(jax_.state.slice.current_mask.data)
    np.testing.assert_array_equal(got, want)
    return got


def test_status_and_window(pair):
    a, b = _both_get(pair, "/api/status")
    assert json.loads(a) == json.loads(b)
    r1, r2 = _both_post(pair, "/api/window", {"ww": WW, "wl": WL})
    assert r1 == r2 == {"ww": WW, "wl": WL}
    a, b = _both_get(pair, "/api/presets")
    assert json.loads(a) == json.loads(b)


# the plane's tolerance per projection type, as RGB levels at WW 400
RGB_ATOL = {const.PROJECTION_MIDA: 2, const.PROJECTION_CONTOUR_MIP: 3,
            const.PROJECTION_CONTOUR_LMIP: 3, const.PROJECTION_CONTOUR_MIDA: 3}
SLICES = [(o, i, p) for o, i in (("AXIAL", 10), ("CORONAL", 12), ("SAGITTAL", 9))
          for p in sorted(const.PROJECTION_NAMES)]


@pytest.mark.parametrize("orientation,index,projection", SLICES)
def test_slice_pngs(pair, orientation, index, projection):
    a, b = _both_get(pair, f"/api/slice/{orientation}/{index}?projection={projection}"
                           f"&slabs=8&overlays=0")
    got, want = _png(a), _png(b)
    assert got.shape == want.shape == (got.shape[0], got.shape[1], 3)
    atol = RGB_ATOL.get(projection, 0)
    if atol == 0:
        assert a == b
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= atol, (diff.max(), (diff > 0).mean())


def test_threshold_and_masks(pair):
    lo, hi = const.THRESHOLD_PRESETS_CT["Bone"]
    r1, r2 = _both_post(pair, "/api/threshold", {"tmin": lo, "tmax": hi})
    assert r1 == r2 and r1["voxels"] > 0
    a, b = _both_get(pair, "/api/masks")
    assert json.loads(a) == json.loads(b)
    _masks_equal(pair)
    # the frame with the mask overlay and a crosshair
    a, b = _both_get(pair, "/api/slice/AXIAL/12?cx=10&cy=12&ruler=1&labels=1")
    assert a == b


def test_floodfill_brush_and_stats(pair):
    r1, r2 = _both_post(pair, "/api/floodfill",
                        {"seed": [12, 16, 5], "tmin": 1000, "tmax": 2000})
    assert r1 == r2 and r1["voxels"] > 0
    _masks_equal(pair)
    stroke = [[12, 16, x] for x in range(6, 14)]
    for body in ({"strokes": stroke, "radius_mm": 2.5},
                 {"strokes": stroke[:3], "radius_mm": 2.0, "erase": True},
                 {"strokes": stroke, "radius_mm": 3.0, "op": "threshold_add",
                  "threshold_range": [200, 400]}):
        r1, r2 = _both_post(pair, "/api/brush", body)
        assert r1 == r2
        _masks_equal(pair)
    r1, r2 = _both_post(pair, "/api/mask/stats", {})
    _close(r1, r2)
    assert r1["voxels"] == r2["voxels"] > 0


def test_mask_part_cut_and_undo(pair):
    r1, r2 = _both_post(pair, "/api/mask/part", {"seed": [12, 16, 5], "op": "remove"})
    assert r1 == r2
    _masks_equal(pair)
    r1, r2 = _both_post(pair, "/api/mask/undo", {})
    assert r1 == r2 == {"ok": True}
    _masks_equal(pair)
    r1, r2 = _both_post(pair, "/api/mask/cut3d",
                        {"polygon": [[0, 0], [40, 0], [40, 95], [0, 95]],
                         "azimuth": 0, "elevation": 0, "size": 96})
    assert r1 == r2 and r1["cut_voxels"] > 0
    _masks_equal(pair)
    _both_post(pair, "/api/mask/undo", {})


def test_watershed_labels(pair):
    body = {"markers": [{"position": [12, 16, 15], "label": 1},
                        {"position": [2, 2, 2], "label": 2},
                        {"position": [12, 16, 5], "label": 3}]}
    r1, r2 = _both_post(pair, "/api/watershed", body)
    assert r1 == r2 and r1["voxels"] > 0
    m = _masks_equal(pair)
    assert int((m == 253).sum()) == r1["voxels"]
    r1, r2 = _both_post(pair, "/api/watershed", dict(body, algorithm="Watershed (IFT)",
                                                     keep_label=3))
    assert r1 == r2
    _masks_equal(pair)


def test_surface_stl_bytes(pair):
    lo, hi = const.THRESHOLD_PRESETS_CT["Bone"]
    _both_post(pair, "/api/threshold", {"tmin": lo, "tmax": hi})
    r1, r2 = _both_post(pair, "/api/surface", {"algorithm": "Default"})
    _close(r1, r2)
    a, b = _both_get(pair, f"/api/surface/{r1['index']}.stl")
    assert a == b and struct.unpack("<I", a[80:84])[0] == r1["triangles"] > 0
    a, b = _both_get(pair, "/api/surfaces")
    got, want = json.loads(a), json.loads(b)
    for g, w in zip(got, want):  # the JAX mesh may hold its padding orphan
        assert w["vertices"] - g["vertices"] in (0, 1)
        g.pop("vertices"), w.pop("vertices")
    _close(got, want)


@pytest.mark.parametrize("bins", [32, 128, 200])
def test_histogram(pair, bins):
    a, b = _both_get(pair, f"/api/histogram?bins={bins}")
    got, want = json.loads(a), json.loads(b)
    assert got == want
    assert sum(got["counts"]) == int(np.prod(SHAPE))


def test_measures(pair):
    bodies = [
        {"kind": "linear", "p1": [1.5, 2.0, 10.0], "p2": [20.0, 17.5, 10.0]},
        {"kind": "angular", "p0": [1, 0, 0], "p1": [0, 0, 0], "p2": [0.3, 1, 0.2]},
        {"kind": "annotation", "point": [5, 5, 10], "text": "note"},
        {"kind": "density_ellipse", "location": "AXIAL", "slice_number": 12,
         "center": [16, 15], "ry": 6, "rx": 4.5},
        {"kind": "density_ellipse", "location": "CORONAL", "slice_number": 20,
         "center": [12, 15], "ry": 3, "rx": 9},
        {"kind": "density_polygon", "location": "SAGITTAL", "slice_number": 15,
         "points_yx": [[4, 4], [4, 20], [20, 28], [18, 6]]},
    ]
    for body in bodies:
        r1, r2 = _both_post(pair, "/api/measures", body)
        _close(r1, r2)
    a, b = _both_get(pair, "/api/measures")
    _close(json.loads(a), json.loads(b))
    # the overlays drawn on a frame
    a, b = _both_get(pair, "/api/slice/AXIAL/10")
    assert a == b


def test_surface_pick(pair):
    port, jax_ = pair
    idx = max(port.state.surfaces)
    orphan = len(jax_.state.surfaces[idx].vertices) - len(port.state.surfaces[idx].vertices)
    for body in ({"origin": [16.0, 16.0, 200.0], "dir": [0.0, 0.0, -1.0]},
                 {"origin": [-50.0, 17.0, 13.0], "dir": [1.0, 0.05, 0.0]},
                 {"origin": [500.0, 500.0, 200.0], "dir": [0.0, 0.0, -1.0]}):
        r1, r2 = _both_post(pair, "/api/surface/pick", body)
        if r2["hit"]:
            assert r2.pop("vertex") - r1.pop("vertex") == orphan
        _close(r1, r2)


def test_render_pngs(pair):
    a, b = _both_get(pair, "/api/render?size=64&preset=Bone&azimuth=30&elevation=20")
    d = np.abs(_png(a).astype(int) - _png(b).astype(int)).max(-1)
    assert d.mean() <= 0.1 and (d > 2).mean() <= 1e-3
    # the scene frames its meshes' vertices, and the JAX mesh's padding
    # orphan moves that frame: the port's scene is held to the JAX renderer
    # on the port's (orphan-free) surfaces
    port, _ = pair
    _, _, a = _get(port, "/api/render_scene?size=96&azimuth=30&elevation=20")
    want = rm_jax.render_scene(list(port.state.surfaces.values()), azimuth=30.0,
                               elevation=20.0, size=96)
    assert (_png(a) != want).any(-1).mean() <= 5e-3


def test_volume_brick_and_lut(pair):
    a, b = _both_get(pair, "/api/volume/brick?max_dim=16")
    assert a == b
    a, b = _both_get(pair, "/api/raycast/lut?name=Bone&n=64")
    _close(json.loads(a), json.loads(b))


def test_i18n_round_trip(pair):
    a, b = _both_get(pair, "/api/i18n?lang=de")
    assert json.loads(a) == json.loads(b)
    r1, r2 = _both_post(pair, "/api/i18n", {"language": "pt_BR"})
    assert r1 == r2 and r1["current"] == "pt_BR"
    r1, r2 = _both_post(pair, "/api/i18n", {"language": "en"})
    assert r1 == r2


def test_event_topics(pair):
    a, b = _both_get(pair, "/api/events")
    got = [e["topic"] for e in json.loads(a)]
    want = [e["topic"] for e in json.loads(b)]
    assert got == want and "mask.created" in got


def test_pacs_refused_by_the_port_only(pair, tmp_path):
    """The PACS endpoints answer as the JAX server's (the port refuses
    nothing now): echo and find to a dead port, then a C-MOVE from a
    mini-PACS without the import (the walkthrough's volume stays)."""
    import chip_smoke
    from invesalius3_tpu_torch.io import dicom

    dead = {"host": "127.0.0.1", "port": chip_smoke._free_port(), "timeout": 2.0}
    assert _both_post(pair, "/api/pacs/echo", dead) == ({"ok": False}, {"ok": False})
    assert _both_post(pair, "/api/pacs/find", dead) == ([], [])
    paths = []
    for i in range(3):
        paths.append(tmp_path / f"s{i}.dcm")
        dicom.write_dicom(paths[-1], np.full((4, 4), i, np.int16), {
            "PatientName": "P^Q", "PatientID": "PQ", "StudyInstanceUID": "4.5.6",
            "SeriesInstanceUID": "4.5.6.1", "SOPInstanceUID": f"4.5.6.1.{i}",
            "Modality": "CT", "InstanceNumber": i + 1})
    row = {"PatientName": "P^Q", "PatientID": "PQ", "StudyInstanceUID": "4.5.6",
           "StudyDate": "", "StudyDescription": "S"}
    moved = []
    for name, srv in zip(("port", "jax"), pair):
        store_port = chip_smoke._free_port()
        pacs = chip_smoke.MiniPACS(list(chip_smoke.pacs_instances(paths).items()), row,
                                   store_port, timeout=10.0).start()
        try:
            code, out = _post(srv, "/api/pacs/move", {
                "host": "127.0.0.1", "port": pacs.port, "study_uid": "4.5.6",
                "dest": str(tmp_path / name), "listen_port": store_port, "timeout": 10.0,
                "import": False})
        finally:
            pacs.stop()
        assert code == 200
        moved.append(sorted(f.rsplit("/", 1)[1] for f in out["files"]))
    assert moved[0] == moved[1] and len(moved[0]) == 3
    assert [s.state.slice.volume.shape for s in pair][0] == SHAPE

"""Headless HTTP server: the web-era equivalent of the reference's GUI
surface (port of invesalius3_tpu/server.py).

SURVEY §7.9 calls a headless server + web viewer "the idiomatic modern
equivalent" of the 37.8k-LoC wxPython GUI, and the reference's own
remote-control channel (net/remote_control.py) already mirrors the full
event bus to external clients.  This server exposes the behavioral
surface the viewers consumed:

  GET  /                                   built-in web viewer page
  GET  /api/status                         volume/mask/surface inventory
  GET  /api/slice/{orientation}/{index}    rendered RGB slice (PNG) with
                                           measure/crop/cross overlays
                                           (?overlays=0 disables; ?cx=&cy=
                                           draws the crosshair) and
        ?ww=&wl=&projection=&slabs=        mask overlay (query params are
                                           request-local: GETs never mutate)
  GET  /api/render?azimuth=&elevation=     raycast volume render (PNG)
        &preset=&size=
  GET  /api/masks                          mask list (index/name/colour)
  GET  /api/measures                       measurement list
  GET  /api/presets                        threshold + raycast preset names
  GET  /api/raycast/nodes?name=            editable CLUT node view
  POST /api/raycast/preset {"name","lo","hi","alpha_nodes","color_nodes",
        "shading","mode","save"}           bake (optionally persist) an
                                           edited raycast preset
  GET  /api/image_versions                 filtered image version labels
  POST /api/window {"ww","wl"}             set the shared display window
  POST /api/projection {"type","slabs"}    set the shared projection mode
  POST /api/threshold {"tmin","tmax"}      create threshold mask
  POST /api/floodfill {"seed":[z,y,x],     region grow into the mask
        "method":"threshold|dynamic|confidence",...}
  POST /api/mask/stats {"index"?}          mask area + density stats
  POST /api/mask/part {"seed","op"}        select/remove connected part
  POST /api/mask/cut3d {"polygon",...}     3D polygon cut via scene camera
  POST /api/watershed {"markers":[...]}    watershed segmentation
  POST /api/boolean {"op","index1","index2"}  combine two masks
  POST /api/crop {"limits":[zi,zf,yi,yf,xi,xf]}  crop current mask
  POST /api/mask/select {"index"}          switch current mask
  POST /api/mask/undo | /api/mask/redo     edition history
  POST /api/mask/{remove,duplicate,props}  data-notebook row ops
  POST /api/mask/{import,export} {"path"}  NIfTI label-map round trip
  POST /api/mask/fill_holes {"max_size"}   automatic hole fill
  POST /api/image/{flip,swap,reorient}     Image-menu transforms
  POST /api/filter {"type","value",...}    new filtered image version
  POST /api/image_versions/select {"label"}
  POST /api/measures {"kind",...}          add linear/angular/geodesic/…
  POST /api/surface/pick {"origin","dir"}  camera-ray pick -> vertex
  POST /api/measures/remove {"index"}
  POST /api/measures/props {"index","visible","name"}
  POST /api/brush {"strokes","radius_mm","op"}  brush stroke: paint/erase/
        threshold[_erase|_add|_erase_only] (+"threshold_range" to set the
        mask's edition threshold; reference styles.py:1361 editor ops)
  POST /api/segment/dl {"model","threshold"}   start a DL segmentation
        job (brain/trachea/mandible/implant); /status polls progress and
        lands the mask; /cancel stops it; /threshold rethresholds the
        cached probability without re-inference (reference DL seg dialogs
        + segmentation/deep_learning/segment.py:350)
  POST /api/surface {"algorithm",...}      create surface from the mask
  POST /api/surface/import {"path",...}    import a mesh file (+hole fill)
  GET  /api/surfaces                       surface list (props + metrics)
  POST /api/surface/{remove,props,split,smooth,decimate,
        remove_non_visible}
                                           per-surface ops (reference
                                           task_surface + data_notebook)
  GET  /api/surface/{index}.{ext}          download (stl/ply/obj/vtp/x3d/
                                           3mf/wrl/iv/bin)
  POST /api/project/save | /api/project/open   .inv3 persistence
  POST /api/project/props {"name","modality"}  project properties
  GET  /api/session | POST /api/session/recover  crash detection +
                                           auto-backup restore
  GET  /api/render_scene?azimuth=...       surface-actor 3D scene (PNG)
  GET  /api/dicom/scan?dir= | /api/dicom/thumb  import-UI series preview
  GET  /api/i18n                           locales + current catalog
  POST /api/i18n {"language"}              switch UI language at runtime
  POST /api/pacs/{echo,find,move}          PACS verify / C-FIND query /
                                           C-MOVE retrieve + import
                                           (reference import_network_panel)
  GET/POST /api/config                     Session preferences
  POST /api/overlay {"path","colormap"}    fMRI color overlay (+ /clear)
  GET  /api/nav/status | /api/nav/markers  navigation state
  POST /api/nav/tracts {"enable",...}      live tractography worker config
                                           (FOD/direction-field NIfTI or
                                           demo field; task_tractography)
  POST /api/nav/efield {"enable",...}      e-field worker over a surface
                                           ROI (debug solver; task_efield)
  POST /api/nav/record {"enable","path"}   tracker-coordinate CSV recording
  POST /api/nav/icp {"surface_index",...}  ICP refinement from live probe
                                           samples against a surface
  POST /api/nav/mtms/{load,target,sequence}  mTMS parameter table, offset
                                           mapping + pulse sequencing
  POST /api/pedal {"pressed"}              programmatic pedal; while
                                           navigating, a press drops a
                                           marker at the probe position
  GET  /api/nav/robots                     robot registry state
  POST /api/nav/robot/{connect,objective,target,free_drive}
                                           robot panel (task_navigator)
  POST /api/nav/{connect,disconnect,fiducial/tracker,fiducial/image,
        register,start,stop,markers,markers/remove}
  GET  /api/histogram?bins=                image intensity histogram
                                           (clut_imagedata widget data)
  GET  /api/events                         recent bus events (polling)

State-changing requests are POSTs serialized by a lock (the reference GUI
is single-threaded wx; ThreadingHTTPServer needs the explicit guard).
Everything is stdlib http.server + PIL for PNG encoding — zero new deps.

The device is the Slice's: every request computes on the tensor the volume
lies on, inside ``torch.cuda.device`` of it on the card, on the default
stream.  The volume never comes to the host whole: a frame copies its RGB
plane, a density measure its one plane, the brick its downsampled copy.
Each thread hands over only finished results (a host array, or a tensor
after the device has synchronised).  ``/api/pacs/move`` imports the
retrieved study onto the Slice's device and, as ``/api/import`` does,
warms the new volume's shear-warp cache (the JAX server's move leaves the
previous volume's cache in place).
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from invesalius3_tpu_torch import constants as const, events
from invesalius3_tpu_torch.core.slice import Slice
from invesalius3_tpu_torch.utils.i18n import current_catalog, tr
from invesalius3_tpu_torch.utils.logging import get_logger

_log = get_logger("server")

# the web client the server serves: the port's own copy
VIEWER_ROOT = Path(__file__).resolve().parent / "viewer"

# State-changing POSTs logged to the /api/log ring, except these
# high-frequency interaction paths (drag gestures, wheel windowing).
_LOG_QUIET_POSTS = {"/api/brush", "/api/window", "/api/pedal"}


def on_device(dev: torch.device):
    """The thread's current CUDA device set to ``dev`` (nothing on the
    CPU), so whatever a request makes without an explicit device lands
    with the volume."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class AppState:
    """What the server serves: one Slice + its project-level objects."""

    def __init__(self, slc: Slice):
        from invesalius3_tpu_torch.core.measures import MeasurementManager
        from invesalius3_tpu_torch.device import resolve_device

        resolve_device(slc.matrix.device)  # a CUDA volume needs the card
        self.slice = slc
        self.surfaces = {}
        self.mesh_bin_cache = {}  # surface idx -> (key, packed WebGL blob)
        self.crop_box = None  # last /api/crop box, drawn as slice overlay
        self.custom_presets = {}  # live (unsaved) CLUT-editor presets
        self.recent_events = []
        self.measures = MeasurementManager(bus=slc.bus)
        self.lock = threading.Lock()  # serializes state-changing POSTs
        self._nav_lock = threading.Lock()  # guards lazy NavigationHub build

        from invesalius3_tpu_torch.utils import logging as ilog

        ilog.ensure_logging(console=False)  # feed the /api/log ring

        self.last_scene = None  # latest navigation.update_scene payload
        self.last_efield = None  # latest navigation.efield payload
        self.last_tracts = None  # latest navigation.tracts payload

        @events.wants_topic
        def tap(topic=None, **kw):
            if topic == "navigation.update_scene":
                self.last_scene = kw
            elif topic == "navigation.efield":
                self.last_efield = kw
            elif topic == "navigation.tracts":
                self.last_tracts = kw
            self.record_event(topic, _jsonable_shallow(kw))

        self._tap = tap  # keep a reference (bus stores it)
        slc.bus.subscribe(tap, events.ALL_TOPICS)
        self.warm_render_cache()

    @property
    def device(self) -> torch.device:
        return self.slice.matrix.device

    def warm_render_cache(self) -> None:
        """Background-warm the shear-warp octant cache so the first
        interactive volume frame is fast at ANY camera angle (progressive
        refinement contract; reference viewer_volume.py:636-646 keeps the
        mapper's resampled volume alive).  Daemon thread: never blocks a
        request, and small volumes (no pooled fast path) skip it.
        A previous matrix's cached device permutes are evicted first —
        the cache keys hold strong references, so stale entries would
        pin device memory across crop/reorient/import.  A failure is
        logged with its traceback (a render then rebuilds the entry);
        ``self.warm_thread`` is the last warm-up thread."""
        from invesalius3_tpu_torch.ops import raycast

        prev = getattr(self, "_warmed_matrix", None)
        if prev is not None and prev is not self.slice.matrix:
            raycast.drop_shear_cache(prev)
        self._warmed_matrix = self.slice.matrix
        if min(self.slice.matrix.shape) < 128:
            return

        def _warm(matrix=self.slice.matrix):
            try:
                with on_device(matrix.device):
                    raycast.warm_shear_cache(matrix, "composite",
                                             device=matrix.device)
                    if matrix.is_cuda:
                        torch.cuda.synchronize(matrix.device)
            except Exception:
                _log.exception("shear-cache warm-up failed on %s",
                               matrix.device)

        self.warm_thread = threading.Thread(target=_warm, daemon=True,
                                            name="shear-cache-warm")
        self.warm_thread.start()

    def record_event(self, topic, data):
        self.recent_events.append({"topic": topic, "data": data})
        self.recent_events = self.recent_events[-200:]

    @property
    def nav(self):
        """Lazy NavigationHub (reference task_navigator.py workflow exposed
        over HTTP: tracker connect, fiducials, registration, start/stop,
        markers)."""
        hub = getattr(self, "_nav", None)
        if hub is None:
            # GETs run outside state.lock; double-checked under a DEDICATED
            # lock (POST dispatch already holds state.lock — re-acquiring it
            # here would self-deadlock) so concurrent status polls cannot
            # build two hubs (a dropped hub would stay subscribed to the
            # bus as a zombie)
            with self._nav_lock:
                hub = getattr(self, "_nav", None)
                if hub is None:
                    from invesalius3_tpu_torch.navigation.navigation import (
                        NavigationHub)

                    hub = self._nav = NavigationHub(bus=self.slice.bus,
                                                    device=self.device)
        return hub

    def dicom_groups(self, directory):
        """Scan + cache DICOM series for the import endpoints."""
        cache = getattr(self, "_dicom_cache", None)
        if cache is None or cache[0] != directory:
            from invesalius3_tpu_torch.io import dicom as dcm

            self._dicom_cache = (directory, dcm.load_dicom_dir(directory))
        return self._dicom_cache[1]


def _jsonable_shallow(kw: dict) -> dict:
    out = {}
    for k, v in kw.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)) and len(v) <= 16:
            out[k] = [x if isinstance(x, (str, int, float, bool)) else repr(x) for x in v]
        else:
            out[k] = repr(v)[:120]
    return out


def _world_to_vox_from_affine(affine):
    """world mm (x,y,z) -> voxel (z,y,x) for a NIfTI grid (the tract
    field's own affine, which may differ from the image grid)."""
    inv = np.linalg.inv(np.asarray(affine, float))

    def conv(xyz):
        h = np.append(np.asarray(xyz, float), 1.0)
        return (inv @ h)[:3][::-1]

    return conv


def _vox_to_world_from_affine(affine):
    """(N, 3) voxel (z,y,x) -> world mm (x,y,z) — the inverse of
    _world_to_vox_from_affine, used to place tract streamlines (which
    live on the FIELD's grid, not the image grid) into the scene."""
    aff = np.asarray(affine, float)

    def conv(zyx):
        pts = np.asarray(zyx, float)
        homo = np.concatenate(
            [pts[..., ::-1], np.ones(pts.shape[:-1] + (1,))], axis=-1)
        return (homo @ aff.T)[..., :3]

    return conv


HIST_CHUNK = 1 << 24  # voxels binned at once by /api/histogram


def histogram_edges(lo: float, hi: float, nbins: int) -> np.ndarray:
    """The float32 bin edges of ``jnp.histogram(..., bins=nbins,
    range=(lo, hi))`` as the JAX package's CPU program evaluates
    ``jnp.linspace``: an empty range widened by 0.5 each side,
    ``lo * (1 - i * r) + i * (hi * r)`` with ``r`` the float32 reciprocal
    of ``nbins`` and the second product fused into one rounding, and ``hi``
    itself as the last edge.  Checked equal over random ranges for bin
    counts up to 300 that are multiples of 8 (the viewer asks for 128; the
    tests use 32, 128 and 200); XLA's vectorised CPU loop fuses the other
    product for some elements of other counts (the second edge of some odd
    counts, several hundred edges), where an edge may differ in its last
    bit."""
    f32 = np.float32
    lo, hi = f32(lo), f32(hi)
    if hi - lo == 0:
        lo, hi = f32(lo - f32(0.5)), f32(hi + f32(0.5))
    r = f32(f32(1) / f32(nbins))
    i = np.arange(nbins, dtype=f32)
    a = lo * (f32(1) - i * r)
    body = (i.astype(np.float64) * float(f32(hi * r)) + a.astype(np.float64)).astype(f32)
    return np.append(body, hi)


def histogram_counts(data: torch.Tensor, edges: np.ndarray) -> np.ndarray:
    """Counts of ``data`` in the bins of ``edges``, on its device, with
    ``jnp.histogram``'s rule: a value falls in the bin whose left edge is the
    last edge <= it, and the last edge belongs to the last bin (numpy's
    rule for explicit edges too).  Values compare in float32."""
    e = torch.from_numpy(np.ascontiguousarray(edges, np.float32)).to(data.device)
    n = len(edges)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=data.device)
    flat = data.reshape(-1)
    for i in range(0, flat.numel(), HIST_CHUNK):
        v = flat[i:i + HIST_CHUNK].to(torch.float32)
        idx = torch.searchsorted(e, v, right=True)
        idx = torch.where(v == e[-1], n - 1, idx)
        counts += torch.bincount(idx, minlength=n + 1)
    return counts[1:n].cpu().numpy()


def _visible_voxels(mask) -> int:
    return int(mask.visible_array().sum())


def _pacs_client(body: dict):
    """DicomNet from a request body (reference import_network_panel.py
    host/port/AE-title fields)."""
    from invesalius3_tpu_torch.net.dicom_net import DicomNet

    return DicomNet(
        body["host"], int(body.get("port", 104)),
        aetitle_call=body.get("aetitle_call", "ANYSCP"),
        aetitle=body.get("aetitle", "INVESALIUS"))


def _png_bytes(rgb: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "PNG")
    return buf.getvalue()


def make_handler(state: AppState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        # -- helpers -----------------------------------------------------------
        def _json(self, obj, code=200):
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _png(self, rgb):
            payload = _png_bytes(rgb)
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _mesh_bin(self, surf, max_tris: int):
            """Serve a surface as packed typed arrays for the WebGL pane:
            b"IVM1" u32(json_len) json{...} f16 verts [pad] u32 faces.

            Cache key is a content fingerprint (shape + strided sample
            digest), NOT id() — a freed-and-reallocated vertices array can
            reuse an address, which would validate a stale entry."""
            v = np.asarray(surf.vertices)
            sample = v[::max(1, len(v) // 512)].tobytes()
            import hashlib

            digest = hashlib.md5(sample).hexdigest()[:16]
            key = (surf.index, v.shape[0], int(len(surf.faces)),
                   digest, max_tris, tuple(surf.colour),
                   float(surf.transparency), surf.name)
            cached = state.mesh_bin_cache.get(surf.index)
            if cached and cached[0] == key:
                payload = cached[1]
            else:
                verts = np.asarray(surf.vertices, np.float32)
                faces = np.asarray(surf.faces, np.int64)
                if len(faces) > max_tris:
                    from invesalius3_tpu_torch.core.surface import decimate

                    verts, faces = decimate(
                        verts, faces, 1.0 - max_tris / len(faces))
                meta = json.dumps({
                    "n_verts": int(len(verts)), "n_tris": int(len(faces)),
                    "colour": list(surf.colour),
                    "transparency": float(surf.transparency),
                    "name": surf.name,
                }).encode()
                if len(meta) % 2:  # Uint16Array byteOffset must be even
                    meta += b" "
                head = b"IVM1" + np.uint32(len(meta)).tobytes() + meta
                vb = np.ascontiguousarray(verts, np.float16).tobytes()
                pad = b"\0" * (-(len(head) + len(vb)) % 4)
                fb = np.ascontiguousarray(faces, np.uint32).tobytes()
                payload = head + vb + pad + fb
                state.mesh_bin_cache[surf.index] = (key, payload)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _static(self, path):
            """Serve the web client (the port's own viewer/) — the
            behavioral replacement for the reference's wx GUI shell
            (reference gui/frame.py:88, viewer_slice.py:194,
            viewer_volume.py:129)."""
            root = VIEWER_ROOT
            name = "index.html" if path in ("/", "/index.html") else \
                path[len("/viewer/"):]
            if "/" in name or name.startswith("."):
                self._json({"error": tr("not found")}, 404)
                return
            f = root / name
            if not f.is_file():
                self._json({"error": tr("not found")}, 404)
                return
            ctype = {"html": "text/html; charset=utf-8",
                     "js": "text/javascript; charset=utf-8",
                     "css": "text/css; charset=utf-8",
                     }.get(f.suffix[1:], "application/octet-stream")
            payload = f.read_bytes()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0) or 0)
            return json.loads(self.rfile.read(n) or b"{}")

        # -- GET ---------------------------------------------------------------
        def do_GET(self):
            try:
                with on_device(state.device):
                    self._get()
            except Exception as e:  # surface errors as JSON
                _log.exception("GET %s failed: %r", self.path, e)
                self._json({"error": repr(e)}, 500)

        def _get(self):
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                parts = [p for p in url.path.split("/") if p]
                slc = state.slice
                dev = state.device
                if url.path == "/api/status":
                    self._json({
                        "volume_shape": list(slc.volume.shape) if slc.volume else None,
                        "spacing": list(slc.spacing) if slc.volume else None,
                        "window": [slc.window_width, slc.window_level],
                        "n_masks": len(slc.masks),
                        "n_surfaces": len(state.surfaces),
                        "projection": const.PROJECTION_NAMES[slc.projection_type],
                    })
                elif url.path == "/api/masks":
                    self._json([
                        {"index": m.index, "name": m.name, "colour": list(m.colour),
                         "visible": m.is_shown,
                         "threshold_range": list(m.threshold_range)}
                        for m in slc.masks.values()
                    ])
                elif len(parts) == 4 and parts[:2] == ["api", "slice"]:
                    orientation = parts[2].upper()
                    index = int(parts[3])
                    cross = None
                    if "cx" in q and "cy" in q:
                        cross = (float(q["cx"]), float(q["cy"]))
                    rgb = slc.get_rendered_slice(
                        orientation, index,
                        ww=float(q["ww"]) if "ww" in q else None,
                        wl=float(q["wl"]) if "wl" in q else None,
                        projection=int(q["projection"]) if "projection" in q else None,
                        slabs=int(q["slabs"]) if "slabs" in q else None,
                        measures=(None if q.get("overlays") == "0"
                                  else state.measures),
                        crop_box=(state.crop_box
                                  if q.get("overlays") != "0" else None),
                        cross=cross,
                        ruler=q.get("ruler") == "1",
                        orientation_labels=q.get("labels") == "1",
                    )
                    self._png(rgb)
                elif url.path == "/api/measures":
                    self._json([m.to_dict() for m in state.measures.measures.values()])
                elif url.path == "/api/presets":
                    from invesalius3_tpu_torch.ops import raycast

                    names = list(raycast.available_presets())
                    names += [n for n in state.custom_presets
                              if n not in names]
                    self._json({
                        "threshold_ct": {k: list(v) for k, v in
                                         const.THRESHOLD_PRESETS_CT.items()},
                        "raycast": names,
                        "projections": const.PROJECTION_NAMES,
                    })
                elif url.path == "/api/raycast/nodes":
                    # editable node view for the CLUT editor (reference
                    # gui/widgets/clut_raycasting.py curve model)
                    from invesalius3_tpu_torch.ops import raycast

                    name = q.get("name", "Bone")
                    p = state.custom_presets.get(name)
                    self._json(raycast.nodes_from_preset(p) if p is not None
                               else raycast.preset_nodes(name))
                elif url.path == "/api/raycast/lut":
                    # baked RGBA LUT for the client-side GPU raycaster —
                    # the same table /api/render composites with, so both
                    # volume modes agree (reference color_transfer /
                    # opacity_transfer funcs, viewer_volume.py:636-646)
                    from invesalius3_tpu_torch.ops import raycast

                    name = q.get("name", "Bone")
                    p = (state.custom_presets.get(name)
                         or raycast.load_preset(name))
                    n = max(2, min(1024, int(q.get("n", 256))))
                    src = np.asarray(p.rgba, np.float32)
                    idx = np.clip((np.linspace(0.0, 1.0, n)
                                   * (len(src) - 1) + 0.5).astype(int),
                                  0, len(src) - 1)
                    lut = (src[idx] * 255.0 + 0.5).astype(np.uint8)
                    self._json({"name": p.name, "lo": float(p.lut_min),
                                "hi": float(p.lut_max),
                                "shading": bool(p.use_shading),
                                "rgba": lut.ravel().tolist()})
                elif url.path == "/api/volume/brick":
                    # u8 image brick the browser uploads once as a WebGL2
                    # 3D texture for client-side raycasting (reference
                    # viewer_volume.py:129 live vtkVolume mapper; the
                    # server /api/render stays the full-fidelity path).
                    # Downsampled on device so only the brick crosses D2H.
                    max_dim = max(16, int(q.get("max_dim", 256)))
                    shape = slc.matrix.shape
                    step = max(1, -(-max(shape) // max_dim))
                    brick = slc.matrix[::step, ::step, ::step].to(
                        torch.float32).cpu().numpy()
                    lo = float(brick.min())
                    hi = float(brick.max())
                    u8 = ((brick - lo) * (255.0 / max(hi - lo, 1e-6))
                          ).astype(np.uint8)
                    sx, sy, sz = slc.spacing  # X-first (volume.py:32)
                    meta = json.dumps({
                        "dims": list(u8.shape),  # (Z, Y, X)
                        "spacing": [sx * step, sy * step, sz * step],
                        "lo": lo, "hi": hi, "step": step}).encode()
                    payload = (b"IVB1" + np.uint32(len(meta)).tobytes()
                               + meta + u8.tobytes())
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                elif url.path == "/api/image_versions":
                    self._json({
                        "versions": [lbl for lbl, _ in slc.image_versions],
                        "current": slc.current_image_label,
                    })
                elif url.path == "/api/config":
                    # preferences surface (reference gui/preferences.py
                    # persists through Session config.json)
                    from invesalius3_tpu_torch.core.session import Session

                    sess = getattr(state, "_session", None) or Session()
                    state._session = sess
                    self._json({"config": dict(sess.config),
                                "recent_projects": sess.recent_projects})
                elif url.path == "/api/log":
                    # log-viewer surface over the in-memory ring (reference
                    # enhanced_logging.py:177-212 LogViewerFrame: level
                    # filter, component filter, search, export)
                    from invesalius3_tpu_torch.utils import logging as ilog

                    self._json(ilog.query_log(
                        level=q.get("level"),
                        component=q.get("component"),
                        search=q.get("q"),
                        limit=int(q.get("limit", 500))))
                elif url.path == "/api/log/export":
                    from invesalius3_tpu_torch.utils import logging as ilog

                    text = "\n".join(ilog.recent_log_lines()) + "\n"
                    data = text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Disposition",
                                     "attachment; filename=invesalius3_tpu.log")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif url.path == "/api/nav/status":
                    nav = state.nav
                    coords, flags = (nav.tracker.get_coordinates()
                                     if nav.tracker.connected
                                     else (np.zeros((3, 6)), [False] * 3))
                    self._json({
                        "tracker_connected": nav.tracker.connected,
                        "trackers": __import__(
                            "invesalius3_tpu_torch.navigation.tracker",
                            fromlist=["TRACKERS"]).TRACKERS,
                        "probe": list(np.asarray(coords[0], float)),
                        "sensor_flags": [bool(f) for f in np.asarray(flags)],
                        "tracker_fiducials_set": nav.tracker.are_fiducials_set(),
                        "image_fiducials_set": nav.image.are_set(),
                        "fre": nav.navigation.fre,
                        "navigating": nav.navigation.is_navigating,
                        "n_markers": len(nav.markers.markers),
                        "tracts_enabled": nav.navigation.tract_params is not None,
                        "efield_enabled": nav.navigation.efield_params is not None,
                    })
                elif url.path == "/api/nav/robots":
                    self._json([{
                        "robot_id": r.robot_id, "ip": r.ip,
                        "connected": r.connected,
                        "objective": r.objective.name,
                        "force": r.force,
                        "has_target": r.target_tracker is not None,
                    } for r in state.nav.robots.all()])
                elif url.path == "/api/nav/markers":
                    self._json([{
                        "id": m.marker_id, "type": str(m.marker_type),
                        "position": list(np.asarray(m.position, float)),
                        "label": m.label,
                    } for m in state.nav.markers.markers])
                elif url.path == "/api/render_scene":
                    # surface-actor 3D scene (reference viewer_volume.py
                    # surface actors; server-side z-buffer splat renderer)
                    from invesalius3_tpu_torch.ops import render_mesh


                    markers = probe = None
                    coil_poses = None
                    nav = getattr(state, "_nav", None)
                    if nav is not None:  # live navigation scene
                        markers = nav.markers.markers
                        if nav.tracker.connected:
                            coords, flags = nav.tracker.get_coordinates()
                            if np.asarray(flags)[0]:
                                probe = np.asarray(coords[0], float)
                    scene = state.last_scene
                    if scene and scene.get("coils_img"):
                        from invesalius3_tpu_torch.navigation import (
                            coregistration as coreg)

                        coil_poses = [coreg.matrix_to_pose(m)
                                      for m in scene["coils_img"].values()]
                    surfs = list(state.surfaces.values())
                    if (int(q.get("efield", 0)) and surfs
                            and state.last_efield is not None):
                        # e-field magnitude texture on the ROI surface
                        # (reference task_efield.py + e_field.py colouring)
                        import copy as _copy

                        en = np.asarray(state.last_efield["enorms"], float)
                        # texture the surface the ROI was built from, not
                        # whichever happens to be first shown
                        roi_si = getattr(state, "_efield_surface_index",
                                         None)
                        target = next(
                            (s for s in surfs if s.index == roi_si), None) \
                            or next((s for s in surfs if s.is_shown),
                                    surfs[0])
                        t = np.zeros(len(target.vertices), np.float32)
                        span = max(float(en.max()) - float(en.min()), 1e-9)
                        roi_ids = state.last_efield.get("roi_ids")
                        if roi_ids is not None:
                            # enorms computed on a strided ROI subset of
                            # this surface's vertices
                            ids = np.asarray(roi_ids)
                            keep = ids < len(t)
                            t[ids[keep]] = (en[keep] - float(en.min())) / span
                        else:
                            n = min(len(en), len(target.vertices))
                            t[:n] = (en[:n] - float(en.min())) / span
                        colours = np.stack(  # blue -> red heat ramp
                            [t, 0.25 + 0.5 * t * (1 - t) * 4, 1.0 - t],
                            axis=1).astype(np.float32)
                        target = _copy.copy(target)
                        target.colour = colours
                        surfs = [target if s.index == target.index else s
                                 for s in surfs]
                    if int(q.get("mep", 0)) and nav is not None and surfs:
                        # MEP heat map over the first visible surface
                        # (reference mep_visualizer.py brain texturing)
                        from invesalius3_tpu_torch.navigation.mep import MEPMapper

                        import copy as _copy

                        target = next((s for s in surfs if s.is_shown),
                                      surfs[0])
                        mapped = MEPMapper().map_markers(
                            target.vertices, nav.markers.markers, device=dev)
                        target = _copy.copy(target)
                        target.colour = mapped["colors"]
                        surfs = [target if s.index == target.index else s
                                 for s in surfs]
                    robot_force = None
                    if nav is not None and nav.robots.all():
                        robot_force = max(
                            r.force for r in nav.robots.all())
                    streamlines = None
                    if state.last_tracts is not None:
                        # tract ribbons from the live ComputeTractsThread
                        # (reference tractography.py vtkTube multiblocks).
                        # Paths are on the tract FIELD's grid, which may be
                        # coarser than / oriented differently from the
                        # image grid — use the converter stored when the
                        # field was configured.
                        to_world = (getattr(state, "_tract_vox_to_world",
                                            None)
                                    or slc.volume.voxel_to_world)
                        paths = np.asarray(state.last_tracts["paths"])
                        valid = np.asarray(state.last_tracts["valid"])
                        streamlines = []
                        for ti in range(min(paths.shape[1], 32)):
                            pts_vox = paths[valid[:, ti], ti]  # (S, zyx)
                            if len(pts_vox) >= 2:
                                streamlines.append(to_world(pts_vox))
                    slice_plane = None
                    if q.get("slice"):
                        # ?slice=AXIAL:42 composes that slice as a
                        # textured plane (reference SlicePlane :4007)
                        so, _, si = str(q["slice"]).partition(":")
                        ax = const.ORIENTATION_AXIS[so.upper() or "AXIAL"]
                        n = slc.volume.shape[ax]
                        slice_plane = render_mesh.slice_plane_mesh(
                            slc, so.upper(),
                            min(max(int(si or n // 2), 0), n - 1))
                    img = render_mesh.render_scene(
                        surfs,
                        markers=markers,
                        probe_pose=probe,
                        coil_poses=coil_poses,
                        streamlines=streamlines,
                        slice_plane=slice_plane,
                        robot_force=robot_force,
                        azimuth=float(q.get("azimuth", 30)),
                        elevation=float(q.get("elevation", 20)),
                        size=int(q.get("size", 256)),
                        ssao=bool(int(q.get("ssao", 0))),
                        device=dev,
                    )
                    self._png(img)
                elif url.path == "/api/dicom/scan":
                    # import-UI support (reference import_panel.py +
                    # dicom_preview_panel.py): series tree w/ metadata
                    from invesalius3_tpu_torch.io import dicom as dcm

                    groups = state.dicom_groups(q["dir"])
                    self._json([g.preview_info() for g in groups])
                elif url.path == "/api/dicom/thumb":
                    groups = state.dicom_groups(q["dir"])
                    uid = q.get("series")
                    sel = [g for g in groups
                           if g.preview_info()["series_uid"] == uid]
                    g = sel[0] if sel else groups[int(q.get("index", 0))]
                    u8 = g.thumbnail(
                        index=int(q["slice"]) if "slice" in q else None,
                        size=int(q.get("size", 64)))
                    self._png(np.stack([u8] * 3, axis=-1))
                elif url.path == "/api/i18n":
                    from invesalius3_tpu_torch.utils import i18n as i18n_mod

                    lang = q.get("lang", "")
                    self._json({
                        "locales": i18n_mod.get_locales(),
                        "current": lang or i18n_mod.current_language(),
                        "catalog": current_catalog(lang),
                    })
                elif url.path in ("/", "/index.html") or \
                        url.path.startswith("/viewer/"):
                    self._static(url.path)
                elif url.path == "/api/render":
                    from invesalius3_tpu_torch.ops import raycast

                    pname = q.get("preset", "Bone")
                    preset = (state.custom_presets.get(pname)
                              or raycast.load_preset(pname))
                    # shear-warp: streaming slice compositing (the gather
                    # raycaster is several times slower a frame at full
                    # volumes)
                    size = int(q.get("size", 256))
                    # interactive requests orbit at half resolution (the
                    # pooled+permuted volume is cached per camera octant)
                    ds = int(q.get("downsample",
                                   2 if size <= 256
                                   and min(slc.matrix.shape) >= 128 else 1))
                    img = raycast.shear_warp_render(
                        slc.matrix, slc.spacing, preset,
                        azimuth=float(q.get("azimuth", 0)),
                        elevation=float(q.get("elevation", 0)),
                        image_size=size,
                        downsample=ds,
                    )
                    self._png(img)
                elif (len(parts) == 4 and parts[:2] == ["api", "surface"]
                      and parts[3] == "mesh.bin"):
                    # typed-array mesh for the client-side WebGL pane
                    # (reference's live GPU scene: viewer_volume.py:129).
                    # Layout: b"IVM1" + u32 json_len + json meta + f16
                    # verts (V*3, xyz) + pad-to-4 + u32 faces (F*3).
                    # Surfaces above max_tris are QEM-decimated first so
                    # orbit-rate rendering stays cheap; the packed blob is
                    # cached per (index, version).
                    idx = int(parts[2])
                    max_tris = int(q.get("max_tris", 200000))
                    self._mesh_bin(state.surfaces[idx], max_tris)
                elif url.path == "/api/surfaces":
                    self._json([{
                        "index": s.index, "name": s.name,
                        "colour": list(s.colour),
                        "transparency": s.transparency,
                        "visible": s.is_shown,
                        "triangles": int(len(s.faces)),
                        "vertices": int(len(s.vertices)),
                        "volume_mm3": s.volume, "area_mm2": s.area,
                    } for s in state.surfaces.values()])
                elif len(parts) == 3 and parts[:2] == ["api", "surface"]:
                    # download in any writer format mesh_io knows:
                    # /api/surface/{index}.{stl|ply|obj|vtp|x3d|3mf|wrl|iv|bin}
                    # index "all" merges every visible surface into one
                    # mesh first (reference surface.py:1782 _export_surface
                    # collects shown surfaces + polydata_utils.py:142 Merge)
                    stem, _, ext = parts[2].partition(".")
                    import tempfile, os

                    if stem == "all":
                        from invesalius3_tpu_torch.core.surface import (
                            merge_surfaces)

                        shown = [s for s in state.surfaces.values()
                                 if s.is_shown]
                        if not shown:
                            raise ValueError("no visible surfaces")
                        surf = merge_surfaces(shown, device=dev)
                    else:
                        surf = state.surfaces[int(stem)]
                    fd, tmp = tempfile.mkstemp(suffix="." + (ext or "stl"))
                    os.close(fd)
                    surf.export(tmp)
                    data = open(tmp, "rb").read()
                    os.remove(tmp)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "model/" + (ext or "stl"))
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif url.path == "/api/session":
                    # crash detection + auto-backup state (reference
                    # splash CheckCrashRecovery app.py:287-366)
                    from invesalius3_tpu_torch.core.session import Session

                    sess = getattr(state, "_session", None) or Session()
                    state._session = sess
                    backup = sess.recover_auto_backup()
                    self._json({
                        "exited_successfully_last_time":
                            sess.exited_successfully_last_time(),
                        "backup_path": None if backup is None
                        else str(backup),
                        "recent_projects": sess.recent_projects,
                    })
                elif url.path == "/api/histogram":
                    # image intensity histogram (reference
                    # gui/widgets/clut_imagedata.py draws the WW/WL curve
                    # over the 16-bit histogram)
                    # the bins of jnp.histogram over [min, max]; the
                    # volume is binned on its device, the counts cross
                    nbins = int(q.get("bins", 128))
                    data = slc.matrix
                    lo, hi = (float(v) for v in torch.aminmax(data))
                    edges = histogram_edges(lo, hi, nbins)
                    counts = histogram_counts(data, edges)
                    self._json({
                        "counts": [int(c) for c in counts],
                        "edges": [float(e) for e in edges],
                        "ww": slc.window_width, "wl": slc.window_level,
                    })
                elif url.path == "/api/events":
                    self._json(state.recent_events)
                else:
                    self._json({"error": tr("not found")}, 404)

        # -- POST --------------------------------------------------------------
        def do_POST(self):
            slc = state.slice
            try:
                body = self._body()
                with state.lock, on_device(state.device):
                    self._post(slc, body)
                # activity trail for the log panel (reference
                # enhanced_logging.py session/application activity log);
                # high-frequency interaction paths stay quiet.
                if self.path not in _LOG_QUIET_POSTS:
                    _log.info("%s", self.path)
            except Exception as e:
                _log.exception("POST %s failed: %r", self.path, e)
                self._json({"error": repr(e)}, 500)

        def _post(self, slc, body):
                dev = state.device
                if self.path == "/api/window":
                    slc.set_window(float(body["ww"]), float(body["wl"]))
                    self._json({"ww": slc.window_width, "wl": slc.window_level})
                elif self.path == "/api/projection":
                    slc.projection_type = int(body.get("type", slc.projection_type))
                    slc.n_slabs = int(body.get("slabs", slc.n_slabs))
                    self._json({"type": slc.projection_type, "slabs": slc.n_slabs})
                elif self.path == "/api/mask/select":
                    slc.select_mask(int(body["index"]))
                    self._json({"index": slc.current_mask.index})
                elif self.path == "/api/mask/remove":
                    # data-notebook row ops (reference data_notebook.py
                    # mask page: remove/duplicate/colour/name)
                    slc.remove_mask(int(body["index"]))
                    self._json({"ok": True,
                                "current": None if slc.current_mask is None
                                else slc.current_mask.index})
                elif self.path == "/api/mask/duplicate":
                    src = slc.masks[int(body["index"])]
                    m = src.duplicate(
                        existing_names=[x.name for x in slc.masks.values()])
                    slc.masks[m.index] = m
                    self._json({"index": m.index, "name": m.name})
                elif self.path == "/api/mask/props":
                    m = slc.masks[int(body["index"])]
                    if "name" in body:
                        m.name = str(body["name"])
                    if "colour" in body:
                        m.colour = tuple(float(c) for c in body["colour"])
                    if "visible" in body:
                        m.is_shown = bool(body["visible"])
                    self._json({"index": m.index, "name": m.name,
                                "colour": list(m.colour)})
                elif self.path == "/api/mask/fill_holes":
                    # automatic hole fill (reference mask.py:519
                    # fill_holes_auto, the "Fill holes automatically" tool)
                    m = slc.current_mask
                    if m is None:
                        raise ValueError(tr("no current mask"))
                    before = _visible_voxels(m)
                    m.fill_holes_auto(int(body.get("max_size", 1000)),
                                      conn=int(body.get("connectivity", 6)))
                    after = _visible_voxels(m)
                    self._json({"filled_voxels": after - before})
                elif self.path == "/api/mask/undo":
                    ok = slc.current_mask.undo() if slc.current_mask else False
                    self._json({"ok": bool(ok)})
                elif self.path == "/api/mask/redo":
                    ok = slc.current_mask.redo() if slc.current_mask else False
                    self._json({"ok": bool(ok)})
                elif self.path == "/api/boolean":
                    m = slc.do_boolean_op(int(body["op"]), int(body["index1"]),
                                          int(body["index2"]))
                    self._json({"index": m.index, "name": m.name,
                                "voxels": _visible_voxels(m)})
                elif self.path == "/api/crop":
                    box = slc.create_crop_box()
                    box.set_limits(*body["limits"])
                    box.clamp()
                    state.crop_box = box
                    if body.get("apply", True):
                        slc.apply_crop(box)
                        state.warm_render_cache()  # new matrix object
                    self._json({"limits": list(box.limits)})
                elif self.path == "/api/mask/cut3d":
                    # screen-space polygon cut of the mask in the 3D scene
                    # (reference Mask3DEditorState mask3d_editor_state.py:18
                    # + mask_cut.rs): polygon in render_scene pixel coords
                    # for the given azimuth/elevation/size
                    from invesalius3_tpu_torch.ops import rasterize, render_mesh

                    m = slc.current_mask
                    if m is None:
                        raise ValueError(tr("no current mask"))
                    size = int(body.get("size", 256))
                    az = float(body.get("azimuth", 30))
                    el = float(body.get("elevation", 20))
                    # the scene frames the visible surfaces; fall back to
                    # the volume bounds when none exist
                    surfs = [s for s in state.surfaces.values()
                             if s.is_shown]
                    if surfs:
                        pts = np.concatenate([s.vertices for s in surfs])
                    else:
                        Zs, Ys, Xs = slc.volume.shape
                        szs, sys_, sxs = (slc.spacing[2], slc.spacing[1],
                                          slc.spacing[0])
                        pts = np.array([[0, 0, 0],
                                        [Xs * sxs, Ys * sys_, Zs * szs]],
                                       np.float32)
                    center = (pts.min(0) + pts.max(0)) / 2.0
                    vm = render_mesh.view_matrix(az, el)
                    proj = (pts - center) @ vm.T
                    extent = float(np.abs(proj[:, :2]).max()) * 2.1 + 1e-3
                    scale = size / extent
                    a = 2.0 * scale / (size - 1)
                    b = size / (size - 1.0) - 1.0
                    mproj = np.zeros((4, 4), np.float32)
                    mproj[0, :3] = a * vm[0]
                    mproj[0, 3] = -a * float(vm[0] @ center) + b
                    mproj[1, :3] = -a * vm[1]
                    mproj[1, 3] = a * float(vm[1] @ center) + b
                    mproj[3, 3] = 1.0
                    eye = center - vm[2] * extent
                    mv = np.eye(4, dtype=np.float32)
                    mv[:3, :3] = vm
                    mv[:3, 3] = -(vm @ eye)
                    poly = rasterize.polygon2mask(
                        (size, size),
                        [[float(c), float(r)] for c, r in body["polygon"]],
                        device=dev).T
                    before = _visible_voxels(m)
                    new = rasterize.mask_cut(
                        m.data, slc.spacing,
                        float(body.get("max_depth", 1e9)),
                        poly, mproj, mv,
                        edit_mode=int(body.get("edit_mode", 1)))
                    m.apply(new)
                    after = _visible_voxels(m)
                    self._json({"cut_voxels": before - after})
                elif self.path == "/api/mask/part":
                    # select / remove a connected mask part by seed click
                    # (reference styles.py:2572/2708 Remove/SelectMaskParts)
                    from invesalius3_tpu_torch.ops import connected, floodfill

                    m = slc.current_mask
                    if m is None:
                        raise ValueError(tr("no current mask"))
                    part = connected.select_part(m.data, tuple(body["seed"]))
                    erased = torch.tensor(const.MASK_ERASED, dtype=torch.uint8,
                                          device=m.data.device)
                    if body.get("op", "select") == "remove":
                        new = torch.where(part, erased, m.data)
                    else:  # keep only the clicked part
                        new = torch.where(part, m.data, erased)
                    m.apply(new)
                    self._json({"voxels": int(part.sum())})
                elif self.path == "/api/mask/stats":
                    # mask surface area + voxel density stats (reference
                    # slice_.py calc_mask_area / control density tools)
                    m = (slc.masks[int(body["index"])]
                         if "index" in body else slc.current_mask)
                    if m is None:
                        raise ValueError(tr("no current mask"))
                    mn, mx, mean, std = slc.calc_image_density(m)
                    self._json({
                        "index": m.index,
                        "area_mm2": float(slc.calc_mask_area(m)),
                        "voxels": _visible_voxels(m),
                        "density": {"mean": float(mean), "min": float(mn),
                                    "max": float(mx), "std": float(std)},
                    })
                elif self.path == "/api/mask/import":
                    # NIfTI label map -> new mask (reference control.py:264
                    # mask import)
                    m = slc.import_mask_from_nifti(
                        body["path"], name=body.get("name", ""))
                    self._json({"index": m.index, "name": m.name})
                elif self.path == "/api/mask/export":
                    # current/indexed mask -> NIfTI label map (reference
                    # control.py:353 mask export)
                    from invesalius3_tpu_torch.io import nifti

                    m = (slc.masks[int(body["index"])]
                         if "index" in body else slc.current_mask)
                    if m is None:
                        raise ValueError(tr("no current mask"))
                    lab = m.visible_array().cpu().numpy().astype(np.uint8) * 255
                    nifti.write_nifti(
                        body["path"], lab, spacing=slc.spacing,
                        affine=slc.volume.affine)
                    self._json({"path": body["path"],
                                "voxels": int((lab > 0).sum())})
                elif self.path == "/api/image/flip":
                    # Image menu: flip L-R / A-P / T-B (reference
                    # slice_.py flip + frame.py menu)
                    slc.flip_volume(int(body["axis"]))
                    state.record_event("image.flipped",
                                       {"axis": int(body["axis"])})
                    self._json({"ok": True})
                elif self.path == "/api/image/swap":
                    a0, a1 = (int(x) for x in body["axes"])
                    slc.swap_volume_axes(a0, a1)
                    state.record_event("image.axes_swapped",
                                       {"axes": [a0, a1]})
                    self._json({"shape": list(slc.volume.shape)})
                elif self.path == "/api/image/reorient":
                    # rotate about the volume center + resample (reference
                    # reorient dialog + slice_.py:1969)
                    slc.apply_reorientation(
                        angles=[float(a) for a in body["angles"]],
                        interp_method=int(body.get("interp", 2)))
                    state.record_event("image.reoriented",
                                       {"angles": body["angles"]})
                    state.warm_render_cache()  # new matrix object
                    self._json({"ok": True})
                elif self.path == "/api/filter":
                    label = slc.apply_image_filter(
                        int(body["type"]), float(body.get("value", 1.0)),
                        dimension=body.get("dimension", "3D"),
                        orientation=body.get("orientation", "AXIAL"))
                    self._json({"label": label})
                elif self.path == "/api/image_versions/select":
                    slc.select_image_version(body["label"])
                    self._json({"current": slc.current_image_label})
                elif self.path == "/api/measures":
                    kind = body.get("kind", "linear")
                    if kind == "linear":
                        m = state.measures.add_linear(
                            body["p1"], body["p2"],
                            location=body.get("location", "AXIAL"),
                            slice_number=int(body.get("slice_number", 0)))
                    elif kind == "angular":
                        m = state.measures.add_angular(
                            body["p0"], body["p1"], body["p2"],
                            location=body.get("location", "AXIAL"),
                            slice_number=int(body.get("slice_number", 0)))
                    elif kind == "annotation":
                        m = state.measures.add_annotation(
                            body["point"], body.get("text", ""),
                            lead_point=body.get("lead_point"),
                            location=body.get("location", "AXIAL"),
                            slice_number=int(body.get("slice_number", 0)))
                    elif kind == "density_ellipse":
                        ax = const.ORIENTATION_AXIS[body.get("location", "AXIAL")]
                        # the plane is taken on the device: only it
                        # crosses to the host, never the volume
                        sn = int(body.get("slice_number", 0))
                        if not 0 <= sn < slc.matrix.shape[ax]:
                            # reject (the JAX server checks ahead of its
                            # clamping take; indexing would raise)
                            raise ValueError(
                                f"slice_number {sn} out of range "
                                f"[0, {slc.matrix.shape[ax]})")
                        img2d = slc.matrix.select(ax, sn).cpu().numpy()
                        m = state.measures.add_density_ellipse(
                            img2d, body["center"], float(body["ry"]),
                            float(body["rx"]),
                            location=body.get("location", "AXIAL"),
                            slice_number=int(body.get("slice_number", 0)),
                            points=body.get("points", []))
                    elif kind == "density_polygon":
                        # polygon ROI density stats (reference
                        # measures.py:2138 PolygonDensityMeasure)
                        ax = const.ORIENTATION_AXIS[body.get("location", "AXIAL")]
                        # the plane is taken on the device: only it
                        # crosses to the host, never the volume
                        sn = int(body.get("slice_number", 0))
                        if not 0 <= sn < slc.matrix.shape[ax]:
                            # reject (the JAX server checks ahead of its
                            # clamping take; indexing would raise)
                            raise ValueError(
                                f"slice_number {sn} out of range "
                                f"[0, {slc.matrix.shape[ax]})")
                        img2d = slc.matrix.select(ax, sn).cpu().numpy()
                        m = state.measures.add_density_polygon(
                            img2d, [(float(r), float(c))
                                    for r, c in body["points_yx"]],
                            location=body.get("location", "AXIAL"),
                            slice_number=int(body.get("slice_number", 0)))
                    elif kind == "geodesic":
                        # surface-constrained distance between two picked
                        # vertices (reference measures.py:1068)
                        s = state.surfaces[int(body["surface"])]
                        m = state.measures.add_geodesic(
                            np.asarray(s.vertices, np.float64),
                            np.asarray(s.faces),
                            int(body["v0"]), int(body["v1"]))
                    else:
                        raise ValueError(f"unknown measure kind {kind!r}")
                    self._json(m.to_dict())
                elif self.path == "/api/surface/pick":
                    # camera-ray pick against the stored surface meshes —
                    # the WebGL pane's replacement for the reference's
                    # vtkCellPicker (viewer_volume.py picking)
                    from invesalius3_tpu_torch.core import measures as meas

                    origin = body["origin"]
                    direction = body["dir"]
                    idxs = ([int(body["index"])] if "index" in body else
                            [s.index for s in state.surfaces.values()
                             if s.is_shown])
                    best = None
                    for i in idxs:
                        s = state.surfaces[i]
                        hit = meas.ray_pick(s.vertices, s.faces,
                                            origin, direction)
                        if hit is not None and (
                                best is None or hit[0] < best[0]):
                            best = (hit[0], i, hit[1], hit[2], hit[3])
                    if best is None:
                        self._json({"hit": False})
                    else:
                        t, i, face, vert, pos = best
                        self._json({"hit": True, "surface": i,
                                    "face": int(face), "vertex": int(vert),
                                    "t": float(t),
                                    "position": [float(x) for x in pos]})
                elif self.path == "/api/measures/remove":
                    state.measures.remove(int(body["index"]))
                    self._json({"ok": True})
                elif self.path == "/api/measures/props":
                    # data-notebook measure rows: visibility / rename /
                    # colour (reference data_notebook.py measures page +
                    # the per-measure colour every representation carries,
                    # measures.py:290-302)
                    m = state.measures.measures[int(body["index"])]
                    if "visible" in body:
                        m.visible = bool(body["visible"])
                    if "name" in body:
                        m.name = str(body["name"])
                    if "colour" in body:
                        c = [float(x) for x in body["colour"]]
                        if len(c) < 3:  # a short tuple would break every
                            raise ValueError(  # later slice render
                                "colour needs [r, g, b] in 0..1")
                        m.colour = tuple(
                            min(max(x, 0.0), 1.0) for x in c[:3])
                    self._json(m.to_dict())
                elif self.path == "/api/raycast/preset":
                    # bake an edited CLUT (reference clut_raycasting.py
                    # OnChangeCurve -> control.py SaveRaycastingPreset)
                    from invesalius3_tpu_torch.ops import raycast

                    p = raycast.preset_from_nodes(
                        body.get("name", "Custom"), body["lo"], body["hi"],
                        body["alpha_nodes"], body["color_nodes"],
                        shading=body.get("shading", True),
                        mode=body.get("mode", "composite"),
                        bg=tuple(body.get("bg", (0.0, 0.0, 0.0))))
                    state.custom_presets[p.name] = p
                    saved = None
                    if body.get("save"):
                        saved = str(raycast.save_user_preset(p))
                    self._json({"name": p.name, "saved": saved})
                elif self.path == "/api/brush":
                    from invesalius3_tpu_torch.ops import morphology as morph

                    strokes = np.asarray(body["strokes"], np.int32)  # (N, 3) z,y,x
                    radius = float(body.get("radius_mm", 2.0))
                    shape = body.get("shape", "circle")
                    erase = bool(body.get("erase", False))
                    # three-way editor ops (reference styles.py:1361
                    # EditorConfig + slice_.py:722 edit_mask_pixel):
                    # paint/erase plus the four threshold-gated variants
                    op = body.get("op", "erase" if erase else "paint")
                    sx, sy, sz = slc.spacing
                    brush = morph.brush_element(radius, (sx, sy, sz), shape)
                    mask = slc.current_mask or slc.create_new_mask(
                        apply_threshold=False)
                    if "threshold_range" in body:
                        lo, hi = body["threshold_range"]
                        mask.edition_threshold_range = (float(lo), float(hi))
                    if op in ("paint", "erase"):
                        value = 254 if op == "paint" else 1  # editor codes
                        new = morph.paint_brush_trajectory(
                            mask.data, brush, strokes, value, tuple(brush.shape))
                    else:
                        op_key = {"threshold": "thresh",
                                  "threshold_erase": "thresh_erase",
                                  "threshold_add": "thresh_add",
                                  "threshold_erase_only": "thresh_erase_only",
                                  }.get(op)
                        if op_key is None:
                            raise ValueError(f"unknown brush op {op!r}")
                        tmin, tmax = mask.edition_threshold_range
                        new = morph.paint_brush_trajectory_threshold(
                            mask.data, slc.matrix, brush, strokes, tmin, tmax,
                            tuple(brush.shape), op_key)
                    mask.apply(new)
                    self._json({"stamps": int(len(strokes)),
                                "voxels": _visible_voxels(mask)})
                elif self.path == "/api/threshold":
                    m = slc.create_new_mask(
                        threshold_range=(body["tmin"], body["tmax"]))
                    n = _visible_voxels(m)
                    state.record_event("mask.created", {"index": m.index, "voxels": n})
                    self._json({"index": m.index, "voxels": n})
                elif self.path == "/api/floodfill":
                    # region grow: threshold / dynamic-range / confidence
                    # (reference styles.py:3015 FFillSegmentationConfig
                    # methods)
                    from invesalius3_tpu_torch.ops import floodfill

                    seed = tuple(body["seed"])
                    method = body.get("method", "threshold")
                    if method == "dynamic":
                        reached = floodfill.region_grow_dynamic(
                            slc.matrix, seed,
                            float(body.get("dev_min", 25.0)),
                            float(body.get("dev_max", 25.0)),
                            use_ww_wl=bool(body.get("use_ww_wl", False)),
                            ww=slc.window_width, wl=slc.window_level)
                    elif method == "confidence":
                        reached = floodfill.region_grow_confidence(
                            slc.matrix, seed,
                            mult=float(body.get("mult", 2.5)),
                            iters=int(body.get("iters", 3)))
                    else:
                        seeds = torch.zeros(slc.matrix.shape, dtype=torch.bool,
                                            device=dev)
                        seeds[seed] = True
                        reached = floodfill.floodfill_threshold(
                            slc.matrix, seeds, body["tmin"], body["tmax"])
                    mask = slc.current_mask or slc.create_new_mask(apply_threshold=False)
                    mask.apply(floodfill.apply_fill(
                        mask.data, reached, body.get("fill", 254)))
                    self._json({"voxels": int(reached.sum())})
                elif self.path == "/api/watershed":
                    from invesalius3_tpu_torch.ops import watershed

                    # the markers are made on the device; a position
                    # given twice keeps its last label, as numpy writes
                    shape = tuple(slc.matrix.shape)
                    marks = {}
                    for mk in body["markers"]:
                        pos = tuple(int(c) % n if -n <= int(c) < n else int(c)
                                    for c, n in zip(mk["position"], shape))
                        marks[pos] = int(np.int16(mk["label"]))
                    markers = torch.zeros(shape, dtype=torch.int16, device=dev)
                    if marks:
                        idx = torch.tensor(list(marks), dtype=torch.int64,
                                           device=dev)
                        markers[tuple(idx.t())] = torch.tensor(
                            list(marks.values()), dtype=torch.int16, device=dev)
                    labels = watershed.watershed(
                        slc.matrix, markers,
                        algorithm=body.get("algorithm", "Watershed"))
                    keep = body.get("keep_label", 1)
                    mask = slc.current_mask or slc.create_new_mask(apply_threshold=False)
                    kept = labels == keep
                    mask.apply(kept.to(torch.uint8) * 253)
                    self._json({"voxels": int(kept.sum())})
                elif self.path == "/api/import":
                    # load a new study into the running server (reference
                    # import panel -> Controller.OpenDicomGroup /
                    # OpenOtherFiles)
                    from pathlib import Path as _P

                    from invesalius3_tpu_torch.core.volume import Volume

                    path = _P(body["path"])
                    if path.is_dir():
                        from invesalius3_tpu_torch.io import dicom as dcm

                        groups = state.dicom_groups(str(path))
                        uid = body.get("series")
                        sel = [g for g in groups
                               if g.preview_info()["series_uid"] == uid]
                        g = sel[0] if sel else max(groups,
                                                   key=lambda g: len(g.files))
                        data, spacing, affine = dcm.group_to_volume(g, device=dev)
                        vol = Volume.from_tensor(
                            data, spacing=spacing, affine=affine,
                            modality=g.files[0].get("Modality", "CT"))
                    elif path.suffix.lower() in (".par", ".rec"):
                        from invesalius3_tpu_torch.io import parrec

                        data, spacing = parrec.read_par_rec(path)
                        vol = Volume.from_numpy(data, spacing=spacing,
                                                device=dev)
                    else:
                        from invesalius3_tpu_torch.io import nifti

                        img = nifti.read_nifti(path)
                        vol = Volume.from_numpy(img.data,
                                                spacing=img.spacing,
                                                affine=img.affine, device=dev)
                    slc.load_new_volume(vol)
                    state.surfaces = {}
                    state.mesh_bin_cache.clear()
                    state.crop_box = None
                    state.warm_render_cache()
                    self._json({"shape": list(vol.shape),
                                "spacing": list(vol.spacing)})
                elif self.path == "/api/project/props":
                    # name/modality editing (reference
                    # gui/project_properties.py dialog)
                    if "name" in body:
                        state.project_name = str(body["name"])
                    if "modality" in body:
                        import dataclasses as _dc

                        slc.volume = _dc.replace(  # Volume is frozen
                            slc.volume, modality=str(body["modality"]))
                    self._json({"name": getattr(state, "project_name", ""),
                                "modality": slc.volume.modality})
                elif self.path == "/api/project/save":
                    # assemble the live session into a .inv3 (reference
                    # control.py SaveProject / project.py SavePlistProject)
                    from invesalius3_tpu_torch.core.project import Project
                    from invesalius3_tpu_torch.core.session import Session

                    proj = Project()
                    proj.name = (body.get("name")
                                 or getattr(state, "project_name", "")
                                 or "web_project")
                    proj.volume = slc.volume
                    proj.modality = slc.volume.modality
                    proj.window = slc.window_width
                    proj.level = slc.window_level
                    for m in slc.masks.values():
                        proj.add_mask(m)
                        if m.threshold_range:
                            proj.threshold_range = tuple(m.threshold_range)
                    for s in state.surfaces.values():
                        proj.add_surface(s)
                    proj.measurement_dict = state.measures.to_dict()
                    if getattr(slc, "_image_versions", None):
                        proj.image_versions = slc.image_versions
                    path = body["path"]
                    proj.save(path, compress=bool(body.get("compress", False)))
                    sess = getattr(state, "_session", None) or Session()
                    state._session = sess
                    sess.add_recent_project(path, proj.name)
                    if sess.get_config("auto_backup", True):
                        # keep backing up the open project (reference
                        # session CreateAutoBackup)
                        sess.create_auto_backup(proj)
                    self._json({"path": path, "masks": len(proj.mask_dict),
                                "surfaces": len(proj.surface_dict),
                                "measures": len(proj.measurement_dict)})
                elif self.path in ("/api/project/open",
                                   "/api/session/recover"):
                    from invesalius3_tpu_torch.core.project import Project
                    from invesalius3_tpu_torch.core.surface import Surface

                    if self.path.endswith("recover"):
                        # open the crash auto-backup (reference splash
                        # CheckCrashRecovery restore path)
                        from invesalius3_tpu_torch.core.session import Session

                        sess = getattr(state, "_session", None) or Session()
                        state._session = sess
                        backup = sess.recover_auto_backup()
                        if backup is None:
                            raise ValueError(tr("no crash backup to recover"))
                        path_to_open = str(backup)
                    else:
                        path_to_open = body["path"]
                    proj = Project.open(path_to_open, device=dev)
                    state.project_name = proj.name
                    slc.load_new_volume(proj.volume)
                    slc.set_window(proj.window, proj.level)
                    slc.masks = dict(proj.mask_dict)
                    slc.current_mask = next(iter(slc.masks.values()), None)
                    if proj.image_versions:
                        slc._image_versions = list(proj.image_versions)
                    state.surfaces = dict(proj.surface_dict)
                    state.mesh_bin_cache.clear()
                    # class counters must clear the loaded indices or the
                    # next create_new_mask / Surface() would collide with
                    # (and overwrite) a loaded object
                    from invesalius3_tpu_torch.core.mask import Mask as _Mask

                    _Mask.general_index = max(
                        [_Mask.general_index] + list(slc.masks), default=-1)
                    Surface._counter[0] = max(
                        [Surface._counter[0]] + list(state.surfaces))
                    state.measures.measures.clear()
                    state.measures.load_dict(proj.measurement_dict)
                    state.crop_box = None
                    self._json({"name": proj.name,
                                "shape": list(proj.volume.shape),
                                "masks": len(slc.masks),
                                "surfaces": len(state.surfaces),
                                "measures": len(state.measures.measures)})
                elif self.path == "/api/config":
                    from invesalius3_tpu_torch.core.session import Session

                    sess = getattr(state, "_session", None) or Session()
                    state._session = sess
                    for k, v in body.items():
                        sess.set_config(k, v)
                    self._json({"config": dict(sess.config)})
                elif self.path == "/api/overlay":
                    # fMRI-style colormapped overlay from a NIfTI file
                    # (reference task_fmrisupport.py OnLoadFmri)
                    from invesalius3_tpu_torch.io import nifti

                    img = nifti.read_nifti(body["path"])
                    slc.set_color_overlay(
                        img.data, colormap=body.get("colormap", "autumn"),
                        alpha=float(body.get("alpha", 0.6)))
                    self._json({"ok": True})
                elif self.path == "/api/overlay/clear":
                    slc.clear_color_overlay()
                    self._json({"ok": True})
                elif self.path == "/api/nav/connect":
                    nav = state.nav
                    ok = nav.tracker.connect(
                        body.get("tracker_id", "debug_random"),
                        poll_hz=float(body.get("poll_hz", 120.0)))
                    self._json({"connected": bool(ok)})
                elif self.path == "/api/nav/disconnect":
                    state.nav.tracker.disconnect()
                    self._json({"connected": False})
                elif self.path == "/api/nav/fiducial/tracker":
                    state.nav.tracker.set_tracker_fiducial(int(body["index"]))
                    self._json({"set": state.nav.tracker.are_fiducials_set()})
                elif self.path == "/api/nav/fiducial/image":
                    state.nav.image.set(int(body["index"]), body["position"])
                    self._json({"set": state.nav.image.are_set()})
                elif self.path == "/api/nav/register":
                    fre = state.nav.navigation.estimate_tracker_to_image_transform()
                    self._json({"fre": float(fre)})
                elif self.path == "/api/nav/start":
                    state.nav.navigation.start_navigation(
                        poll_hz=float(body.get("poll_hz", 30.0)))
                    self._json({"navigating": True})
                elif self.path == "/api/nav/stop":
                    state.nav.navigation.stop_navigation()
                    # drop live-worker payloads so stopped scenes don't
                    # keep rendering stale tracts / e-field textures
                    state.last_tracts = None
                    state.last_efield = None
                    self._json({"navigating": False})
                elif self.path == "/api/nav/tracts":
                    # configure live tractography for the next navigation
                    # run (reference task_tractography.py: Trekker FOD +
                    # ACT mask load, n_tracts; spawned by StartNavigation)
                    navg = state.nav.navigation
                    if not body.get("enable", True):
                        navg.tract_params = None
                        state.last_tracts = None
                        state._tract_vox_to_world = None
                        self._json({"tracts_enabled": False})
                    else:
                        params = {
                            "n_tracts_total": int(body.get("n_tracts", 32)),
                            "step_size": float(body.get("step_size", 0.5)),
                            "n_steps": int(body.get("n_steps", 80)),
                            "max_angle": float(body.get("max_angle", 0.4)),
                        }
                        if body.get("fod_path") or body.get("field_path"):
                            from invesalius3_tpu_torch.io import nifti

                            # keep_4d: FOD SH / direction components ride
                            # the 4th axis (a plain read returns only the
                            # first component volume)
                            img = nifti.read_nifti(
                                body.get("fod_path") or body["field_path"],
                                keep_4d=True)
                            key = ("fod_sh" if body.get("fod_path")
                                   else "direction_field")
                            if img.data.ndim != 4:
                                raise ValueError(
                                    f"{key} file must be 4-D (Z,Y,X,C); "
                                    f"got shape {img.data.shape}")
                            params[key] = np.asarray(img.data)
                            mask = nifti.read_nifti(body["mask_path"]).data \
                                if body.get("mask_path") else None
                            params["stop_mask"] = (
                                np.asarray(mask) > 0 if mask is not None
                                else np.ones(img.data.shape[:3], bool))
                            params["world_to_vox"] = \
                                _world_to_vox_from_affine(img.affine)
                            # streamlines come back on the FIELD grid
                            state._tract_vox_to_world = \
                                _vox_to_world_from_affine(img.affine)
                        else:
                            # demo field: straight superior-inferior
                            # streamlines on a coarse grid over the volume
                            shape = slc.volume.shape
                            f = max(1, (max(shape) + 63) // 64)
                            cs = tuple(max(2, s // f) for s in shape)
                            field = np.zeros(cs + (3,), np.float32)
                            field[..., 0] = 1.0  # unit +z principal dir
                            params["direction_field"] = field
                            params["stop_mask"] = np.ones(cs, bool)
                            vol = slc.volume
                            params["world_to_vox"] = (
                                lambda p, _v=vol, _f=f:
                                np.asarray(_v.world_to_voxel(p)) / _f)
                            state._tract_vox_to_world = (
                                lambda zyx, _v=vol, _f=f:
                                _v.voxel_to_world(np.asarray(zyx) * _f))
                        navg.tract_params = params
                        self._json({"tracts_enabled": True,
                                    "n_tracts": params["n_tracts_total"]})
                elif self.path == "/api/nav/efield":
                    # configure the e-field worker: debug solver over an
                    # existing surface's vertices as the ROI (reference
                    # task_efield.py + e_field.py; the real solver hangs
                    # off NeuronavigationApi)
                    navg = state.nav.navigation
                    if not body.get("enable", True):
                        navg.efield_params = None
                        state.last_efield = None
                        state._efield_surface_index = None
                        self._json({"efield_enabled": False})
                    else:
                        si = int(body.get(
                            "surface_index", min(state.surfaces, default=0)))
                        surf = state.surfaces[si]
                        verts = np.asarray(surf.vertices, np.float32)
                        stride = max(1, len(verts) // int(
                            body.get("max_roi_vertices", 20000)))
                        roi_idx = np.arange(0, len(verts), stride)
                        navg.efield_params = {
                            "roi_vertices": verts[roi_idx],
                            "roi_ids": roi_idx,
                            "debug": True,
                        }
                        state._efield_surface_index = si
                        self._json({"efield_enabled": True,
                                    "roi_vertices": len(roi_idx)})
                elif self.path == "/api/pedal":
                    # programmatic pedal press (reference
                    # pedal_connection.py; the pedal's navigation use is
                    # marking the current probe position / confirming a
                    # capture).  While navigating, a press drops a marker
                    # at the latest coregistered probe position.
                    from invesalius3_tpu_torch.net.pedal_connection import (
                        ProgrammaticPedal)

                    pedal = getattr(state, "_pedal", None)
                    if pedal is None:
                        pedal = state._pedal = ProgrammaticPedal()
                    pressed = bool(body.get("pressed", True))
                    if pressed:
                        pedal.press()
                    else:
                        pedal.release()
                    slc.bus.send_message("pedal.state", pressed=pressed)
                    out = {"pressed": pressed}
                    if (pressed and state.nav.navigation.is_navigating
                            and state.last_scene is not None):
                        from invesalius3_tpu_torch.navigation.markers import (
                            Marker, MarkerType)

                        pos = tuple(float(x) for x in
                                    state.last_scene["probe_pose_img"][:3])
                        m = state.nav.markers.add(Marker(
                            marker_type=MarkerType.LANDMARK,
                            position=pos, label="pedal"))
                        out["marker_id"] = m.marker_id
                    self._json(out)
                elif self.path == "/api/nav/mtms/load":
                    # multichannel-TMS parameter table (reference mtms.py
                    # pulse-parameter file + task panel)
                    from invesalius3_tpu_torch.navigation.mtms import MTMS

                    mt = getattr(state, "_mtms", None) or MTMS(
                        bus=slc.bus, intensity=float(
                            body.get("intensity", 20.0)))
                    state._mtms = mt
                    n = mt.load_parameter_file(body["path"])
                    self._json({"n_keys": n})
                elif self.path == "/api/nav/mtms/target":
                    # map one brain target to a grid offset and fire a
                    # (dry-run) pulse (reference mtms.py UpdateTarget)
                    mt = getattr(state, "_mtms", None)
                    if mt is None:
                        raise ValueError(tr("load a parameter file first"))
                    coil = body["coil_pose"]
                    tgt = body["brain_target"]
                    offset = mt.get_offset(coil, tgt)
                    fired = mt.update_target(coil, tgt)
                    self._json({"fired": bool(fired),
                                "offset": [int(x) for x in offset]})
                elif self.path == "/api/nav/mtms/sequence":
                    # randomized multi-target sequence + CSV log
                    # (reference UpdateTargetSequence + SaveSequence)
                    import random as _random

                    mt = getattr(state, "_mtms", None)
                    if mt is None:
                        raise ValueError(tr("load a parameter file first"))
                    ok = mt.update_target_sequence(
                        body["coil_pose"], body["brain_targets"],
                        number_of_stim=int(body.get("number_of_stim", 1)),
                        rng=_random.Random(int(body.get("seed", 0))),
                        sleep=lambda s: None)  # no wall-clock waits over HTTP
                    out = {"ok": bool(ok), "pulses": len(mt.sequence_log)}
                    if ok and body.get("save_dir"):
                        out["log"] = str(mt.save_sequence(body["save_dir"]))
                    self._json(out)
                elif self.path == "/api/nav/icp":
                    # surface-based registration refinement (reference
                    # iterativeclosestpoint.py + the refine dialog: touch
                    # scalp points with the probe, ICP against the head
                    # surface)
                    navg = state.nav.navigation
                    if not body.get("enable", True):
                        navg.icp.use_icp = False
                        self._json({"use_icp": False})
                    else:
                        import time as _time

                        from invesalius3_tpu_torch.navigation.coregistration \
                            import corregistrate_probe

                        if navg.m_change is None:
                            raise ValueError(tr("run fiducial registration first"))
                        surf = state.surfaces[int(body.get(
                            "surface_index",
                            min(state.surfaces, default=0)))]
                        verts = np.asarray(surf.vertices, np.float32)
                        stride = max(1, len(verts) // 10000)
                        n = int(body.get("n_samples", 20))
                        hz = float(body.get("poll_hz", 60.0))
                        # the sampling loop runs under the global POST
                        # lock — bound its wall time so caller-controlled
                        # params cannot freeze every other endpoint
                        n = min(n, 1000)
                        # honor slow poll rates (operator repositioning
                        # between probe touches) — the 30 s window bound
                        # below rejects infeasible (n, hz) loudly rather
                        # than silently resampling at a different rate
                        hz = min(1000.0, max(hz, 0.1))
                        if n / hz > 30.0:
                            raise ValueError(
                                "ICP sampling window too long "
                                f"({n}/{hz:g} Hz > 30 s)")
                        pts = []
                        for _ in range(n):  # probe-touch samples
                            coords, _fl = state.nav.tracker.get_coordinates()
                            ref = (coords[1]
                                   if navg.use_dynamic_reference else None)
                            m = corregistrate_probe(
                                navg.m_change, coords[0], ref, None)
                            pts.append(np.asarray(m[:3, 3], float))
                            _time.sleep(1.0 / hz)
                        err = navg.icp.register(verts[::stride],
                                                np.asarray(pts), device=dev)
                        self._json({"use_icp": True,
                                    "icp_error_mm": float(err),
                                    "n_samples": n})
                elif self.path == "/api/nav/robot/connect":
                    # robot panel (reference task_navigator.py robot rows +
                    # navigation/robot.py): connect by IP
                    r = state.nav.robots.get(body.get("robot_id", "robot0"))
                    r.connect(body["ip"])
                    self._json({"robot_id": r.robot_id, "connected": True})
                elif self.path == "/api/nav/robot/objective":
                    from invesalius3_tpu_torch.navigation.robot import (
                        RobotObjective)

                    r = state.nav.robots.get(body.get("robot_id", "robot0"))
                    r.set_objective(RobotObjective[body["objective"]])
                    self._json({"robot_id": r.robot_id,
                                "objective": r.objective.name})
                elif self.path == "/api/nav/robot/target":
                    # image-space target -> tracker space -> robot
                    # (reference robot.py:254 SendTargetToRobot); the target
                    # is a marker's pose or an explicit 6-dof pose
                    r = state.nav.robots.get(body.get("robot_id", "robot0"))
                    if "marker_id" in body:
                        mk = next(m for m in state.nav.markers.markers
                                  if m.marker_id == int(body["marker_id"]))
                        pose = np.asarray(list(mk.position)
                                          + list(mk.orientation), float)
                    else:
                        pose = np.asarray(body["pose"], float)
                    m_trk = r.send_target(state.nav.navigation, pose)
                    self._json({"robot_id": r.robot_id,
                                "target_tracker": [list(map(float, row))
                                                   for row in m_trk]})
                elif self.path == "/api/nav/robot/free_drive":
                    r = state.nav.robots.get(body.get("robot_id", "robot0"))
                    r.set_free_drive(bool(body.get("enabled", True)))
                    self._json({"robot_id": r.robot_id,
                                "free_drive": bool(body.get("enabled", True))})
                elif self.path == "/api/nav/record":
                    # tracker-coordinate CSV recording (reference
                    # record_coords.py + its task_navigator checkbox)
                    rec = getattr(state, "_recorder", None)
                    if body.get("enable", True):
                        if rec is not None:
                            raise ValueError(tr("already recording"))
                        from pathlib import Path as _P

                        from invesalius3_tpu_torch.navigation.record_coords import (
                            RecordCoords)

                        # fail HERE, not silently inside the daemon thread
                        with open(_P(body["path"]), "w"):
                            pass
                        rec = RecordCoords(
                            state.nav.tracker, body["path"],
                            poll_hz=float(body.get("poll_hz", 20.0)))
                        rec.start()
                        state._recorder = rec
                        self._json({"recording": True, "path": str(rec.path)})
                    else:
                        if rec is not None:
                            rec.stop()
                            rec.join(timeout=5.0)
                            state._recorder = None
                        self._json({"recording": False,
                                    "path": None if rec is None
                                    else str(rec.path)})
                elif self.path == "/api/nav/markers":
                    from invesalius3_tpu_torch.navigation.markers import (
                        Marker, MarkerType)

                    m = state.nav.markers.add(Marker(
                        marker_type=MarkerType(int(body.get("type", 1))),
                        position=tuple(body["position"]),
                        label=body.get("label", ""),
                        mep_value=body.get("mep_value")))
                    self._json({"id": m.marker_id})
                elif self.path == "/api/nav/markers/remove":
                    state.nav.markers.delete(int(body["id"]))
                    self._json({"ok": True})
                elif self.path == "/api/surface/import":
                    from invesalius3_tpu_torch.core.surface import import_surface_file

                    surf = import_surface_file(
                        body["path"],
                        fill_holes_size=float(body.get("fill_holes_size", 300.0)),
                        device=dev)
                    state.surfaces[surf.index] = surf
                    state.record_event("surface.imported", {"index": surf.index})
                    self._json({
                        "index": surf.index, "triangles": int(len(surf.faces)),
                        "filled_holes": surf.filled_holes,
                        "volume_mm3": surf.volume, "area_mm2": surf.area,
                    })
                elif self.path == "/api/surface":
                    # full SurfaceCreationDialog option set (reference
                    # gui/dialogs.py SurfaceCreationOptions: quality
                    # preset, keep-largest, fill-holes, overwrite, name,
                    # ca_smoothing params)
                    surf = slc.create_surface_from_mask(
                        algorithm=body.get("algorithm", "Default"),
                        quality=body.get("quality",
                                         const.DEFAULT_SURFACE_QUALITY),
                        decimate_reduction=body.get("decimate_reduction"),
                        keep_largest=body.get("keep_largest", False),
                        fill_holes=body.get("fill_holes", False),
                        ca_options=body.get("ca_options"),
                        name=body.get("name", ""),
                    )
                    if body.get("overwrite") and state.surfaces:
                        # reference overwrite-last semantics: the new
                        # surface takes the previous newest's slot
                        last = max(state.surfaces)
                        state.surfaces.pop(last, None)
                        state.mesh_bin_cache.pop(last, None)
                        surf.index = last
                    state.surfaces[surf.index] = surf
                    self._json({
                        "index": surf.index, "triangles": int(len(surf.faces)),
                        "volume_mm3": surf.volume, "area_mm2": surf.area,
                    })
                elif self.path == "/api/segment/dl":
                    # DL segmentation job (reference
                    # deep_learning_seg_dialog.py: model picker +
                    # probability threshold + progress/cancel)
                    from invesalius3_tpu_torch.models import segment as seg

                    kinds = {"brain": seg.BrainSegmenter,
                             "trachea": seg.TracheaSegmenter,
                             "mandible": seg.MandibleSegmenter,
                             "implant": seg.ImplantSegmenter,
                             "subpart": seg.SubpartSegmenter}
                    kind = body.get("model", "brain")
                    kw = {"allow_random_init": bool(
                        body.get("allow_random_init", False))}
                    if kind == "subpart":  # smoke/test-size knobs
                        if "filters" in body:
                            kw["filters"] = int(body["filters"])
                        if "conform_size" in body:
                            kw["conform_size"] = int(body["conform_size"])
                    segmenter = kinds[kind](**kw, device=dev)
                    # the job reads the Slice's tensor where it lies
                    job = seg.SegmentJob(
                        segmenter, slc.matrix,
                        probability_threshold=float(
                            body.get("threshold", 0.5)),
                        batch_size=int(body.get("batch_size", 4)))
                    job.model_kind = kind
                    # FastSurfer per-structure mask categories (reference
                    # SubpartSegmentProcess selected_mask_types)
                    job.structures = body.get("structures", [])
                    job.mask_added = False
                    job.start()
                    state._dl_job = job
                    # per-model probability cache (reference keeps one
                    # memmap per dialog, segment.py:350): switching models
                    # must not discard the previous model's probabilities
                    if not hasattr(state, "_dl_jobs"):
                        state._dl_jobs = {}
                    state._dl_jobs[kind] = job
                    self._json({"started": True, "model": kind})
                elif self.path == "/api/segment/dl/status":
                    from invesalius3_tpu_torch.models import segment as seg_mod

                    job = getattr(state, "_dl_job", None)
                    if job is None:
                        self._json({"error": tr("no job")}, 404)
                        return
                    done = (job.mask is not None or job.exception is not None
                            or not job.is_alive())
                    out = {"progress": job.progress, "done": bool(done),
                           "error": repr(job.exception)
                           if job.exception else None}
                    if done and job.mask is not None and not job.mask_added:
                        m = slc.create_new_mask(
                            name=f"{job.model_kind} (DL)",
                            apply_threshold=False)
                        m.data = torch.from_numpy(
                            (np.asarray(job.mask) > 0).astype(np.uint8) * 255
                        ).to(dev)
                        job.mask_added = True
                        job.mask_index = m.index
                        out["mask_index"] = m.index
                        if (job.model_kind == "subpart"
                                and getattr(job, "structures", None)):
                            # one mask per parcellation structure
                            # (reference apply_segment_threshold :884)
                            extra = []
                            for name, bm, _lid in seg_mod.structure_masks(
                                    job.probability, job.structures):
                                sm = slc.create_new_mask(
                                    name=name, apply_threshold=False,
                                    show=False)
                                sm.data = torch.from_numpy(
                                    np.ascontiguousarray(bm)).to(dev)
                                extra.append(sm.index)
                            out["structure_mask_indices"] = extra
                    self._json(out)
                elif self.path == "/api/segment/dl/threshold":
                    # Interactive rethreshold of the LAST DL job's cached
                    # probability volume -- no re-inference (reference
                    # segment.py:350 apply_segment_threshold keeps the
                    # probability memmap and rethresholds on slider moves).
                    # Optional "model" selects a prior job's cached
                    # probabilities (one cache per model, like the
                    # reference's per-dialog memmaps) — rethresholding the
                    # previous model after a switch does no inference.
                    if "model" in body:
                        job = getattr(state, "_dl_jobs", {}).get(
                            body["model"])
                    else:
                        job = getattr(state, "_dl_job", None)
                    if job is None or job.probability is None:
                        self._json({"error": tr("no finished DL job")}, 404)
                        return
                    thr = float(body.get("threshold", 0.5))
                    if getattr(job, "model_kind", "") == "subpart":
                        # labelmap rides in the probability slot: any
                        # nonzero structure is foreground, threshold n/a
                        newmask = (job.probability > 0).astype(np.uint8) * 255
                    else:
                        newmask = np.where(
                            job.probability >= thr, 255, 0).astype(np.uint8)
                    job.mask = newmask
                    job.threshold = thr
                    midx = getattr(job, "mask_index", None)
                    if midx is not None and midx in slc.masks:
                        slc.masks[midx].data = torch.from_numpy(newmask).to(dev)
                    state.record_event("segment.rethreshold",
                                       {"threshold": thr})
                    self._json({"ok": True, "threshold": thr,
                                "mask_index": midx,
                                "voxels": int((newmask > 0).sum())})
                elif self.path == "/api/segment/dl/cancel":
                    job = getattr(state, "_dl_job", None)
                    if job is not None:
                        job.stop()
                    self._json({"ok": True})
                elif self.path == "/api/pacs/echo":
                    # PACS verification (reference import_network_panel.py
                    # "check status" -> dicom.py RunCEcho)
                    net = _pacs_client(body)
                    self._json({"ok": bool(net.RunCEcho(
                        timeout=float(body.get("timeout", 5.0))))})
                elif self.path == "/api/pacs/find":
                    # study query (reference import_network_panel.py
                    # OnButtonSearch -> dicom.py RunCFind)
                    net = _pacs_client(body)
                    results = net.RunCFind(
                        patient_name=body.get("patient_name", "*"),
                        level=body.get("level", "STUDY"),
                        timeout=float(body.get("timeout", 10.0)))
                    self._json([
                        {k: (v if isinstance(v, (str, int, float)) else repr(v))
                         for k, v in r.items()} for r in results])
                elif self.path == "/api/pacs/move":
                    # retrieve a study into a local folder, then import its
                    # largest series onto the Slice's device (reference
                    # import_network_panel.py OnUpload -> dicom.py RunCMove
                    # -> Controller import flow)
                    from pathlib import Path as _P

                    net = _pacs_client(body)
                    dest = _P(body["dest"])
                    dest.mkdir(parents=True, exist_ok=True)
                    files = net.RunCMove(
                        body["study_uid"], dest,
                        listen_port=int(body.get("listen_port", 0)),
                        timeout=float(body.get("timeout", 30.0)))
                    out = {"files": [str(f) for f in files]}
                    if body.get("import", True) and files:
                        from invesalius3_tpu_torch.core.volume import Volume
                        from invesalius3_tpu_torch.io import dicom as dcm

                        state._dicom_cache = None
                        groups = state.dicom_groups(str(dest))
                        g = max(groups, key=lambda g: len(g.files))
                        data, spacing, affine = dcm.group_to_volume(g, device=dev)
                        slc.load_new_volume(Volume.from_tensor(
                            data, spacing=spacing, affine=affine,
                            modality=g.files[0].get("Modality", "CT")))
                        state.surfaces = {}
                        state.mesh_bin_cache.clear()
                        state.crop_box = None
                        state.warm_render_cache()
                        out["shape"] = list(slc.volume.shape)
                    self._json(out)
                elif self.path == "/api/i18n":
                    # switch UI language at runtime (reference
                    # language_dialog.py + session SetLanguage)
                    from invesalius3_tpu_torch.core.session import Session
                    from invesalius3_tpu_torch.utils import i18n as i18n_mod

                    lang = body["language"]
                    if lang not in i18n_mod.get_locales():
                        raise ValueError(tr("unknown locale {lang}").format(lang=lang))
                    i18n_mod.install_language(lang)
                    import os as _os

                    _os.environ["INV3_LANGUAGE"] = lang
                    sess = getattr(state, "_session", None) or Session()
                    state._session = sess
                    sess.set_config("language", lang)
                    self._json({"current": lang,
                                "catalog": current_catalog(lang)})
                elif self.path == "/api/surface/remove":
                    del state.surfaces[int(body["index"])]
                    state.mesh_bin_cache.pop(int(body["index"]), None)
                    state.record_event("surface.removed",
                                       {"index": int(body["index"])})
                    self._json({"ok": True})
                elif self.path == "/api/surface/props":
                    # reference data_notebook per-row controls: colour /
                    # transparency / name / visibility
                    surf = state.surfaces[int(body["index"])]
                    if "colour" in body:
                        surf.colour = tuple(float(c) for c in body["colour"])
                    if "transparency" in body:
                        surf.transparency = float(body["transparency"])
                    if "name" in body:
                        surf.name = str(body["name"])
                    if "visible" in body:
                        surf.is_shown = bool(body["visible"])
                    self._json({"ok": True})
                elif self.path == "/api/surface/split":
                    # reference surface.py:431 OnSplitSurface (all
                    # components) / :319 OnSeedSurface (seeded selection)
                    from invesalius3_tpu_torch.core import surface as surface_mod

                    surf = state.surfaces[int(body["index"])]
                    if "seeds" in body:
                        parts = [surface_mod.surface_from_seeds(
                            surf, np.asarray(body["seeds"], float), device=dev)]
                    else:
                        parts = surface_mod.split_surface(surf, device=dev)
                    for s in parts:
                        state.surfaces[s.index] = s
                    self._json([{"index": s.index, "name": s.name,
                                 "triangles": int(len(s.faces))}
                                for s in parts])
                elif self.path == "/api/surface/smooth":
                    from invesalius3_tpu_torch.core import surface as surface_mod

                    surf = state.surfaces[int(body["index"])]
                    s = surface_mod.smooth_surface(
                        surf, iterations=int(body.get("iterations", 20)),
                        relaxation=float(body.get("relaxation", 0.4)),
                        device=dev)
                    state.surfaces[s.index] = s
                    self._json({"index": s.index, "name": s.name})
                elif self.path == "/api/surface/remove_non_visible":
                    # visibility-based face culling (reference
                    # polydata_utils.py:363 + task_navigator.py:916 scalp
                    # simplification; frame.py:847 menu action)
                    from invesalius3_tpu_torch.ops import render_mesh

                    surf = state.surfaces[int(body["index"])]
                    v, f, ratio = render_mesh.remove_non_visible_faces(
                        surf.vertices, surf.faces,
                        remove_visible=bool(body.get(
                            "remove_visible", False)), device=dev)
                    surf.vertices, surf.faces = v, f
                    surf.compute_properties(dev)
                    state.record_event("surface.non_visible_removed",
                                       {"index": surf.index,
                                        "kept_ratio": ratio})
                    self._json({"index": surf.index,
                                "kept_ratio": ratio,
                                "triangles": len(f)})
                elif self.path == "/api/surface/decimate":
                    from invesalius3_tpu_torch.core import surface as surface_mod

                    surf = state.surfaces[int(body["index"])]
                    v, f = surface_mod.decimate(
                        surf.vertices, surf.faces,
                        float(body.get("reduction", 0.5)))
                    s = surface_mod.Surface(
                        vertices=v, faces=f,
                        name=f"{surf.name} (decimated)")
                    s.colour = surf.colour
                    s.compute_properties(dev)
                    state.surfaces[s.index] = s
                    self._json({"index": s.index,
                                "triangles": int(len(s.faces))})
                else:
                    self._json({"error": tr("not found")}, 404)

    return Handler


class ViewerServer:
    """The viewer server over ``slc``.  It computes where the Slice's volume
    lies: on the card for a volume made with the entry points' default
    device (a CUDA volume without a card raises), on the CPU for one made
    with ``device="cpu"``.  Port 0 picks a free port (``self.port``)."""

    def __init__(self, slc: Slice, host: str = "127.0.0.1", port: int = 0):
        self.state = AppState(slc)
        self.httpd = ThreadingHTTPServer((host, port), make_handler(self.state))
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                        name="viewer-server")
        self._thread.start()
        return self

    def stop(self):
        """Stop serving, close the socket and join the serving thread."""
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join()

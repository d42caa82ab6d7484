/* invesalius3_tpu web viewer — dependency-free client for server.py.
 *
 * The behavioral equivalent of the reference's wx/VTK viewer stack:
 * 3-plane slice browser with scroll + WW/WL drag + crosshair
 * (viewer_slice.py), mask-edit tools calling the segmentation endpoints
 * (styles.py brush/floodfill/watershed), measure placement rendered by
 * the server's canvas layer (measures.py + canvas_renderer.py), surface
 * list with STL download (task_surface.py + exporter), and a 3D pane
 * driven by the server-side shear-warp raycaster (viewer_volume.py).
 */
"use strict";

const $ = (sel) => document.querySelector(sel);
const $$ = (sel) => [...document.querySelectorAll(sel)];

// --- i18n (reference i18n.py gettext; catalog served by /api/i18n) ----------
// msgid = the literal English UI string; ?lang=de in the page URL (or the
// preferences language) renders a translated UI.

let CATALOG = {};
const T = (s) => CATALOG[s] || s;

async function initI18n() {
  const lang = new URLSearchParams(location.search).get("lang");
  try {
    const r = await api("/api/i18n" + (lang ? `?lang=${lang}` : ""));
    CATALOG = r.catalog || {};
  } catch (e) {
    return;
  }
  if (!Object.keys(CATALOG).length) return;
  // translate the static chrome in place: any element whose trimmed text
  // (or title) is a catalog msgid — gettext-by-source-string, so new
  // UI elements are covered the moment their string enters the catalog
  $$("#sidebar h3, button, .toolopts span, .pane-head select option")
    .forEach((el) => {
      if (el.childElementCount) return;
      const key = el.textContent.trim();
      if (CATALOG[key]) el.textContent = CATALOG[key];
    });
  $$("[title]").forEach((el) => {
    if (CATALOG[el.title]) el.title = CATALOG[el.title];
  });
}

const state = {
  shape: [1, 1, 1],          // [Z, Y, X]
  spacing: [1, 1, 1],        // [sx, sy, sz]
  ww: 2000, wl: 300,
  projection: 0, slabs: 1,
  tool: "cursor",
  idx: { AXIAL: 0, CORONAL: 0, SAGITAL: 0 },
  cross: null,               // [z, y, x] voxel
  wsMarkers: [],
  pending: [],               // clicks collected for multi-point measures
  geoPicks: [],              // surface picks collected for the geodesic tool
  azimuth: 30, elevation: 20,
  raycastPreset: "",
  bump: 0,
};

function api(path, body) {
  const opts = body === undefined ? {} :
    { method: "POST", body: JSON.stringify(body),
      headers: { "Content-Type": "application/json" } };
  return fetch(path, opts).then(async (r) => {
    const j = await r.json().catch(() => ({}));
    if (!r.ok) { setStatus(j.error || r.statusText); throw new Error(j.error); }
    return j;
  });
}

function setStatus(msg) { $("#status").textContent = msg || ""; }

// --- geometry ---------------------------------------------------------------

function sliceCount(orient) {
  const [Z, Y, X] = state.shape;
  return orient === "AXIAL" ? Z : orient === "CORONAL" ? Y : X;
}

// (col,row) pixel + slice index -> voxel [z,y,x]
function toVoxel(orient, col, row) {
  const i = state.idx[orient];
  if (orient === "AXIAL") return [i, row, col];
  if (orient === "CORONAL") return [row, i, col];
  return [row, col, i]; // SAGITAL: cols are y
}

function voxelToWorld([z, y, x]) {
  const [sx, sy, sz] = state.spacing;
  return [x * sx, y * sy, z * sz];
}

// voxel -> (col,row) in a pane
function toPixel(orient, [z, y, x]) {
  if (orient === "AXIAL") return [x, y];
  if (orient === "CORONAL") return [x, z];
  return [y, z];
}

function paneIndexOf(orient, [z, y, x]) {
  return orient === "AXIAL" ? z : orient === "CORONAL" ? y : x;
}

// --- rendering --------------------------------------------------------------

function sliceURL(orient) {
  const i = state.idx[orient];
  let u = `/api/slice/${orient.toLowerCase()}/${i}?ww=${state.ww}&wl=${state.wl}` +
          `&projection=${state.projection}&slabs=${state.slabs}` +
          `&ruler=1&labels=1&t=${state.bump}`;
  if (state.cross && paneIndexOf(orient, state.cross) === i) {
    const [c, r] = toPixel(orient, state.cross);
    u += `&cx=${c}&cy=${r}`;
  }
  return u;
}

function refreshSlices(orients) {
  state.bump++;
  (orients || ["AXIAL", "CORONAL", "SAGITAL"]).forEach((o) => {
    const pane = document.querySelector(`.pane[data-orient="${o}"]`);
    pane.querySelector("img").src = sliceURL(o);
    pane.querySelector(".slice-no").textContent =
      `${state.idx[o]} / ${sliceCount(o) - 1}`;
    pane.querySelector(".slider").value = state.idx[o];
  });
}

function refresh3D(full) {
  const mode = $("#mode3d").value;
  const glMode = mode === "surfaces-gl" || mode === "volume-gl";
  $("#gl3d").style.display = glMode ? "" : "none";
  $("#img3d").style.display = glMode ? "none" : "";
  if (glMode) {
    $("#angles").textContent =
      `az ${state.azimuth.toFixed(0)}° el ${state.elevation.toFixed(0)}°`;
    if (mode === "volume-gl") { volGLEnsure().then(volGLRender); return; }
    if (!gl3d.loaded) gl3dLoad().then(gl3dRender);
    else gl3dRender();
    return;
  }
  let base = mode === "surfaces" ? "/api/render_scene?" :
    `/api/render?preset=${encodeURIComponent(state.raycastPreset)}&`;
  if (mode === "surfaces") {   // MEP / e-field surface texturing toggles
    if ($("#ov-mep").checked) base += "mep=1&";
    if ($("#ov-efield").checked) base += "efield=1&";
    if ($("#ov-slice").checked) {  // current axial slice as a plane
      base += `slice=AXIAL:${state.idx.AXIAL}&`;
    }
    if ($("#ov-ssao").checked) base += "ssao=1&";  // vtkSSAOPass parity
  }
  // progressive refinement: interactive frames use the server's pooled
  // default (~75 ms); a camera pause re-requests downsample=1 full quality
  if (full === true && mode === "volume") base += "downsample=1&";
  $("#img3d").src = `${base}azimuth=${state.azimuth}` +
    `&elevation=${state.elevation}&size=256&t=${state.bump++}`;
  $("#angles").textContent =
    `az ${state.azimuth.toFixed(0)}° el ${state.elevation.toFixed(0)}°`;
}

// --- CLUT editor (reference gui/widgets/clut_raycasting.py) -----------------

const clut = { nodes: null, drag: -1, hist: null };

async function loadClut(name) {
  clut.nodes = await api(`/api/raycast/nodes?name=${encodeURIComponent(name)}`);
  if (!clut.hist) {
    clut.hist = await api("/api/histogram?bins=96").catch(() => null);
  }
  $("#clut-lo").value = clut.nodes.lo;
  $("#clut-hi").value = clut.nodes.hi;
  $("#clut-name").value = name;
  drawClut();
}

function clutToPx(v, a, W, H) {
  const { lo, hi } = clut.nodes;
  return [(v - lo) / (hi - lo) * (W - 8) + 4, (H - 22) * (1 - a) + 4];
}

function clutFromPx(x, y, W, H) {
  const { lo, hi } = clut.nodes;
  return [
    Math.min(hi, Math.max(lo, (x - 4) / (W - 8) * (hi - lo) + lo)),
    Math.min(1, Math.max(0, 1 - (y - 4) / (H - 22))),
  ];
}

function drawClut() {
  const cv = $("#clut-canvas");
  if (!clut.nodes || !cv) return;
  const ctx = cv.getContext("2d");
  const W = cv.width, H = cv.height;
  const { lo, hi } = clut.nodes;
  ctx.fillStyle = "#111";
  ctx.fillRect(0, 0, W, H);
  // intensity histogram behind the curve (reference clut_raycasting.py
  // draws the 16-bit histogram under the editable nodes)
  if (clut.hist) {
    const { counts, edges } = clut.hist;
    const maxc = Math.max(...counts.map((c) => Math.log1p(c)));
    ctx.fillStyle = "#2a3342";
    counts.forEach((c, i) => {
      const t0 = (edges[i] - lo) / (hi - lo);
      const t1 = (edges[i + 1] - lo) / (hi - lo);
      if (t1 < 0 || t0 > 1) return;
      const x0 = 4 + Math.max(0, t0) * (W - 8);
      const x1 = 4 + Math.min(1, t1) * (W - 8);
      const h = Math.log1p(c) / maxc * (H - 26);
      ctx.fillRect(x0, H - 22 + 4 - h - 4, Math.max(1, x1 - x0), h);
    });
  }
  const grad = ctx.createLinearGradient(4, 0, W - 4, 0);
  clut.nodes.color_nodes.forEach(([v, rgb]) => {
    const t = Math.min(1, Math.max(0, (v - lo) / (hi - lo)));
    grad.addColorStop(t, `rgb(${rgb.map((c) => Math.round(c * 255))})`);
  });
  ctx.fillStyle = grad;
  ctx.fillRect(4, H - 14, W - 8, 10);
  ctx.strokeStyle = "#ddd";
  ctx.beginPath();
  clut.nodes.alpha_nodes.forEach(([v, a], i) => {
    const [x, y] = clutToPx(v, a, W, H);
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  });
  ctx.stroke();
  clut.nodes.alpha_nodes.forEach(([v, a], i) => {
    const [x, y] = clutToPx(v, a, W, H);
    ctx.fillStyle = i === clut.drag ? "#ff5" : "#6cf";
    ctx.beginPath();
    ctx.arc(x, y, 3.5, 0, 7);
    ctx.fill();
  });
}

function clutNearestNode(e) {
  const cv = $("#clut-canvas");
  const r = cv.getBoundingClientRect();
  const x = e.clientX - r.left, y = e.clientY - r.top;
  let best = -1, bd = 10;
  clut.nodes.alpha_nodes.forEach(([v, a], i) => {
    const [nx, ny] = clutToPx(v, a, cv.width, cv.height);
    const d = Math.hypot(nx - x, ny - y);
    if (d < bd) { bd = d; best = i; }
  });
  return [best, x, y];
}

async function applyClut(save) {
  const n = clut.nodes;
  n.lo = +$("#clut-lo").value;
  n.hi = +$("#clut-hi").value;
  n.name = $("#clut-name").value || n.name;
  const r = await api("/api/raycast/preset", { ...n, save });
  const rp = $("#raycast-preset");
  if (![...rp.options].some((o) => o.textContent === r.name)) {
    const o = document.createElement("option");
    o.textContent = r.name;
    rp.appendChild(o);
  }
  rp.value = r.name;
  state.raycastPreset = r.name;
  setStatus(save ? `preset saved: ${r.saved}` : `preset applied: ${r.name}`);
  volgl.lutName = null;  // the server-side preset changed: re-bake the GL LUT
  refresh3D();
}

function initClut() {
  const cv = $("#clut-canvas");
  cv.addEventListener("mousedown", (e) => {
    const [i] = clutNearestNode(e);
    clut.drag = i;
    drawClut();
  });
  cv.addEventListener("mousemove", (e) => {
    if (clut.drag < 0) return;
    const r = cv.getBoundingClientRect();
    clut.nodes.alpha_nodes[clut.drag] =
      clutFromPx(e.clientX - r.left, e.clientY - r.top, cv.width, cv.height);
    clut.nodes.alpha_nodes.sort((a, b) => a[0] - b[0]);
    drawClut();
  });
  window.addEventListener("mouseup", () => {
    if (clut.drag >= 0) { clut.drag = -1; drawClut(); }
  });
  cv.addEventListener("dblclick", (e) => {
    const r = cv.getBoundingClientRect();
    const [v, a] =
      clutFromPx(e.clientX - r.left, e.clientY - r.top, cv.width, cv.height);
    clut.nodes.alpha_nodes.push([v, a]);
    clut.nodes.alpha_nodes.sort((x, y) => x[0] - y[0]);
    drawClut();
  });
  cv.addEventListener("contextmenu", (e) => {
    e.preventDefault();
    const [i] = clutNearestNode(e);
    if (i >= 0 && clut.nodes.alpha_nodes.length > 2) {
      clut.nodes.alpha_nodes.splice(i, 1);
      drawClut();
    }
  });
  $("#clut-apply").onclick = () => applyClut(false);
  $("#clut-save").onclick = () => applyClut(true);
}

async function refreshLists() {
  const masks = await api("/api/masks");
  const ml = $("#mask-list");
  ml.innerHTML = "";
  masks.forEach((m) => {
    const li = document.createElement("li");
    li.innerHTML = `<span class="grow">#${m.index} ${m.name}</span>` +
      `<span>[${m.threshold_range}]</span>`;
    li.onclick = () => api("/api/mask/select", { index: m.index })
      .then(() => { refreshSlices(); refreshLists(); });
    // data-notebook row ops (reference data_notebook.py mask page)
    const dup = document.createElement("button");
    dup.textContent = "⧉";
    dup.title = "duplicate";
    dup.onclick = (e) => { e.stopPropagation();
      api("/api/mask/duplicate", { index: m.index }).then(refreshLists); };
    const del = document.createElement("button");
    del.textContent = "x";
    del.onclick = (e) => { e.stopPropagation();
      api("/api/mask/remove", { index: m.index })
        .then(() => { refreshSlices(); refreshLists(); }); };
    li.appendChild(dup);
    li.appendChild(del);
    ml.appendChild(li);
  });

  const meas = await api("/api/measures");
  const el = $("#measure-list");
  el.innerHTML = "";
  meas.forEach((m) => {
    const li = document.createElement("li");
    const val = typeof m.value === "number" ? m.value.toFixed(2) : m.value;
    li.innerHTML = `<span class="grow">${m.name} (${m.type})</span>` +
      `<span>${val}${m.unit || ""}</span>`;
    const mcol = document.createElement("input");
    mcol.type = "color";
    mcol.title = "measure colour";
    mcol.value = "#" + (m.colour || [1, 0, 0]).map(
      (c) => Math.round(c * 255).toString(16).padStart(2, "0")).join("");
    mcol.onchange = () => api("/api/measures/props", {
      index: m.index,
      colour: [1, 3, 5].map(
        (i) => parseInt(mcol.value.substr(i, 2), 16) / 255),
    }).then(() => refreshSlices());
    li.appendChild(mcol);
    const vis = document.createElement("button");
    vis.textContent = m.visible === false ? "–" : "👁";
    vis.title = "toggle overlay visibility";
    vis.onclick = () => api("/api/measures/props",
      { index: m.index, visible: m.visible === false })
      .then(() => { refreshLists(); refreshSlices(); });
    li.appendChild(vis);
    const del = document.createElement("button");
    del.textContent = "x";
    del.onclick = () => api("/api/measures/remove", { index: m.index })
      .then(() => { refreshLists(); refreshSlices(); });
    li.appendChild(del);
    el.appendChild(li);
  });
}

function rgbHex(c) {
  return "#" + c.map((v) => Math.round(v * 255).toString(16)
    .padStart(2, "0")).join("");
}

async function refreshSurfaces() {
  gl3dInvalidate();  // surface set/props changed: re-stream WebGL meshes
  const surfaces = await api("/api/surfaces");
  const ul = $("#surface-list");
  ul.innerHTML = "";
  surfaces.forEach((s) => {
    const li = document.createElement("li");
    const vol = s.volume_mm3 ? ` ${s.volume_mm3.toFixed(0)} mm³` : "";
    li.innerHTML =
      `<span class="grow">#${s.index} ${s.name} ` +
      `${(s.triangles || 0).toLocaleString()} tris${vol}</span>`;
    const col = document.createElement("input");
    col.type = "color";
    col.value = rgbHex(s.colour || [1, 0.78, 0.65]);
    col.title = "surface colour";
    col.onchange = () => api("/api/surface/props", { index: s.index,
      colour: [1, 3, 5].map((i) => parseInt(col.value.substr(i, 2), 16) / 255),
    }).then(refresh3D);
    li.appendChild(col);
    const vis = document.createElement("button");
    vis.textContent = s.visible ? "👁" : "–";
    vis.title = "toggle visibility";
    vis.onclick = () => api("/api/surface/props",
      { index: s.index, visible: !s.visible })
      .then(() => { refreshSurfaces(); refresh3D(); });
    li.appendChild(vis);
    const tr = document.createElement("input");
    tr.type = "range";
    tr.min = 0; tr.max = 0.9; tr.step = 0.1;
    tr.value = s.transparency || 0;
    tr.title = "transparency";
    tr.style.width = "3.5em";
    tr.onchange = () => api("/api/surface/props",
      { index: s.index, transparency: +tr.value }).then(refresh3D);
    li.appendChild(tr);
    [["split", "/api/surface/split", {}],
     ["smooth", "/api/surface/smooth", { iterations: 20 }],
     ["½", "/api/surface/decimate", { reduction: 0.5 }],
     ["cull", "/api/surface/remove_non_visible", {}]].forEach(
      ([label, path, extra]) => {
        const b = document.createElement("button");
        b.textContent = label;
        b.onclick = async () => {
          setStatus(`${label} surface #${s.index}…`);
          await api(path, Object.assign({ index: s.index }, extra));
          setStatus("");
          refreshSurfaces(); refresh3D();
        };
        li.appendChild(b);
      });
    const dl = document.createElement("a");
    dl.href = `/api/surface/${s.index}.stl`;
    dl.download = `surface_${s.index}.stl`;
    dl.textContent = "STL";
    li.appendChild(dl);
    const del = document.createElement("button");
    del.textContent = "x";
    del.onclick = () => api("/api/surface/remove", { index: s.index })
      .then(() => { refreshSurfaces(); refresh3D(); });
    li.appendChild(del);
    ul.appendChild(li);
  });
}

// --- tool interactions ------------------------------------------------------

function setTool(name) {
  state.tool = name;
  state.pending = [];
  $$("#tools button").forEach((b) =>
    b.classList.toggle("active", b.dataset.tool === name));
}

async function handleClick(orient, col, row) {
  const vox = toVoxel(orient, col, row);
  const world = voxelToWorld(vox);
  const slice_number = state.idx[orient];
  const t = state.tool;
  if (t === "cursor") {
    state.cross = vox;
    state.idx.AXIAL = vox[0];
    state.idx.CORONAL = vox[1];
    state.idx.SAGITAL = vox[2];
    refreshSlices();
  } else if (t === "floodfill") {
    // region-grow method config (reference styles.py:3015
    // FFillSegmentationConfig: threshold / dynamic range / confidence)
    const method = $("#ffill-method").value;
    const body = { seed: vox, method };
    if (method === "dynamic") {
      body.dev_min = body.dev_max = +$("#ffill-dev").value;
    } else if (method === "confidence") {
      body.mult = +$("#ffill-mult").value;
    } else {
      body.tmin = +$("#ffill-lo").value;
      body.tmax = +$("#ffill-hi").value;
    }
    const r = await api("/api/floodfill", body);
    setStatus(`floodfill (${method}): ${r.voxels.toLocaleString()} voxels`);
    refreshSlices(); refreshLists();
  } else if (t === "part-keep" || t === "part-del") {
    // connected mask part by seed (reference styles.py:2572/2708)
    const r = await api("/api/mask/part", {
      seed: vox, op: t === "part-del" ? "remove" : "select" });
    setStatus(`${t === "part-del" ? "removed" : "kept"} part: ` +
      `${r.voxels.toLocaleString()} voxels`);
    refreshSlices();
  } else if (t === "watershed") {
    state.wsMarkers.push({ position: vox, label: +$("#ws-label").value });
    $("#ws-count").textContent = `${state.wsMarkers.length} markers`;
  } else if (t === "linear" || t === "angular") {
    state.pending.push(world);
    const need = t === "linear" ? 2 : 3;
    setStatus(`${t}: point ${state.pending.length}/${need}`);
    if (state.pending.length === need) {
      const body = t === "linear"
        ? { kind: "linear", p1: state.pending[0], p2: state.pending[1],
            location: orient, slice_number }
        : { kind: "angular", p0: state.pending[0], p1: state.pending[1],
            p2: state.pending[2], location: orient, slice_number };
      const m = await api("/api/measures", body);
      setStatus(`${m.name}: ${(+m.value).toFixed(2)} ${m.unit}`);
      state.pending = [];
      refreshLists(); refreshSlices([orient]);
    }
  } else if (t === "annotation") {
    const text = prompt("annotation text:");
    if (text) {
      await api("/api/measures", {
        kind: "annotation", point: world,
        lead_point: [world[0] + 8, world[1] - 8, world[2]],
        text, location: orient, slice_number });
      refreshLists(); refreshSlices([orient]);
    }
  } else if (t === "density") {
    const rx = +(prompt("radius x (px):", "10") || 0);
    const ry = +(prompt("radius y (px):", "10") || 0);
    if (rx > 0 && ry > 0) {
      const m = await api("/api/measures", {
        kind: "density_ellipse", center: [row, col], rx, ry,
        location: orient, slice_number, points: [world] });
      setStatus(`density mean ${(+m.value).toFixed(1)} HU`);
      refreshLists(); refreshSlices([orient]);
    }
  }
}

function attachPane(pane) {
  const orient = pane.dataset.orient;
  const img = pane.querySelector("img");
  const wrap = pane.querySelector(".imgwrap");
  const slider = pane.querySelector(".slider");
  // brush cursor preview (the reference's cursor_actors circle)
  const cursor = document.createElement("div");
  cursor.id = "brush-cursor";
  wrap.appendChild(cursor);
  // cursor-actor preview ring (reference cursor_actors.py): brush-sized
  // for paint/erase, a fixed seed ring for the click tools
  const RING_TOOLS = { paint: "#ffd166", erase: "#ef476f",
                       floodfill: "#06d6a0", watershed: "#118ab2",
                       "part-keep": "#06d6a0", "part-del": "#ef476f" };
  const updateCursor = (ev) => {
    const colour = RING_TOOLS[state.tool];
    if (!colour) {
      cursor.style.display = "none";
      return;
    }
    const r = img.getBoundingClientRect();
    const w = wrap.getBoundingClientRect();
    const pxPerMm = (r.width / img.naturalWidth) / state.spacing[0];
    const brush = state.tool === "paint" || state.tool === "erase";
    const d = brush ? 2 * (+$("#brush-radius").value) * pxPerMm : 10;
    cursor.style.display = "block";
    cursor.style.width = cursor.style.height = `${d}px`;
    cursor.style.left = `${ev.clientX - w.left}px`;
    cursor.style.top = `${ev.clientY - w.top}px`;
    cursor.style.borderColor = colour;
  };
  wrap.addEventListener("mousemove", updateCursor);
  wrap.addEventListener("mouseleave", () => { cursor.style.display = "none"; });

  const imgPos = (ev) => {
    const r = img.getBoundingClientRect();
    const clamp = (v, hi) => Math.min(hi - 1, Math.max(0, v));
    const col = clamp(Math.round(
      (ev.clientX - r.left) / r.width * img.naturalWidth),
      img.naturalWidth || 1);
    const row = clamp(Math.round(
      (ev.clientY - r.top) / r.height * img.naturalHeight),
      img.naturalHeight || 1);
    return [col, row];
  };

  wrap.addEventListener("wheel", (ev) => {
    ev.preventDefault();
    const n = sliceCount(orient);
    state.idx[orient] = Math.min(n - 1,
      Math.max(0, state.idx[orient] + Math.sign(ev.deltaY)));
    refreshSlices([orient]);
  }, { passive: false });

  slider.addEventListener("input", () => {
    state.idx[orient] = +slider.value;
    refreshSlices([orient]);
  });

  let stroke = null;     // brush stroke voxels
  let cropDrag = null;   // crop-box rubber band (reference styles.py:2596)
  const band = document.createElement("div");
  band.className = "crop-band";
  band.style.cssText = "position:absolute;border:1px dashed #ffd166;" +
    "background:rgba(255,209,102,.12);pointer-events:none;display:none";
  wrap.appendChild(band);
  let wwwl = null;       // right-drag start

  wrap.addEventListener("mousedown", (ev) => {
    if (ev.button === 2) {
      wwwl = { x: ev.clientX, y: ev.clientY, ww: state.ww, wl: state.wl };
      return;
    }
    if (ev.button !== 0) return;
    if (state.tool === "paint" || state.tool === "erase") {
      const [c, r] = imgPos(ev);
      stroke = [toVoxel(orient, c, r)];
    } else if (state.tool === "crop") {
      const [c, r] = imgPos(ev);
      cropDrag = { c0: c, r0: r, x0: ev.clientX, y0: ev.clientY };
      band.style.display = "block";
    }
  });
  wrap.addEventListener("mousemove", (ev) => {
    if (wwwl) {
      state.ww = Math.max(1, wwwl.ww + (ev.clientX - wwwl.x) * 4);
      state.wl = wwwl.wl + (ev.clientY - wwwl.y) * 2;
      $("#ww").value = Math.round(state.ww);
      $("#wl").value = Math.round(state.wl);
      refreshSlices();
      return;
    }
    if (stroke) {
      const [c, r] = imgPos(ev);
      const v = toVoxel(orient, c, r);
      const last = stroke[stroke.length - 1];
      if (v.some((x, i) => x !== last[i])) stroke.push(v);
    }
    if (cropDrag) {
      const w = wrap.getBoundingClientRect();
      band.style.left = `${Math.min(cropDrag.x0, ev.clientX) - w.left}px`;
      band.style.top = `${Math.min(cropDrag.y0, ev.clientY) - w.top}px`;
      band.style.width = `${Math.abs(ev.clientX - cropDrag.x0)}px`;
      band.style.height = `${Math.abs(ev.clientY - cropDrag.y0)}px`;
    }
  });
  const finish = async (ev) => {
    if (wwwl) {
      wwwl = null;
      api("/api/window", { ww: state.ww, wl: state.wl });
      return;
    }
    if (cropDrag) {
      const d = cropDrag; cropDrag = null;
      band.style.display = "none";
      const [c1, r1] = imgPos(ev);
      const va = toVoxel(orient, d.c0, d.r0);
      const vb = toVoxel(orient, c1, r1);
      // dragged axes get the band extent; the slice axis keeps the
      // previous crop (or the full volume)
      const prev = state.cropLimits ||
        [0, state.shape[0] - 1, 0, state.shape[1] - 1, 0, state.shape[2] - 1];
      const sliceAxis = orient === "AXIAL" ? 0 : orient === "CORONAL" ? 1 : 2;
      const lim = [];
      for (let ax = 0; ax < 3; ax++) {
        if (ax === sliceAxis) lim.push(prev[2 * ax], prev[2 * ax + 1]);
        else lim.push(Math.min(va[ax], vb[ax]), Math.max(va[ax], vb[ax]));
      }
      const out = await api("/api/crop", { limits: lim, apply: false });
      state.cropLimits = out.limits;
      $("#crop-info").textContent = `[${out.limits.join(",")}]`;
      setStatus(T("crop box set — press apply to crop the volume"));
      refreshSlices();
      return;
    }
    if (stroke) {
      const s = stroke; stroke = null;
      // three-way editor op (reference styles.py EditorConfig): erase tool
      // always erases; paint tool follows the op selector (plain draw or
      // one of the threshold-gated variants over the edit range)
      const op = state.tool === "erase" ? "erase"
        : ({ draw: "paint", threshold: "threshold",
             threshold_add: "threshold_add",
             threshold_erase_only: "threshold_erase_only",
           })[$("#brush-op").value] || "paint";
      const body = { strokes: s, radius_mm: +$("#brush-radius").value, op };
      if (op.startsWith("threshold")) {
        // only threshold ops carry the range — a plain draw/erase stroke
        // must not overwrite the mask's stored edition_threshold_range
        body.threshold_range = [+$("#edit-lo").value, +$("#edit-hi").value];
      }
      const r = await api("/api/brush", body);
      setStatus(`brush: ${s.length} stamps, mask ${r.voxels.toLocaleString()} voxels`);
      refreshSlices();
      return;
    }
    if (ev.button === 0) {
      const [c, r] = imgPos(ev);
      handleClick(orient, c, r);
    }
  };
  wrap.addEventListener("mouseup", finish);
  wrap.addEventListener("contextmenu", (ev) => ev.preventDefault());
}

// --- WebGL surface pane -----------------------------------------------------
// Client-side GPU rendering of the surface actors (reference
// viewer_volume.py:129 live VTK scene): meshes stream once from
// /api/surface/{i}/mesh.bin as f16 verts + u32 faces, then orbiting costs
// zero HTTP requests.  Server-PNG mode stays for volume/MEP/e-field.

const gl3d = { gl: null, prog: null, meshes: [], loaded: false,
               center: [0, 0, 0], dist: 100, loading: null };

function f16ToF32(u16) {
  const out = new Float32Array(u16.length);
  for (let i = 0; i < u16.length; i++) {
    const h = u16[i];
    const s = (h & 0x8000) ? -1 : 1, e = (h >> 10) & 0x1f, m = h & 0x3ff;
    out[i] = e === 0 ? s * m * 5.960464477539063e-8   // subnormal
      : e === 31 ? s * (m ? NaN : Infinity)
      : s * Math.pow(2, e - 15) * (1 + m / 1024);
  }
  return out;
}

function gl3dParse(buf) {
  const dv = new DataView(buf);
  if (dv.getUint32(0) !== 0x49564d31) throw new Error("bad mesh magic");
  const jlen = dv.getUint32(4, true);
  const meta = JSON.parse(new TextDecoder().decode(
    new Uint8Array(buf, 8, jlen)));
  const voff = 8 + jlen;
  const verts = f16ToF32(new Uint16Array(buf, voff, meta.n_verts * 3));
  const foff = voff + meta.n_verts * 3 * 2;
  const faces = new Uint32Array(buf, foff + (-foff % 4 + 4) % 4,
                                meta.n_tris * 3);
  return { meta, verts, faces };
}

function gl3dInit() {
  const cv = $("#gl3d");
  const gl = cv.getContext("webgl2", { antialias: true });
  if (!gl) return null;
  const vs = `#version 300 es
  in vec3 pos; uniform mat4 mvp; uniform mat4 mv; uniform float psize;
  out vec3 vpos;
  void main(){ vpos=(mv*vec4(pos,1.)).xyz; gl_Position=mvp*vec4(pos,1.);
               gl_PointSize = psize; }`;
  const fs = `#version 300 es
  precision highp float; in vec3 vpos; out vec4 frag;
  uniform vec3 colour; uniform float transparency; uniform float psize;
  void main(){
    if (psize > 0.0) { frag = vec4(colour, 1.0); return; }  // marker sprite
    // screen-door transparency: same 4x4 ordered-dither the server's
    // splat renderer uses, so both 3D modes agree visually
    const mat4 bayer = mat4( 0., 8., 2.,10., 12., 4.,14., 6.,
                             3.,11., 1., 9., 15., 7.,13., 5.) / 16.;
    ivec2 p = ivec2(mod(gl_FragCoord.xy, 4.));
    if (transparency > bayer[p.x][p.y]) discard;
    vec3 n = normalize(cross(dFdx(vpos), dFdy(vpos)));
    float diff = abs(n.z);                       // headlight
    frag = vec4(colour * (0.25 + 0.75 * diff), 1.0);
  }`;
  const mk = (type, src) => {
    const s = gl.createShader(type);
    gl.shaderSource(s, src); gl.compileShader(s);
    if (!gl.getShaderParameter(s, gl.COMPILE_STATUS)) {
      throw new Error(gl.getShaderInfoLog(s));
    }
    return s;
  };
  const prog = gl.createProgram();
  gl.attachShader(prog, mk(gl.VERTEX_SHADER, vs));
  gl.attachShader(prog, mk(gl.FRAGMENT_SHADER, fs));
  gl.linkProgram(prog);
  gl.enable(gl.DEPTH_TEST);
  gl3d.gl = gl; gl3d.prog = prog;
  return gl;
}

async function gl3dLoad() {
  if (gl3d.loading) return gl3d.loading;
  gl3d.loading = (async () => {
    const gl = gl3d.gl || gl3dInit();
    if (!gl) { setStatus("WebGL2 unavailable; use server mode"); return; }
    for (const m of gl3d.meshes) {
      gl.deleteBuffer(m.vb); gl.deleteBuffer(m.ib);
      gl.deleteVertexArray(m.vao);
    }
    gl3d.meshes = [];
    const lo = [1e9, 1e9, 1e9], hi = [-1e9, -1e9, -1e9];
    const surfs = await api("/api/surfaces");
    for (const s of surfs.filter((s) => s.visible)) {
      const buf = await (await fetch(`/api/surface/${s.index}/mesh.bin`))
        .arrayBuffer();
      const { meta, verts, faces } = gl3dParse(buf);
      const vao = gl.createVertexArray();
      gl.bindVertexArray(vao);
      const vb = gl.createBuffer();
      gl.bindBuffer(gl.ARRAY_BUFFER, vb);
      gl.bufferData(gl.ARRAY_BUFFER, verts, gl.STATIC_DRAW);
      gl.enableVertexAttribArray(0);
      gl.vertexAttribPointer(0, 3, gl.FLOAT, false, 0, 0);
      const ib = gl.createBuffer();
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ib);
      gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, faces, gl.STATIC_DRAW);
      for (let i = 0; i < verts.length; i += 3) {
        for (let k = 0; k < 3; k++) {
          if (verts[i + k] < lo[k]) lo[k] = verts[i + k];
          if (verts[i + k] > hi[k]) hi[k] = verts[i + k];
        }
      }
      gl3d.meshes.push({ vao, vb, ib, n: meta.n_tris * 3,
                         colour: meta.colour,
                         transparency: meta.transparency });
    }
    if (gl3d.meshes.length) {
      gl3d.center = [0, 1, 2].map((k) => (lo[k] + hi[k]) / 2);
      gl3d.dist = 2.2 * Math.max(hi[0] - lo[0], hi[1] - lo[1],
                                 hi[2] - lo[2], 10);
    }
    // navigation markers as GL point sprites (reference marker glyphs in
    // the live scene, viewer_volume.py)
    try {
      const markers = await api("/api/nav/markers");
      if (gl3d.markerVb) gl.deleteBuffer(gl3d.markerVb);
      gl3d.markerN = markers.length;
      if (markers.length) {
        const pts = new Float32Array(markers.length * 3);
        markers.forEach((m, i) => pts.set(m.position, i * 3));
        gl3d.markerVb = gl.createBuffer();
        gl.bindBuffer(gl.ARRAY_BUFFER, gl3d.markerVb);
        gl.bufferData(gl.ARRAY_BUFFER, pts, gl.STATIC_DRAW);
      }
    } catch (e) { gl3d.markerN = 0; }
    gl3d.loaded = true;
  })().finally(() => { gl3d.loading = null; });
  return gl3d.loading;
}

function gl3dInvalidate() {
  gl3d.loaded = false;
  if ($("#mode3d").value === "surfaces-gl") refresh3D();
}

// minimal column-major mat4 helpers
function mat4Mul(a, b) {
  const o = new Float32Array(16);
  for (let c = 0; c < 4; c++) {
    for (let r = 0; r < 4; r++) {
      let s = 0;
      for (let k = 0; k < 4; k++) s += a[k * 4 + r] * b[c * 4 + k];
      o[c * 4 + r] = s;
    }
  }
  return o;
}

function mat4LookAt(eye, at, up) {
  const sub = (a, b) => a.map((v, i) => v - b[i]);
  const norm = (a) => { const l = Math.hypot(...a); return a.map((v) => v / l); };
  const cross = (a, b) => [a[1] * b[2] - a[2] * b[1],
                           a[2] * b[0] - a[0] * b[2],
                           a[0] * b[1] - a[1] * b[0]];
  const dot = (a, b) => a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
  const z = norm(sub(eye, at)), x = norm(cross(up, z)), y = cross(z, x);
  return new Float32Array([x[0], y[0], z[0], 0, x[1], y[1], z[1], 0,
                           x[2], y[2], z[2], 0,
                           -dot(x, eye), -dot(y, eye), -dot(z, eye), 1]);
}

function mat4Persp(fovy, aspect, near, far) {
  const f = 1 / Math.tan(fovy / 2), nf = 1 / (near - far);
  return new Float32Array([f / aspect, 0, 0, 0, 0, f, 0, 0,
                           0, 0, (far + near) * nf, -1,
                           0, 0, 2 * far * near * nf, 0]);
}

function gl3dRender() {
  const gl = gl3d.gl;
  if (!gl || !gl3d.loaded) return;
  const cv = $("#gl3d");
  const wrap = $("#pane3d .imgwrap");
  const w = wrap.clientWidth || 300, h = wrap.clientHeight || 300;
  if (cv.width !== w || cv.height !== h) { cv.width = w; cv.height = h; }
  gl.viewport(0, 0, w, h);
  gl.enable(gl.DEPTH_TEST);  // volGLRender's fullscreen pass disables it
  gl.clearColor(0.04, 0.05, 0.07, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const az = state.azimuth * Math.PI / 180;
  const el = state.elevation * Math.PI / 180;
  const c = gl3d.center, d = gl3d.dist;
  const eye = [c[0] + d * Math.cos(el) * Math.sin(az),
               c[1] - d * Math.cos(el) * Math.cos(az),
               c[2] + d * Math.sin(el)];
  const mv = mat4LookAt(eye, c, [0, 0, 1]);  // CT world: z superior
  const mvp = mat4Mul(mat4Persp(0.6, w / h, d * 0.01, d * 10), mv);
  gl.useProgram(gl3d.prog);
  gl.uniformMatrix4fv(gl.getUniformLocation(gl3d.prog, "mv"), false, mv);
  gl.uniformMatrix4fv(gl.getUniformLocation(gl3d.prog, "mvp"), false, mvp);
  gl.uniform1f(gl.getUniformLocation(gl3d.prog, "psize"), 0);
  for (const m of gl3d.meshes) {
    gl.uniform3fv(gl.getUniformLocation(gl3d.prog, "colour"), m.colour);
    gl.uniform1f(gl.getUniformLocation(gl3d.prog, "transparency"),
                 m.transparency || 0);
    gl.bindVertexArray(m.vao);
    gl.drawElements(gl.TRIANGLES, m.n, gl.UNSIGNED_INT, 0);
  }
  if (gl3d.markerN) {
    gl.bindVertexArray(null);
    gl.bindBuffer(gl.ARRAY_BUFFER, gl3d.markerVb);
    gl.enableVertexAttribArray(0);
    gl.vertexAttribPointer(0, 3, gl.FLOAT, false, 0, 0);
    gl.uniform1f(gl.getUniformLocation(gl3d.prog, "psize"), 7);
    gl.uniform3fv(gl.getUniformLocation(gl3d.prog, "colour"),
                  [1.0, 0.3, 0.2]);
    gl.uniform1f(gl.getUniformLocation(gl3d.prog, "transparency"), 0);
    gl.drawArrays(gl.POINTS, 0, gl3d.markerN);
  }
}

// --- client-side GPU volume raycast (reference live vtkVolume raycast
// mapper, viewer_volume.py:129,636-646).  The server streams ONE
// downsampled u8 brick (/api/volume/brick) plus the preset's baked RGBA
// LUT (/api/raycast/lut); the browser then orbits at display rate with
// front-to-back compositing + gradient shading in a WebGL2 fragment
// shader — zero HTTP per frame.  /api/render stays the full-fidelity
// server path (progressive pooled->full refinement).
const volgl = { prog: null, tex: null, lut: null, lutName: null,
                loaded: false, loading: null,
                dims: [1, 1, 1], ext: [1, 1, 1], vlo: 0, vhi: 1,
                plo: 0, phi: 1, stepRef: 1, shading: false };

function volGLInit(gl) {
  const vs = `#version 300 es
  out vec2 uv;
  void main(){
    vec2 p = vec2(float((gl_VertexID << 1) & 2), float(gl_VertexID & 2));
    uv = p * 2.0 - 1.0;
    gl_Position = vec4(p * 2.0 - 1.0, 0.0, 1.0);
  }`;
  const fs = `#version 300 es
  precision highp float;
  precision highp sampler3D;
  in vec2 uv; out vec4 frag;
  uniform sampler3D vol; uniform sampler2D lut;
  uniform vec3 eye; uniform vec3 fwd; uniform vec3 rightv;
  uniform vec3 upv; uniform vec3 boxMax; uniform vec3 texel;
  uniform float vlo; uniform float vhi; uniform float plo;
  uniform float phi; uniform float stepRef; uniform int shade;
  void main(){
    vec3 dir = normalize(fwd + uv.x * rightv + uv.y * upv);
    vec3 inv = 1.0 / dir;
    vec3 ta = (vec3(0.0) - eye) * inv, tb = (boxMax - eye) * inv;
    vec3 t0 = min(ta, tb), t1 = max(ta, tb);
    float tn = max(max(t0.x, t0.y), max(t0.z, 0.0));
    float tf = min(min(t1.x, t1.y), t1.z);
    vec3 bg = vec3(0.04, 0.05, 0.07);
    if (tf <= tn) { frag = vec4(bg, 1.0); return; }
    const int N = 256;
    float dt = (tf - tn) / float(N);
    vec3 acc = vec3(0.0); float aAcc = 0.0;
    vec3 w2t = 1.0 / boxMax;                     // world mm -> tex coords
    for (int i = 0; i < N; i++) {
      vec3 p = (eye + (tn + (float(i) + 0.5) * dt) * dir) * w2t;
      float raw = vlo + texture(vol, p).r * (vhi - vlo);
      float t = clamp((raw - plo) / (phi - plo), 0.0, 1.0);
      vec4 c = texture(lut, vec2(t, 0.5));
      // step-length opacity correction: the LUT's alpha is per stepRef mm
      float a = 1.0 - pow(1.0 - min(c.a, 0.999), dt / stepRef);
      if (a < 0.0015) continue;
      if (shade > 0) {
        vec3 g = vec3(
          texture(vol, p + vec3(texel.x, 0.0, 0.0)).r
            - texture(vol, p - vec3(texel.x, 0.0, 0.0)).r,
          texture(vol, p + vec3(0.0, texel.y, 0.0)).r
            - texture(vol, p - vec3(0.0, texel.y, 0.0)).r,
          texture(vol, p + vec3(0.0, 0.0, texel.z)).r
            - texture(vol, p - vec3(0.0, 0.0, texel.z)).r);
        float g2 = dot(g, g);
        if (g2 > 1e-8) {                          // headlight diffuse
          float diff = abs(dot(g / sqrt(g2), dir));
          c.rgb *= 0.35 + 0.65 * diff;
        }
      }
      acc += (1.0 - aAcc) * a * c.rgb;
      aAcc += (1.0 - aAcc) * a;
      if (aAcc > 0.985) break;                    // early ray termination
    }
    frag = vec4(acc + (1.0 - aAcc) * bg, 1.0);
  }`;
  const mk = (type, src) => {
    const s = gl.createShader(type);
    gl.shaderSource(s, src); gl.compileShader(s);
    if (!gl.getShaderParameter(s, gl.COMPILE_STATUS)) {
      throw new Error(gl.getShaderInfoLog(s));
    }
    return s;
  };
  const prog = gl.createProgram();
  gl.attachShader(prog, mk(gl.VERTEX_SHADER, vs));
  gl.attachShader(prog, mk(gl.FRAGMENT_SHADER, fs));
  gl.linkProgram(prog);
  volgl.prog = prog;
}

async function volGLLut(gl) {
  const name = state.raycastPreset;
  const r = await api(`/api/raycast/lut?name=${encodeURIComponent(name)}&n=256`);
  volgl.plo = r.lo; volgl.phi = Math.max(r.hi, r.lo + 1e-3);
  volgl.shading = r.shading;
  const px = new Uint8Array(r.rgba);
  if (!volgl.lut) volgl.lut = gl.createTexture();
  gl.bindTexture(gl.TEXTURE_2D, volgl.lut);
  gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA, px.length / 4, 1, 0,
                gl.RGBA, gl.UNSIGNED_BYTE, px);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_S, gl.CLAMP_TO_EDGE);
  volgl.lutName = name;
}

async function volGLEnsure() {
  const gl = gl3d.gl || gl3dInit();
  if (!gl) { setStatus("WebGL2 unavailable; use server mode"); return; }
  if (!volgl.prog) volGLInit(gl);
  if (!volgl.loaded) {
    if (!volgl.loading) {
      volgl.loading = (async () => {
        const buf = await (await fetch("/api/volume/brick?max_dim=256"))
          .arrayBuffer();
        const dv = new DataView(buf);
        if (dv.getUint32(0) !== 0x49564231) throw new Error("bad brick magic");
        const jlen = dv.getUint32(4, true);
        const meta = JSON.parse(new TextDecoder().decode(
          new Uint8Array(buf, 8, jlen)));
        const [Z, Y, X] = meta.dims;           // server layout (volume.py:32)
        const data = new Uint8Array(buf, 8 + jlen, Z * Y * X);
        volgl.dims = [X, Y, Z];                // texture axes s,t,r
        volgl.ext = [X * meta.spacing[0], Y * meta.spacing[1],
                     Z * meta.spacing[2]];
        volgl.stepRef = Math.max(Math.min(...meta.spacing), 1e-3);
        volgl.vlo = meta.lo; volgl.vhi = Math.max(meta.hi, meta.lo + 1e-3);
        if (volgl.tex) gl.deleteTexture(volgl.tex);
        volgl.tex = gl.createTexture();
        gl.bindTexture(gl.TEXTURE_3D, volgl.tex);
        gl.pixelStorei(gl.UNPACK_ALIGNMENT, 1);
        gl.texImage3D(gl.TEXTURE_3D, 0, gl.R8, X, Y, Z, 0,
                      gl.RED, gl.UNSIGNED_BYTE, data);
        gl.texParameteri(gl.TEXTURE_3D, gl.TEXTURE_MIN_FILTER, gl.LINEAR);
        gl.texParameteri(gl.TEXTURE_3D, gl.TEXTURE_MAG_FILTER, gl.LINEAR);
        gl.texParameteri(gl.TEXTURE_3D, gl.TEXTURE_WRAP_S, gl.CLAMP_TO_EDGE);
        gl.texParameteri(gl.TEXTURE_3D, gl.TEXTURE_WRAP_T, gl.CLAMP_TO_EDGE);
        gl.texParameteri(gl.TEXTURE_3D, gl.TEXTURE_WRAP_R, gl.CLAMP_TO_EDGE);
        volgl.loaded = true;
      })().finally(() => { volgl.loading = null; });
    }
    await volgl.loading;
  }
  if (volgl.lutName !== state.raycastPreset) await volGLLut(gl);
}

function volGLInvalidate() {   // the image volume changed: re-stream the brick
  volgl.loaded = false;
  if ($("#mode3d").value === "volume-gl") refresh3D();
}

function volGLRender() {
  const gl = gl3d.gl;
  if (!gl || !volgl.loaded || !volgl.prog) return;
  const cv = $("#gl3d");
  const wrap = $("#pane3d .imgwrap");
  const w = wrap.clientWidth || 300, h = wrap.clientHeight || 300;
  if (cv.width !== w || cv.height !== h) { cv.width = w; cv.height = h; }
  gl.viewport(0, 0, w, h);
  gl.disable(gl.DEPTH_TEST);
  gl.useProgram(volgl.prog);
  gl.bindVertexArray(null);
  const c = volgl.ext.map((v) => v / 2);
  const d = 1.8 * Math.max(volgl.ext[0], volgl.ext[1], volgl.ext[2], 10);
  const az = state.azimuth * Math.PI / 180;
  const el = state.elevation * Math.PI / 180;
  const eye = [c[0] + d * Math.cos(el) * Math.sin(az),
               c[1] - d * Math.cos(el) * Math.cos(az),
               c[2] + d * Math.sin(el)];           // CT world: z superior
  const norm = (a) => { const l = Math.hypot(...a); return a.map((v) => v / l); };
  const cross = (a, b) => [a[1] * b[2] - a[2] * b[1],
                           a[2] * b[0] - a[0] * b[2],
                           a[0] * b[1] - a[1] * b[0]];
  const fwd = norm(c.map((v, i) => v - eye[i]));
  const ru = norm(cross(fwd, [0, 0, 1]));
  const uu = cross(ru, fwd);
  const ht = Math.tan(0.3);                        // fovy 0.6 rad (mat4Persp)
  const u = (n) => gl.getUniformLocation(volgl.prog, n);
  gl.uniform3fv(u("eye"), eye);
  gl.uniform3fv(u("fwd"), fwd);
  gl.uniform3fv(u("rightv"), ru.map((v) => v * ht * (w / h)));
  gl.uniform3fv(u("upv"), uu.map((v) => v * ht));
  gl.uniform3fv(u("boxMax"), volgl.ext);
  gl.uniform3fv(u("texel"), volgl.dims.map((v) => 1 / v));
  gl.uniform1f(u("vlo"), volgl.vlo);
  gl.uniform1f(u("vhi"), volgl.vhi);
  gl.uniform1f(u("plo"), volgl.plo);
  gl.uniform1f(u("phi"), volgl.phi);
  gl.uniform1f(u("stepRef"), volgl.stepRef);
  gl.uniform1i(u("shade"), volgl.shading ? 1 : 0);
  gl.activeTexture(gl.TEXTURE0);
  gl.bindTexture(gl.TEXTURE_3D, volgl.tex);
  gl.uniform1i(u("vol"), 0);
  gl.activeTexture(gl.TEXTURE1);
  gl.bindTexture(gl.TEXTURE_2D, volgl.lut);
  gl.uniform1i(u("lut"), 1);
  gl.drawArrays(gl.TRIANGLES, 0, 3);
  gl.activeTexture(gl.TEXTURE0);
}

// --- geodesic surface measure (reference measures.py:1068, the VTK
// Dijkstra geodesic path tool): two picks in the WebGL pane cast camera
// rays that the server intersects with the stored surface mesh ----------------

async function geodesicPick(ev) {
  if ($("#mode3d").value !== "surfaces-gl" || !gl3d.loaded) {
    setStatus(T("switch the 3D pane to surfaces GL to pick"));
    return;
  }
  const cv = $("#gl3d");
  const r = cv.getBoundingClientRect();
  const w = cv.width || 1, h = cv.height || 1;
  const px = (ev.clientX - r.left) / r.width * w;
  const py = (ev.clientY - r.top) / r.height * h;
  // rebuild gl3dRender's camera and cast a ray through the clicked pixel
  const az = state.azimuth * Math.PI / 180;
  const el = state.elevation * Math.PI / 180;
  const c = gl3d.center, d = gl3d.dist;
  const eye = [c[0] + d * Math.cos(el) * Math.sin(az),
               c[1] - d * Math.cos(el) * Math.cos(az),
               c[2] + d * Math.sin(el)];
  const norm = (a) => { const l = Math.hypot(...a); return a.map((v) => v / l); };
  const cross = (a, b) => [a[1] * b[2] - a[2] * b[1],
                           a[2] * b[0] - a[0] * b[2],
                           a[0] * b[1] - a[1] * b[0]];
  const zAx = norm(eye.map((v, i) => v - c[i]));
  const xAx = norm(cross([0, 0, 1], zAx));
  const yAx = cross(zAx, xAx);
  const t = Math.tan(0.3);  // fovy 0.6 rad / 2, matching mat4Persp
  const ndx = (2 * px / w - 1) * t * (w / h);
  const ndy = (1 - 2 * py / h) * t;
  const dir = norm([0, 1, 2].map((k) => ndx * xAx[k] + ndy * yAx[k] - zAx[k]));
  const hit = await api("/api/surface/pick", { origin: eye, dir });
  if (!hit.hit) { setStatus(T("no surface under the cursor")); return; }
  state.geoPicks.push(hit);
  if (state.geoPicks.length < 2) {
    setStatus(`geodesic 1/2: surface ${hit.surface} vertex ${hit.vertex}`);
    return;
  }
  const [a, b] = state.geoPicks;
  state.geoPicks = [];
  if (a.surface !== b.surface) {
    setStatus(T("pick both points on the same surface"));
    return;
  }
  const m = await api("/api/measures", {
    kind: "geodesic", surface: a.surface, v0: a.vertex, v1: b.vertex });
  setStatus(`${m.name}: ${(+m.value).toFixed(2)} ${m.unit}`);
  refreshLists();
}

// --- 3D pane orbit ----------------------------------------------------------

function attach3D() {
  const wrap = $("#pane3d .imgwrap");
  let drag = null;
  let timer = null;
  let refineTimer = null;
  // 3D polygon-cut overlay (reference mask3d_editor_state.py:18): clicks
  // in cut3d mode collect polygon points in render-pixel coords
  const poly = document.createElement("canvas");
  poly.className = "cut3d-overlay";
  poly.style.cssText = "position:absolute;left:0;top:0;pointer-events:none";
  wrap.appendChild(poly);
  state.cut3dPts = [];
  const drawPoly = () => {
    const img = $("#img3d");
    const r = img.getBoundingClientRect();
    const w = wrap.getBoundingClientRect();
    poly.width = wrap.clientWidth; poly.height = wrap.clientHeight;
    const ctx = poly.getContext("2d");
    ctx.clearRect(0, 0, poly.width, poly.height);
    if (!state.cut3dPts.length) return;
    const sx = r.width / (img.naturalWidth || 256);
    const sy = r.height / (img.naturalHeight || 256);
    ctx.strokeStyle = "#ffd166"; ctx.fillStyle = "#ffd166";
    ctx.beginPath();
    state.cut3dPts.forEach(([c, row], i) => {
      const x = r.left - w.left + c * sx, y = r.top - w.top + row * sy;
      if (i === 0) ctx.moveTo(x, y); else ctx.lineTo(x, y);
      ctx.fillRect(x - 2, y - 2, 4, 4);
    });
    ctx.closePath(); ctx.stroke();
    $("#cut3d-count").textContent = `${state.cut3dPts.length} pts`;
  };
  state.cut3dRedraw = drawPoly;
  wrap.addEventListener("mousedown", (ev) => {
    drag = { x: ev.clientX, y: ev.clientY,
             az: state.azimuth, el: state.elevation };
  });
  wrap.addEventListener("mouseup", (ev) => {
    if (!drag) return;
    if (Math.abs(ev.clientX - drag.x) + Math.abs(ev.clientY - drag.y) > 3) {
      return;  // it was an orbit drag, not a click
    }
    if (state.tool === "geodesic") { geodesicPick(ev); return; }
    if (state.tool !== "cut3d") return;
    const img = $("#img3d");
    const r = img.getBoundingClientRect();
    const c = Math.round((ev.clientX - r.left) / r.width *
                         (img.naturalWidth || 256));
    const row = Math.round((ev.clientY - r.top) / r.height *
                           (img.naturalHeight || 256));
    state.cut3dPts.push([c, row]);
    drawPoly();
  });
  wrap.addEventListener("mousemove", (ev) => {
    if (!drag) return;
    if (Math.abs(ev.clientX - drag.x) + Math.abs(ev.clientY - drag.y) > 3) {
      drag.moved = true;  // distinguishes orbit drags from tool clicks
    }
    if (!drag.moved) return;  // don't re-render for sub-click jitter
    state.azimuth = drag.az + (ev.clientX - drag.x) * 0.7;
    state.elevation = Math.max(-89, Math.min(89,
      drag.el + (ev.clientY - drag.y) * 0.7));
    $("#angles").textContent =
      `az ${state.azimuth.toFixed(0)}° el ${state.elevation.toFixed(0)}°`;
    const m3 = $("#mode3d").value;
    if (m3 === "surfaces-gl") {
      gl3dRender();  // local GPU: display-rate orbit, zero HTTP
      return;
    }
    if (m3 === "volume-gl") {
      volGLRender();  // local GPU raycast: display-rate orbit, zero HTTP
      return;
    }
    // progressive refinement (reference viewer_volume.py:636-646 live
    // raycast): DURING the drag, throttled pooled frames (the server's
    // downsample=2 fast path, octant-cached); the full-quality frame is
    // requested the moment the drag ENDS (see mouseup below), so it lands
    // ~one render (<400 ms) after the camera stops instead of after a
    // long idle debounce.
    clearTimeout(timer);
    clearTimeout(refineTimer);
    const now = performance.now();
    if (!attach3D._last || now - attach3D._last > 110) {
      attach3D._last = now;
      refresh3D();                        // pooled frame, live orbit
    } else {
      timer = setTimeout(refresh3D, 110); // trailing pooled frame
    }
    refineTimer = setTimeout(() => refresh3D(true), 500);  // safety net
  });
  window.addEventListener("mouseup", () => {
    // only orbit DRAGS earn the full-quality re-render — tool clicks
    // (cut3d vertices, part picks) never moved the camera
    if (drag && drag.moved && !$("#mode3d").value.endsWith("-gl")) {
      clearTimeout(timer);
      clearTimeout(refineTimer);
      refresh3D(true);  // full quality immediately on drag end
    }
    drag = null;
  });
}

// --- wiring -----------------------------------------------------------------

// --- DL segmentation panel (reference deep_learning_seg_dialog.py) ----------

function initDLSegmentation() {
  let poll = null;
  const stopPoll = () => { if (poll) { clearInterval(poll); poll = null; } };
  $("#dl-start").onclick = async () => {
    const structures = $("#dl-structures").value
      .split(",").map((s) => s.trim()).filter(Boolean);
    try {
      await api("/api/segment/dl", {
        model: $("#dl-model").value, threshold: +$("#dl-thr").value,
        allow_random_init: $("#dl-random").checked, structures,
      });
    } catch (e) {
      setStatus("DL start failed — no trained weights installed? " +
        "(tick 'demo' to run with random weights)");
      return;
    }
    setStatus(`DL ${$("#dl-model").value} segmentation running…` +
      ($("#dl-random").checked ? " [RANDOM weights — demo only]" : ""));
    stopPoll();
    poll = setInterval(async () => {
      let st;
      try {
        st = await api("/api/segment/dl/status", {});
      } catch (e) {
        stopPoll();
        setStatus("DL status poll failed — job lost?");
        return;
      }
      $("#dl-progress").value = Math.round(100 * (st.progress || 0));
      if (st.done) {
        stopPoll();
        setStatus(st.error ? `DL failed: ${st.error}`
          : `DL mask #${st.mask_index} created`);
        refreshSlices(); refreshLists();
      }
    }, 700);
  };
  $("#dl-cancel").onclick = async () => {
    await api("/api/segment/dl/cancel", {});
    stopPoll();
    setStatus("DL segmentation cancelled");
  };
  // slider-speed rethreshold of the cached probability volume — no
  // re-inference (reference segment.py apply_segment_threshold :350)
  $("#dl-thr").onchange = async () => {
    // per-model probability cache: rethreshold the SELECTED model's last
    // job, so switching models and moving the slider needs no inference
    const r = await api("/api/segment/dl/threshold",
      { threshold: +$("#dl-thr").value,
        model: $("#dl-model").value }).catch(() => null);
    if (r) {
      setStatus(`rethreshold @ ${r.threshold}: ` +
        `${r.voxels.toLocaleString()} voxels`);
      refreshSlices();
    }
  };
}

// --- log panel (reference enhanced_logging.py LogViewerFrame) ----------------

async function refreshLog() {
  const lvl = $("#log-level").value;
  const q = $("#log-search").value;
  const entries = await api(`/api/log?level=${lvl}&limit=200` +
    (q ? `&q=${encodeURIComponent(q)}` : ""));
  $("#log-lines").textContent = entries.map((e) =>
    `${new Date(e.ts * 1000).toLocaleTimeString()} ` +
    `${e.level} ${e.component}: ${e.message}`).join("\n");
}

function initLog() {
  $("#log-refresh").onclick = () => refreshLog().catch(() => {});
  $("#log-search").onchange = () => refreshLog().catch(() => {});
  $("#log-level").onchange = () => refreshLog().catch(() => {});
  refreshLog().catch(() => {});
}

// --- navigation panel (reference task_navigator.py workflow) ----------------

function initNavigation() {
  let scenePoll = null;
  const refreshNav = async () => {
    const st = await api("/api/nav/status");
    $("#nav-info").textContent =
      (st.tracker_connected ? "tracker ✓ " : "tracker ✗ ") +
      (st.image_fiducials_set ? "img-fid ✓ " : "") +
      (st.tracker_fiducials_set ? "trk-fid ✓ " : "") +
      (st.fre != null ? `FRE ${st.fre.toFixed(2)}mm ` : "") +
      (st.navigating ? "NAVIGATING" : "");
    const sel = $("#nav-tracker");
    if (!sel.options.length && st.trackers) {
      st.trackers.forEach((t) => {
        const o = document.createElement("option");
        o.textContent = t;
        if (t === "debug_random") o.selected = true;
        sel.appendChild(o);
      });
    }
    const markers = await api("/api/nav/markers");
    const ul = $("#nav-marker-list");
    ul.innerHTML = "";
    markers.forEach((m) => {
      const li = document.createElement("li");
      li.textContent = `#${m.id} ${m.label || m.type} ` +
        `(${m.position.slice(0, 3).map((v) => v.toFixed(1))})`;
      const del = document.createElement("button");
      del.textContent = "x";
      del.onclick = () => api("/api/nav/markers/remove", { id: m.id })
        .then(refreshNav);
      li.appendChild(del);
      ul.appendChild(li);
    });
    return st;
  };
  $("#nav-connect").onclick = () =>
    api("/api/nav/connect", { tracker_id: $("#nav-tracker").value })
      .then(refreshNav);
  $("#nav-disconnect").onclick = () =>
    api("/api/nav/disconnect", {}).then(refreshNav);
  $("#nav-fid-image").onclick = () => {
    if (!state.cross) { setStatus("click a slice to set the crosshair first"); return; }
    api("/api/nav/fiducial/image", {
      index: +$("#nav-fid").value, position: voxelToWorld(state.cross),
    }).then(refreshNav);
  };
  $("#nav-fid-tracker").onclick = () =>
    api("/api/nav/fiducial/tracker", { index: +$("#nav-fid").value })
      .then(refreshNav);
  $("#nav-register").onclick = async () => {
    const r = await api("/api/nav/register", {});
    setStatus(`registered: FRE ${r.fre.toFixed(2)} mm`);
    refreshNav();
  };
  $("#nav-icp").onclick = async () => {
    setStatus("ICP refining (sampling probe)…");
    const r = await api("/api/nav/icp", { n_samples: 20 })
      .catch(() => null);
    setStatus(r ? `ICP refined: ${r.icp_error_mm.toFixed(2)} mm`
      : "ICP needs registration + a surface");
  };
  $("#nav-start").onclick = async () => {
    await api("/api/nav/start", {});
    refreshNav();
    if (!scenePoll) {   // live 3D scene while navigating
      scenePoll = setInterval(() => {
        if ($("#mode3d").value === "surfaces") refresh3D();
        refreshNav().catch(() => {});
      }, 1500);
    }
  };
  $("#nav-stop").onclick = async () => {
    await api("/api/nav/stop", {});
    if (scenePoll) { clearInterval(scenePoll); scenePoll = null; }
    refreshNav();
  };
  $("#nav-marker-add").onclick = () => {
    if (!state.cross) { setStatus("click a slice to set the crosshair first"); return; }
    api("/api/nav/markers", {
      position: voxelToWorld(state.cross), label: "web",
    }).then(refreshNav);
  };
  // live tractography / e-field workers (reference task_tractography.py,
  // task_efield.py) — demo field / first-surface ROI; applied at next start
  $("#nav-tracts").onchange = (e) =>
    api("/api/nav/tracts", { enable: e.target.checked })
      .then((r) => setStatus(r.tracts_enabled
        ? `tracts on (${r.n_tracts} seeds)` : "tracts off"));
  $("#nav-efield").onchange = (e) =>
    api("/api/nav/efield", { enable: e.target.checked })
      .then((r) => setStatus(r.efield_enabled
        ? `e-field on (${r.roi_vertices} ROI verts)` : "e-field off"))
      .catch(() => { e.target.checked = false;
        setStatus("e-field needs a surface — create one first"); });
  // robot panel (reference task_navigator.py robot rows)
  $("#robot-connect").onclick = async () => {
    const ip = $("#robot-ip").value;
    if (!ip) { setStatus("enter the robot IP"); return; }
    const r = await api("/api/nav/robot/connect", { ip });
    setStatus(`robot ${r.robot_id} connected to ${ip}`);
  };
  $("#robot-track").onclick = async () => {
    const markers = await api("/api/nav/markers");
    if (!markers.length) { setStatus("add a marker first"); return; }
    await api("/api/nav/robot/objective", { objective: "TRACK_TARGET" });
    const r = await api("/api/nav/robot/target",
      { marker_id: markers[markers.length - 1].id });
    setStatus(`robot tracking marker #${markers[markers.length - 1].id}`);
  };
  $("#robot-free").onchange = (e) =>
    api("/api/nav/robot/free_drive", { enabled: e.target.checked })
      .then(() => setStatus(`free drive ${e.target.checked ? "on" : "off"}`));
  $("#nav-record").onchange = (e) =>
    api("/api/nav/record", e.target.checked
      ? { enable: true, path: `/tmp/coords_${Date.now()}.csv` }
      : { enable: false })
      .then((r) => setStatus(r.recording
        ? `recording to ${r.path}` : `recording stopped (${r.path})`));
  refreshNav().catch(() => {});
}

// --- PACS panel (reference gui/import_network_panel.py) ----------------------

function initPacs() {
  const conn = () => ({
    host: $("#pacs-host").value, port: +$("#pacs-port").value,
    aetitle_call: $("#pacs-aet").value,
  });
  $("#pacs-echo").onclick = async () => {
    const r = await api("/api/pacs/echo", conn());
    setStatus(r.ok ? "PACS echo ok" : "PACS echo FAILED");
  };
  $("#pacs-find").onclick = async () => {
    const results = await api("/api/pacs/find",
      { ...conn(), patient_name: $("#pacs-patient").value });
    const ul = $("#pacs-list");
    ul.innerHTML = "";
    results.forEach((st) => {
      const li = document.createElement("li");
      li.textContent = `${st.PatientName || "?"} ${st.StudyDescription || ""} `;
      const b = document.createElement("button");
      b.textContent = "retrieve";
      b.onclick = async () => {
        const dest = $("#pacs-dest").value;
        if (!dest) { setStatus("enter a retrieve dir"); return; }
        setStatus("retrieving study…");
        const r = await api("/api/pacs/move",
          { ...conn(), study_uid: st.StudyInstanceUID, dest });
        setStatus(`retrieved ${r.files.length} instances`);
        if (r.shape) location.reload();
      };
      li.appendChild(b);
      ul.appendChild(li);
    });
    setStatus(`${results.length} studies`);
  };
}

// --- preferences panel (reference gui/preferences.py + language_dialog.py) --

async function initPreferences() {
  const i18n = await api("/api/i18n");
  const sel = $("#pref-language");
  i18n.locales.forEach((loc) => {
    const o = document.createElement("option");
    o.textContent = loc;
    if (loc === i18n.current) o.selected = true;
    sel.appendChild(o);
  });
  sel.onchange = () => api("/api/i18n", { language: sel.value })
    .then(() => setStatus(`language: ${sel.value}`));

  const cfg = await api("/api/config");
  const box = $("#pref-config");
  Object.entries(cfg.config).forEach(([key, value]) => {
    if (typeof value === "object" && value !== null) return;
    const row = document.createElement("label");
    row.style.display = "block";
    row.textContent = key + " ";
    let input;
    if (typeof value === "boolean") {
      input = document.createElement("input");
      input.type = "checkbox";
      input.checked = value;
      input.onchange = () => api("/api/config", { [key]: input.checked });
    } else {
      input = document.createElement("input");
      input.value = value;
      input.style.width = "8em";
      input.onchange = () => api("/api/config", {
        [key]: typeof value === "number" ? +input.value : input.value });
    }
    row.appendChild(input);
    box.appendChild(row);
  });
}

// --- global keyboard shortcuts (reference frame.py:204 OnGlobalKey) ---------

function initKeys() {
  document.addEventListener("keydown", (ev) => {
    const el = document.activeElement;
    if (el && (el.tagName === "INPUT" || el.tagName === "TEXTAREA" ||
               el.tagName === "SELECT")) {
      return;  // typing in a field — same guard the reference applies
    }
    if ((ev.ctrlKey || ev.metaKey) && ev.key.toLowerCase() === "s") {
      ev.preventDefault();
      $("#project-save").click();
      return;
    }
    if (ev.ctrlKey || ev.metaKey || ev.altKey) {
      return;  // browser chords (Ctrl+R reload, Ctrl+U source, ...) pass through
    }
    const tools = $$("#tools button").map((b) => b.dataset.tool);
    const n = parseInt(ev.key, 10);
    if (n >= 1 && n <= tools.length) {  // 1..9 select tools in order
      setTool(tools[n - 1]);
      return;
    }
    switch (ev.key) {
      case "u": $("#undo").click(); break;
      case "r": $("#redo").click(); break;
      case "Escape":
        state.pending = [];
        if (state.cut3dRedraw) { state.cut3dPts = []; state.cut3dRedraw(); }
        setStatus("");
        break;
      case "ArrowUp":
      case "ArrowDown": {
        ev.preventDefault();
        const o = "AXIAL";  // scroll the axial pane like the wheel does
        const d = ev.key === "ArrowUp" ? -1 : 1;
        state.idx[o] = Math.min(sliceCount(o) - 1,
                                Math.max(0, state.idx[o] + d));
        refreshSlices([o]);
        break;
      }
    }
  });
}

async function init() {
  await initI18n();
  initKeys();
  const st = await api("/api/status");
  state.shape = st.volume_shape || [1, 1, 1];
  state.spacing = st.spacing || [1, 1, 1];
  [state.ww, state.wl] = st.window;
  $("#ww").value = state.ww; $("#wl").value = state.wl;
  $("#volinfo").textContent =
    `${state.shape.join("×")} @ ${state.spacing.map((s) => s.toFixed(2))}mm`;
  ["AXIAL", "CORONAL", "SAGITAL"].forEach((o) => {
    state.idx[o] = Math.floor(sliceCount(o) / 2);
    const pane = document.querySelector(`.pane[data-orient="${o}"]`);
    pane.querySelector(".slider").max = sliceCount(o) - 1;
  });

  const presets = await api("/api/presets");
  const tp = $("#thresh-preset");
  Object.entries(presets.threshold_ct).forEach(([name, range]) => {
    const o = document.createElement("option");
    o.value = JSON.stringify(range);
    o.textContent = `${name} [${range}]`;
    tp.appendChild(o);
  });
  tp.onchange = () => {
    let range;
    try { range = JSON.parse(tp.value); } catch (e) { return; }
    $("#tmin").value = range[0]; $("#tmax").value = range[1];
  };
  const pj = $("#projection");
  presets.projections.forEach((name, i) => {
    const o = document.createElement("option");
    o.value = i; o.textContent = name;
    pj.appendChild(o);
  });
  pj.onchange = () => { state.projection = +pj.value; refreshSlices(); };
  $("#slabs").onchange = () => { state.slabs = +$("#slabs").value; refreshSlices(); };
  const rp = $("#raycast-preset");
  presets.raycast.forEach((name) => {
    const o = document.createElement("option");
    o.textContent = name;
    rp.appendChild(o);
  });
  state.raycastPreset = presets.raycast[0] || "";
  rp.onchange = () => {
    state.raycastPreset = rp.value;
    refresh3D();
    loadClut(rp.value).catch(() => {});
  };
  $("#mode3d").onchange = refresh3D;
  initClut();
  if (state.raycastPreset) loadClut(state.raycastPreset).catch(() => {});

  const iv = await api("/api/image_versions");
  const ivs = $("#imgversion");
  (iv.versions.length ? iv.versions : ["original"]).forEach((label) => {
    const o = document.createElement("option");
    o.textContent = label;
    if (label === iv.current) o.selected = true;
    ivs.appendChild(o);
  });
  ivs.onchange = () => api("/api/image_versions/select", { label: ivs.value })
    .then(() => { volGLInvalidate(); refreshSlices(); });

  $("#ww").onchange = () => { state.ww = +$("#ww").value; api("/api/window", { ww: state.ww, wl: state.wl }); refreshSlices(); };
  $("#wl").onchange = () => { state.wl = +$("#wl").value; api("/api/window", { ww: state.ww, wl: state.wl }); refreshSlices(); };

  $$("#tools button").forEach((b) =>
    b.addEventListener("click", () => setTool(b.dataset.tool)));

  $("#do-threshold").onclick = async () => {
    const r = await api("/api/threshold",
      { tmin: +$("#tmin").value, tmax: +$("#tmax").value });
    setStatus(`mask #${r.index}: ${r.voxels.toLocaleString()} voxels`);
    refreshSlices(); refreshLists();
  };
  $("#undo").onclick = () => api("/api/mask/undo", {}).then(() => refreshSlices());
  $("#fill-holes").onclick = () =>
    api("/api/mask/fill_holes", { max_size: +$("#fill-max").value })
      .then((r) => { setStatus(`filled ${r.filled_voxels} voxels`);
        refreshSlices(); });
  $("#redo").onclick = () => api("/api/mask/redo", {}).then(() => refreshSlices());
  $("#do-bool").onclick = async () => {
    const r = await api("/api/boolean", { op: +$("#bool-op").value,
      index1: +$("#bool-a").value, index2: +$("#bool-b").value });
    setStatus(`boolean -> mask #${r.index} (${r.voxels.toLocaleString()} voxels)`);
    refreshSlices(); refreshLists();
  };
  $("#ws-run").onclick = async () => {
    if (!state.wsMarkers.length) { setStatus(T("place watershed markers first")); return; }
    setStatus("watershed running…");
    const r = await api("/api/watershed", { markers: state.wsMarkers });
    setStatus(`watershed: ${r.voxels.toLocaleString()} voxels kept`);
    refreshSlices(); refreshLists();
  };
  $("#ws-clear").onclick = () => {
    state.wsMarkers = []; $("#ws-count").textContent = "";
  };
  // SurfaceCreationDialog option set (reference gui/dialogs.py): quality
  // preset, decimation, keep-largest, fill-holes, overwrite, name, and
  // the ca_smoothing parameter block shown only for that algorithm
  $("#surf-algo").onchange = () => {
    $("#surf-ca-opts").style.display =
      $("#surf-algo").value === "ca_smoothing" ? "" : "none";
  };
  $("#do-surface").onclick = async () => {
    setStatus("creating surface…");
    const body = {
      algorithm: $("#surf-algo").value,
      quality: $("#surf-quality").value,
      keep_largest: $("#surf-largest").checked,
      fill_holes: $("#surf-fill").checked,
      overwrite: $("#surf-overwrite").checked,
      name: $("#surf-name").value,
    };
    const dec = +$("#surf-decimate").value;
    if (dec > 0) body.decimate_reduction = dec;
    if (body.algorithm === "ca_smoothing") {
      body.ca_options = {
        t: +$("#surf-ca-t").value, tmax: +$("#surf-ca-tmax").value,
        bmin: +$("#surf-ca-bmin").value, n_iters: +$("#surf-ca-iters").value,
      };
    }
    const r = await api("/api/surface", body);
    setStatus(`surface #${r.index}: ${r.triangles.toLocaleString()} triangles`);
    refreshSurfaces();
  };
  $("#do-surf-import").onclick = async () => {
    const r = await api("/api/surface/import",
      { path: $("#surf-import-path").value });
    setStatus(`imported #${r.index} (${r.filled_holes} holes filled)`);
    refreshSurfaces();
  };

  $("#do-scan").onclick = async () => {
    const path = $("#import-path").value;
    if (!path) return;
    if (!path.match(/\.(nii|gz|par|rec|hdr|img)$/i)) {
      try {
        const series = await api(`/api/dicom/scan?dir=${encodeURIComponent(path)}`);
        const ul = $("#series-list");
        ul.innerHTML = "";
        series.forEach((sr) => {
          const li = document.createElement("li");
          const th = document.createElement("img");
          th.src = `/api/dicom/thumb?dir=${encodeURIComponent(path)}` +
            `&series=${encodeURIComponent(sr.series_uid)}&size=32`;
          th.style.width = "32px";
          li.appendChild(th);
          li.innerHTML += `<span class="grow">${sr.series_description ||
            sr.series_uid} (${sr.n_slices})</span>`;
          li.onclick = async () => {
            setStatus("importing…");
            await api("/api/import", { path, series: sr.series_uid });
            location.reload();
          };
          ul.appendChild(li);
        });
        setStatus(`${series.length} series`);
        return;
      } catch (e) { /* fall through to file import */ }
    }
    setStatus("importing…");
    await api("/api/import", { path });
    location.reload();
  };
  $("#project-save").onclick = async () => {
    const path = $("#project-path").value;
    if (!path) { setStatus("enter a .inv3 path"); return; }
    const r = await api("/api/project/save", { path });
    setStatus(`saved ${r.path} (${r.masks} masks, ${r.surfaces} surfaces, ` +
      `${r.measures} measures)`);
  };
  // project properties (reference gui/project_properties.py)
  $("#project-name").onchange = () =>
    api("/api/project/props", { name: $("#project-name").value })
      .then((r) => setStatus(`project: ${r.name} [${r.modality}]`));
  $("#project-modality").onchange = () =>
    api("/api/project/props", { modality: $("#project-modality").value })
      .then((r) => setStatus(`project: ${r.name} [${r.modality}]`));
  $("#project-open").onclick = async () => {
    const path = $("#project-path").value;
    if (!path) { setStatus("enter a .inv3 path"); return; }
    await api("/api/project/open", { path });
    location.reload();
  };
  $("#do-overlay").onclick = async () => {
    await api("/api/overlay", { path: $("#overlay-path").value,
                                colormap: $("#overlay-cmap").value });
    refreshSlices();
  };
  $("#clear-overlay").onclick = () =>
    api("/api/overlay/clear", {}).then(() => refreshSlices());

  initDLSegmentation();
  initLog();
  initNavigation();
  initPacs();
  initPreferences().catch(() => {});
  // crash recovery prompt (reference splash CheckCrashRecovery)
  api("/api/session").then((sess) => {
    if (sess.backup_path) {
      setStatus(`previous session crashed — backup at ${sess.backup_path}`);
      const btn = document.createElement("button");
      btn.textContent = "recover crash backup";
      btn.onclick = () => api("/api/session/recover", {})
        .then(() => location.reload());
      $("#project-path").parentElement.appendChild(btn);
    }
  }).catch(() => {});

  $$(".pane[data-orient]").forEach(attachPane);
  attach3D();
  $("#ov-mep").onchange = refresh3D;
  $("#ov-slice").onchange = refresh3D;
  $("#ov-ssao").onchange = refresh3D;
  // Image-menu flips (reference frame.py Image menu)
  [["#img-flip-z", 0], ["#img-flip-y", 1], ["#img-flip-x", 2]].forEach(
    ([id, axis]) => {
      $(id).onclick = () => api("/api/image/flip", { axis })
        .then(() => { refreshSlices(); refresh3D(); });
    });
  // crop box (reference styles.py:2596 CropMask): drag sets the box, apply
  // crops the volume to it
  $("#crop-apply").onclick = async () => {
    if (!state.cropLimits) { setStatus(T("drag a crop box first")); return; }
    await api("/api/crop", { limits: state.cropLimits, apply: true });
    setStatus(T("volume cropped"));
    state.cropLimits = null;
    $("#crop-info").textContent = "";
    volgl.loaded = false;
    refreshSlices(); refresh3D(); refreshLists();
  };
  $("#crop-clear").onclick = async () => {
    const [Z, Y, X] = state.shape;
    await api("/api/crop",
              { limits: [0, Z - 1, 0, Y - 1, 0, X - 1], apply: false });
    state.cropLimits = null;
    $("#crop-info").textContent = "";
    refreshSlices();
  };
  // reorient about the volume center (reference styles.py:2165 dialog —
  // degrees in the UI, radians on the wire like the reference's dialog)
  $("#reorient-apply").onclick = async () => {
    const d = Math.PI / 180;
    await api("/api/image/reorient", {
      angles: [+$("#reorient-x").value * d, +$("#reorient-y").value * d,
               +$("#reorient-z").value * d] });
    setStatus(T("volume reoriented"));
    volgl.loaded = false;
    refreshSlices(); refresh3D();
  };
  // 3D polygon cut through the scene camera
  $("#cut3d-apply").onclick = async () => {
    if (state.cut3dPts.length < 3) {
      setStatus(T("click at least 3 points on the 3D scene first"));
      return;
    }
    const r = await api("/api/mask/cut3d", {
      polygon: state.cut3dPts, azimuth: state.azimuth,
      elevation: state.elevation, size: 256,
      edit_mode: +$("#cut3d-side").value });
    setStatus(`3D cut: ${r.cut_voxels.toLocaleString()} voxels removed`);
    state.cut3dPts = [];
    state.cut3dRedraw();
    refreshSlices(); refresh3D();
  };
  $("#cut3d-clear").onclick = () => {
    state.cut3dPts = [];
    state.cut3dRedraw();
    $("#cut3d-count").textContent = "";
  };
  $("#ov-efield").onchange = refresh3D;
  refreshSlices();
  refresh3D();
  refreshLists();
  refreshSurfaces();
}

init().catch((e) => setStatus("init failed: " + e));

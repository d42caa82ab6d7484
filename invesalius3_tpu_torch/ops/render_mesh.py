"""Surface rendering for the 3D scene pane: an orthographic z-buffered
triangle splatter, visibility culling, and the navigation scene's glyphs
(port of invesalius3_tpu/ops/render_mesh.py).

The reference shows extracted surfaces as VTK actors in the 3D viewer
(reference invesalius/data/viewer_volume.py:129 surface/marker/coil
actors; actor_factory.py builds glyph meshes).  Here every triangle is
sampled on a barycentric lattice (enough samples to cover its pixel
footprint; bigger triangles are subdivided on the host first) and the
samples are z-tested with one packed scatter-min per lattice sample on the
device — depth in the high bits, shaded colour in the low bits, so the
winning sample per pixel carries its colour with it.  Sample positions are
rounded from sums evaluated in XLA's order (``ops/xla_float``), as the JAX
package computes them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.ops.xla_float import fma, recip

# barycentric sample lattice: 25 interior samples (rows of a triangular
# grid) — covers ~5x5-pixel triangles without holes; larger triangles
# should be decimated anyway for preview use
_BARY = np.array([
    (a / 5.0 + 1 / 15.0, b / 5.0 + 1 / 15.0)
    for a in range(5) for b in range(5 - a)
] + [(1 / 3.0, 1 / 3.0), (0.8, 0.1), (0.1, 0.8), (0.1, 0.1),
     (0.45, 0.45), (0.45, 0.1), (0.1, 0.45), (0.6, 0.2), (0.2, 0.6),
     (0.2, 0.2)], np.float32)


def view_matrix(azimuth: float, elevation: float) -> np.ndarray:
    """Camera basis (3, 3): rows = (right, up, forward) in world space."""
    az = np.radians(azimuth)
    el = np.radians(elevation)
    f = np.array([np.cos(el) * np.sin(az), -np.cos(el) * np.cos(az),
                  -np.sin(el)])  # forward (into the screen)
    r = np.array([np.cos(az), np.sin(az), 0.0])
    u = np.cross(r, f) * -1.0
    return np.stack([r, u, f]).astype(np.float32)


_BAYER4 = np.array([  # ordered-dither thresholds in [0, 1)
    [0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9], [15, 7, 13, 5]],
    np.float32).reshape(-1) / 16.0


def _subdivide(screen, fc, extra=()):
    """Adaptive screen-space subdivision: the sample lattice covers
    triangles up to 6 px without holes, so split bigger ones into four (at
    most six rounds, and not past 2M faces).  ``extra`` are per-vertex
    arrays (world coordinates) split alongside.  Returns (screen, faces,
    extra, parent): parent maps each face to its original face."""
    parent = np.arange(len(fc))
    extra = list(extra)
    for _ in range(6):
        if len(fc) > 2_000_000:  # checked first: a large mesh skips the edge pass
            break
        e = np.stack([
            np.linalg.norm(screen[fc[:, 0], :2] - screen[fc[:, 1], :2], axis=1),
            np.linalg.norm(screen[fc[:, 1], :2] - screen[fc[:, 2], :2], axis=1),
            np.linalg.norm(screen[fc[:, 2], :2] - screen[fc[:, 0], :2], axis=1),
        ]).max(axis=0)
        big = e > 6.0
        if not big.any():
            break
        keep, sub = fc[~big], fc[big]
        nb = len(sub)
        m01 = len(screen) + np.arange(nb)
        m12 = m01 + nb
        m20 = m12 + nb

        def mids(a):
            return np.concatenate([
                a, (a[sub[:, 0]] + a[sub[:, 1]]) / 2,
                (a[sub[:, 1]] + a[sub[:, 2]]) / 2, (a[sub[:, 2]] + a[sub[:, 0]]) / 2])

        screen = mids(screen)
        extra = [mids(a) for a in extra]
        quads = np.concatenate([
            np.stack([sub[:, 0], m01, m20], 1),
            np.stack([m01, sub[:, 1], m12], 1),
            np.stack([m20, m12, sub[:, 2]], 1),
            np.stack([m01, m12, m20], 1)])
        parent = np.concatenate([parent[~big]] + [parent[big]] * 4)
        fc = np.concatenate([keep, quads])
    return screen, fc, extra, parent


def _faces_on(fc: np.ndarray, dev) -> torch.Tensor:
    """(3, T) int64 face corners on ``dev`` (sent as (T, 3), no host copy)."""
    return torch.from_numpy(np.ascontiguousarray(fc)).to(dev).long().t()


def _corners(points: np.ndarray, f3: torch.Tensor):
    """(3, T) corners p0, p1, p2 of the faces ``f3`` (on its device)."""
    v3 = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(f3.device).t()
    return v3[:, f3[0]], v3[:, f3[1]], v3[:, f3[2]]


def _sample(p0, p1, p2, s: int, size: int):
    """Sample ``s`` of every triangle: its pixel (xi, yi), depth z and
    whether it lands on the screen; the barycentric sums in XLA's order."""
    a, b = float(_BARY[s, 0]), float(_BARY[s, 1])
    c = 1.0 - a - b
    x = fma(c, p2[0], fma(a, p0[0], p1[0] * float(np.float32(b))))
    y = fma(c, p2[1], fma(a, p0[1], p1[1] * float(np.float32(b))))
    z = fma(c, p2[2], fma(a, p0[2], p1[2] * float(np.float32(b))))
    xi = torch.round(x).long()
    yi = torch.round(y).long()
    ok = (xi >= 0) & (xi < size) & (yi >= 0) & (yi < size)
    return xi, yi, z, ok


def _zmax(p0, p1, p2) -> torch.Tensor:
    zmax = torch.stack([p0[2], p1[2], p2[2]]).max() if p0.shape[1] else \
        torch.zeros((), dtype=torch.float32, device=p0.device)
    return torch.clamp_min(zmax, 1.0)


_SENTINEL = 0x7FFFFFFF


def _splat(p0, p1, p2, shade, colour_rgb, size: int, ssao: bool = False) -> torch.Tensor:
    """Rasterize triangles given screen-space corners (3, T) each, a per-
    triangle shade (T,) and colour (3, T) — or (4, T) with a per-triangle
    alpha 4th row for screen-door transparency (a translucent surface
    keeps only the pixels whose 4x4 Bayer threshold falls below its alpha,
    so geometry behind shows through without sorted blending) — in [0,1].
    Returns (H, W, 3) uint8 over black, on the corners' device.

    The z-buffer is int32: 12-bit depth above 18-bit rgb666, so one
    scatter-min per sample (``scatter_reduce_`` "amin", independent of
    order) keeps the nearest sample with its colour."""
    dev = p0.device
    alpha = colour_rgb[3] if colour_rgb.shape[0] == 4 else None
    out = torch.full((size * size,), _SENTINEL, dtype=torch.int32, device=dev)
    r6 = (colour_rgb[0] * shade * 63.0).clamp(0, 63).to(torch.int32)
    g6 = (colour_rgb[1] * shade * 63.0).clamp(0, 63).to(torch.int32)
    b6 = (colour_rgb[2] * shade * 63.0).clamp(0, 63).to(torch.int32)
    rgb = (r6 << 12) | (g6 << 6) | b6  # (T,)
    zmax = _zmax(p0, p1, p2)
    bayer = torch.from_numpy(_BAYER4).to(dev)
    sentinel = torch.tensor(_SENTINEL, dtype=torch.int32, device=dev)
    for s in range(_BARY.shape[0]):
        xi, yi, z, ok = _sample(p0, p1, p2, s, size)
        if alpha is not None:
            # per-pixel dither decision; % is a floor modulo, as in JAX
            ok = ok & (alpha > bayer[(yi % 4) * 4 + (xi % 4)])
        zq = (z / zmax * 4095.0).clamp(0, 4095).to(torch.int32)
        packed = torch.where(ok, (zq << 18) | rgb, sentinel)
        lin = torch.where(ok, yi * size + xi, torch.zeros_like(xi))
        out.scatter_reduce_(0, lin, packed, reduce="amin")
    hit = out < _SENTINEL
    rgbw = torch.where(hit, out & 0x3FFFF, torch.zeros_like(out))
    img = torch.stack([(rgbw >> 12) & 0x3F, (rgbw >> 6) & 0x3F, rgbw & 0x3F],
                      dim=-1).float() * 4.0
    img = img.reshape(size, size, 3)
    if ssao:
        # screen-space ambient occlusion over the packed depth buffer
        # (reference viewer_volume.py vtkSSAOPass toggle, :374-377): a
        # pixel whose ring neighbors sit NEARER the eye is in a crevice;
        # per-sample occlusion = clamped positive depth excess, averaged
        # over 8 directions x 2 radii, then a multiplicative darkening.
        depth = torch.where(hit, (out >> 18).float(),
                            torch.full_like(out, 4096, dtype=torch.float32))
        depth = depth.reshape(size, size)
        ar = torch.arange(size, device=dev)

        def shift_clamp(a, dy, dx):
            # edge-clamped neighbour: a roll would wrap, letting geometry
            # at one image border cast phantom AO on the other
            return a[(ar - dy).clamp(0, size - 1)][:, (ar - dx).clamp(0, size - 1)]

        occ = torch.zeros((size, size), dtype=torch.float32, device=dev)
        n_s = 0
        for rad in (2, 5):
            for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1),
                           (1, 1), (1, -1), (-1, 1), (-1, -1)):
                nb = shift_clamp(depth, dy * rad, dx * rad)
                occ = occ + (depth - nb).clamp(0.0, 80.0)
                n_s += 1
        ao = 1.0 - (occ * recip(n_s * 80.0) * 2.5).clamp(0.0, 0.6)
        ao = torch.where(hit.reshape(size, size), ao, torch.ones_like(ao))
        img = img * ao[..., None]
    return img.clamp(0, 255).to(torch.uint8)


def _zbuf_face_visibility(p0, p1, p2, size: int) -> torch.Tensor:
    """(T,) bool: the face wins (or depth-ties) at least one pixel of the
    z-buffer for this view — the offscreen-render visibility test behind
    the reference's RemoveNonVisibleFaces (polydata_utils.py:363), without
    a render window."""
    dev = p0.device
    inf = torch.tensor(4095, dtype=torch.int32, device=dev)
    zmax = _zmax(p0, p1, p2)

    def sample(s):
        xi, yi, z, ok = _sample(p0, p1, p2, s, size)
        zq = (z / zmax * 4094.0).clamp(0, 4094).to(torch.int32)
        lin = torch.where(ok, yi * size + xi, torch.zeros_like(xi))
        return lin, zq, ok

    zbuf = torch.full((size * size,), 4095, dtype=torch.int32, device=dev)
    for s in range(_BARY.shape[0]):
        lin, zq, ok = sample(s)
        zbuf.scatter_reduce_(0, lin, torch.where(ok, zq, inf), reduce="amin")
    vis = torch.zeros(p0.shape[1], dtype=torch.bool, device=dev)
    for s in range(_BARY.shape[0]):
        lin, zq, ok = sample(s)
        vis |= ok & (zq <= zbuf[lin] + 1)
    return vis


# six axis-aligned viewpoints (reference polydata_utils.py:365 positions)
_AXIS_VIEWS = ((90.0, 0.0), (-90.0, 0.0), (0.0, 0.0), (180.0, 0.0),
               (0.0, 89.0), (0.0, -89.0))


def _screen(verts: np.ndarray, vm: np.ndarray, size: int) -> np.ndarray:
    """(V, 3) float32 screen coordinates (x right, y down, depth) of the
    vertices under the view basis ``vm``, framed to ``size``."""
    center = (verts.min(0) + verts.max(0)) / 2.0
    proj = (verts - center) @ vm.T
    extent = float(np.abs(proj[:, :2]).max()) * 2.1 + 1e-3
    scale = size / extent
    return np.stack([
        proj[:, 0] * scale + size / 2.0,
        size / 2.0 - proj[:, 1] * scale,
        (proj[:, 2] - proj[:, 2].min()) * scale + 1.0,
    ], axis=1).astype(np.float32)


def remove_non_visible_faces(verts: np.ndarray, faces: np.ndarray,
                             views=_AXIS_VIEWS, size: int = 512,
                             remove_visible: bool = False,
                             device=DEFAULT_DEVICE):
    """Drop faces never visible from the given viewpoints (reference
    polydata_utils.py:363 RemoveNonVisibleFaces, used by task_navigator's
    scalp-surface simplification; remove_visible inverts the keep set).
    The z-buffers run on ``device``.  Returns (verts, faces, kept_ratio)."""
    dev = resolve_device(device)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    vis = torch.zeros(len(faces), dtype=torch.bool, device=dev)
    f3 = _faces_on(faces, dev)
    for az, el in views:
        screen = _screen(verts, view_matrix(az, el), size)
        # a hole-free z-buffer needs the renderer's adaptive subdivision
        # (low-poly shells would otherwise leak interior faces through
        # the sample lattice); parent ids map sub-face hits back
        screen, fc, _, parent = _subdivide(screen, faces)
        if fc is faces:
            vis |= _zbuf_face_visibility(*_corners(screen, f3), size)
        else:
            vis_sub = _zbuf_face_visibility(*_corners(screen, _faces_on(fc, dev)), size)
            vis[torch.from_numpy(parent).to(dev)[vis_sub]] = True
    keep = vis if not remove_visible else ~vis
    # sorted unique corners and their inverse, as np.unique gives them
    used, inverse = torch.unique(f3.t()[keep], return_inverse=True)
    return (verts[used.cpu().numpy()],
            inverse.reshape(-1, 3).to(torch.int32).cpu().numpy(),
            int(keep.sum()) / len(faces) if len(faces) else 1.0)


def render_surfaces(meshes: Sequence[Tuple[np.ndarray, np.ndarray,
                                           Tuple[float, float, float]]],
                    azimuth: float = 30.0, elevation: float = 20.0,
                    size: int = 256,
                    max_triangles: int = 200_000,
                    light=(0.4, -0.6, -0.7),
                    background: Tuple[int, int, int] = (17, 19, 24),
                    ssao: bool = False,
                    device=DEFAULT_DEVICE,
                    ) -> np.ndarray:
    """Render a list of (verts (V, 3) world mm, faces (F, 3), colour rgb
    0..1[, alpha]) orthographically from (azimuth, elevation), splatted on
    ``device``.  Surfaces above ``max_triangles`` are decimated for the
    preview (the port's QEM decimator; the reference viewer similarly
    relies on VTK LOD actors for interactivity)."""
    from invesalius3_tpu_torch.core.surface import decimate

    dev = resolve_device(device)
    if not meshes:
        return np.full((size, size, 3), background, np.uint8)
    all_v, all_f, cols, alphas = [], [], [], []
    base = 0
    for mesh in meshes:
        # (verts, faces, colour[, alpha]) — alpha < 1 renders screen-door
        # translucent (reference surface transparency slider)
        verts, faces, colour = mesh[:3]
        alpha = float(mesh[3]) if len(mesh) > 3 else 1.0
        verts = np.asarray(verts, np.float32)
        faces = np.asarray(faces, np.int64)
        if len(faces) > max_triangles:
            verts, faces = decimate(verts, faces,
                                    1.0 - max_triangles / len(faces))
            faces = np.asarray(faces, np.int64)
            if np.ndim(colour) == 2:  # vertex ids changed: colours no
                colour = np.asarray(colour).mean(axis=0)  # longer align
        all_v.append(verts)
        all_f.append(faces + base)
        colour = np.asarray(colour, np.float32)
        if colour.ndim == 2:  # per-vertex colours (V, 3), e.g. MEP
            # heat map (reference mep_visualizer.py textures the brain
            # actor): face colour = corner mean in this renderer
            cols.append(colour[faces].mean(axis=1).T.astype(np.float32))
        else:
            cols.append(np.tile(colour[:, None], (1, len(faces))))
        alphas.append(np.full((1, len(faces)), alpha, np.float32))
        base += len(verts)
    verts = np.concatenate(all_v)
    faces = np.concatenate(all_f)
    col_np = np.concatenate(cols, axis=1)
    alpha_np = np.concatenate(alphas, axis=1)
    if (alpha_np < 1.0).any():  # alpha rides as a 4th colour row so the
        col_np = np.concatenate([col_np, alpha_np])  # subdivision splits it

    screen = _screen(verts, view_matrix(azimuth, elevation), size)
    screen, fc, (world,), parent = _subdivide(screen, faces, (verts.astype(np.float32),))
    if fc is not faces:  # sub-faces take their parent's colour
        col_np = col_np[:, parent]
    colour_rgb = torch.from_numpy(np.ascontiguousarray(col_np)).to(dev)

    f3 = _faces_on(fc, dev)
    p0, p1, p2 = _corners(screen, f3)
    # Lambert shade from world-space face normals, the cross product and
    # the two 3-term sums in XLA's order, so the 6-bit colours truncate
    # alike on every device
    q0, q1, q2 = _corners(world, f3)
    e1 = q1 - q0
    e2 = q2 - q0
    n = torch.stack([fma(e1[1], e2[2], -(e1[2] * e2[1])),
                     fma(e1[2], e2[0], -(e1[0] * e2[2])),
                     fma(e1[0], e2[1], -(e1[1] * e2[0]))])
    n = n / torch.clamp_min(torch.sqrt(fma(n[2], n[2], fma(n[1], n[1], n[0] * n[0]))), 1e-9)
    lv = np.asarray(light, np.float32)
    lv = (lv / np.linalg.norm(lv)).astype(np.float32)
    dot = fma(n[2], lv[2], fma(n[1], lv[1], n[0] * float(lv[0])))
    shade = fma(0.75, dot.abs(), 0.25)

    img = _splat(p0, p1, p2, shade, colour_rgb, size, ssao=ssao).cpu().numpy()
    bg = np.all(img == 0, axis=-1)
    img = img.copy()
    img[bg] = background
    return img


def draw_force_bar(img: np.ndarray, force_n: float,
                   safe_n: float = 3.0, max_n: float = 5.0) -> np.ndarray:
    """Robot contact-force bar on the left edge (reference
    data/visualization/robot_force_visualizer.py: green below the safe
    threshold, yellow to the limit, red beyond)."""
    img = img.copy()
    H = img.shape[0]
    x0, w = 4, 7
    top, bot = int(H * 0.1), int(H * 0.9)
    img[top:bot, x0:x0 + w] = (40, 44, 52)
    frac = min(max(force_n / max_n, 0.0), 1.0)
    colour = ((60, 200, 90) if force_n < safe_n else
              (230, 200, 60) if force_n < max_n else (230, 70, 60))
    fill_top = bot - int((bot - top) * frac)
    img[fill_top:bot, x0:x0 + w] = colour
    ticky = bot - int((bot - top) * min(safe_n / max_n, 1.0))
    img[max(ticky - 1, 0):ticky + 1, x0 - 2:x0 + w + 2] = (220, 220, 220)
    return img


def slice_plane_mesh(slc, orientation: str, index: int, step: int = 4):
    """(verts (V,3) world mm, faces (F,3), per-vertex colours (V,3)) for
    the current slice as a textured plane inside the 3D scene (reference
    viewer_volume.py:4007 SlicePlane).  ``step`` subsamples the slice so
    the plane stays a few thousand quads."""
    rgb = np.asarray(slc.get_rendered_slice(orientation, index))
    rgb = rgb[::step, ::step].astype(np.float32) / 255.0
    H, W = rgb.shape[:2]
    rows = np.arange(H) * step
    cols = np.arange(W) * step
    rr, cc = np.meshgrid(rows, cols, indexing="ij")
    zi = np.full(rr.size, float(index))
    if orientation == "AXIAL":       # rows=y, cols=x
        zyx = np.stack([zi, rr.ravel(), cc.ravel()], 1)
    elif orientation == "CORONAL":   # rows=z, cols=x
        zyx = np.stack([rr.ravel(), zi, cc.ravel()], 1)
    else:                            # SAGITTAL: rows=z, cols=y
        zyx = np.stack([rr.ravel(), cc.ravel(), zi], 1)
    verts = np.asarray(slc.volume.voxel_to_world(zyx), np.float32)
    idx = np.arange(H * W).reshape(H, W)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[1:, :-1].ravel()
    faces = np.concatenate([np.stack([a, b, c], 1),
                            np.stack([a, c, d], 1)]).astype(np.int32)
    return verts, faces, rgb.reshape(-1, 3)


def render_scene(surfaces, markers=None, probe_pose=None, streamlines=None,
                 coil_poses=None, robot_force=None, slice_plane=None,
                 device=DEFAULT_DEVICE, **kw) -> np.ndarray:
    """Navigation-scene composition: surfaces + marker glyph spheres +
    a probe arrow + coil figure-8 glyphs + tract streamlines (reference
    viewer_volume.py navigation scene; the actor_factory sphere/arrow
    builders and data/visualization/coil_visualizer.py coil actor become
    generated glyph meshes, tractography tubes become thin ribbons)."""
    meshes = [(s.vertices, s.faces, s.colour,
               1.0 - float(getattr(s, "transparency", 0.0)))
              for s in surfaces if getattr(s, "is_shown", True)]
    if slice_plane is not None:  # (verts, faces, per-vertex rgb) from
        meshes.append(slice_plane)  # slice_plane_mesh (SlicePlane :4007)
    if markers:
        for m in markers:
            pos = np.asarray(getattr(m, "position", m)[:3], float)
            colour = tuple(getattr(m, "colour", (1.0, 0.2, 0.2)))[:3]
            v, f = _icosphere(pos, radius=2.0)
            meshes.append((v, f, colour))
    if probe_pose is not None:
        v, f = _arrow(np.asarray(probe_pose[:3], float),
                      np.asarray(probe_pose[3:6], float))
        meshes.append((v, f, (0.2, 0.9, 0.4)))
    if coil_poses:
        for pose in coil_poses:
            v, f = _coil_glyph(np.asarray(pose[:3], float),
                               np.asarray(pose[3:6], float))
            meshes.append((v, f, (0.35, 0.55, 0.95)))
    if streamlines:
        for item in streamlines:
            pts, colour = (item if isinstance(item, tuple)
                           else (item, (0.95, 0.8, 0.2)))
            v, f = _ribbon(np.asarray(pts, np.float32))
            if len(f):
                meshes.append((v, f, tuple(colour)[:3]))
    img = render_surfaces(meshes, device=device, **kw)
    if robot_force is not None:
        img = draw_force_bar(img, float(robot_force))
    return img


def _ribbon(pts: np.ndarray, width: float = 0.6):
    """Thin triangle ribbon along a polyline (the tractography tube
    stand-in — reference tractography.py builds vtkTube multiblocks)."""
    if len(pts) < 2:  # nothing to draw (the JAX package raises for one point)
        return pts[:0].reshape(0, 3), np.zeros((0, 3), np.int32)
    d = np.diff(pts, axis=0)
    d = np.concatenate([d, d[-1:]])
    ref = np.array([0.0, 0.0, 1.0])
    side = np.cross(d, ref)
    bad = np.linalg.norm(side, axis=1) < 1e-6
    side[bad] = [1.0, 0.0, 0.0]
    side = side / np.linalg.norm(side, axis=1, keepdims=True) * (width / 2)
    v = np.concatenate([pts + side, pts - side]).astype(np.float32)
    n = len(pts)
    i = np.arange(n - 1)
    f = np.concatenate([
        np.stack([i, i + 1, n + i], 1),
        np.stack([i + 1, n + i + 1, n + i], 1),
    ]).astype(np.int32)
    return v, f


def _icosphere(center, radius: float = 2.0):
    """Small sphere glyph (icosahedron, good enough at marker scale)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)], np.float32)
    v = v / np.linalg.norm(v[0]) * radius + np.asarray(center, np.float32)
    f = np.array([
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)], np.int32)
    return v, f


def _coil_glyph(center, angles_deg, wing_radius: float = 9.0,
                segments: int = 12):
    """TMS figure-8 coil glyph: two tangent discs in the pose's xy-plane
    plus a handle quad along -y (reference coil_visualizer.py ships an
    STL coil actor; a generated glyph keeps the scene mesh-free)."""
    from invesalius3_tpu_torch.ops import transforms as tr

    m = tr.euler_matrix(*np.radians(np.asarray(angles_deg, float)),
                        axes="sxyz")[:3, :3]
    verts = []
    faces = []
    ang = np.linspace(0.0, 2 * np.pi, segments, endpoint=False)
    for side in (-1.0, 1.0):
        c = np.array([side * wing_radius, 0.0, 0.0])
        base = len(verts)
        verts.append(c)
        for a in ang:
            verts.append(c + wing_radius * np.array([np.cos(a), np.sin(a), 0.0]))
        for i in range(segments):
            j = base + 1 + i
            k = base + 1 + (i + 1) % segments
            faces.append((base, j, k))
            faces.append((base, k, j))  # two-sided disc: visible either way
    base = len(verts)
    w = wing_radius * 0.25
    for p in ([-w, -wing_radius, 0], [w, -wing_radius, 0],
              [w, -3 * wing_radius, 0], [-w, -3 * wing_radius, 0]):
        verts.append(np.asarray(p, float))
    faces += [(base, base + 1, base + 2), (base, base + 2, base + 3),
              (base, base + 2, base + 1), (base, base + 3, base + 2)]
    v = (np.asarray(verts, np.float32) @ m.T
         + np.asarray(center, np.float32)).astype(np.float32)
    return v, np.asarray(faces, np.int32)


def _arrow(tip, angles_deg, length: float = 20.0, width: float = 2.0):
    """Probe arrow glyph along the pose's z axis (actor_factory arrows)."""
    from invesalius3_tpu_torch.ops import transforms as tr

    m = tr.euler_matrix(*np.radians(np.asarray(angles_deg, float)),
                        axes="sxyz")[:3, :3]
    axis = m @ np.array([0.0, 0.0, 1.0])
    side = np.cross(axis, [0.0, 0.0, 1.0])
    if np.linalg.norm(side) < 1e-6:
        side = np.array([1.0, 0.0, 0.0])
    side = side / np.linalg.norm(side) * width
    up = np.cross(axis, side)
    up = up / max(np.linalg.norm(up), 1e-9) * width
    tail = np.asarray(tip, float) - axis * length
    v = np.stack([tip, tail + side, tail - side, tail + up, tail - up]
                 ).astype(np.float32)
    f = np.array([(0, 1, 3), (0, 3, 2), (0, 2, 4), (0, 4, 1),
                  (1, 4, 2), (2, 4, 3), (1, 2, 3), (1, 3, 4)], np.int32)
    return v, f

"""Slice-overlay compositing: the canvas-renderer equivalent as pure
numpy drawing on rendered RGB slices (a copy of
invesalius3_tpu/core/canvas.py, which cannot be imported without jax; the
drawing stays on the host, so the bytes are identical).

The reference draws measures, the crop rectangle, and polygon handles onto
every slice through a wx.GraphicsContext-backed canvas layer (reference
invesalius/gui/widgets/canvas_renderer.py:77 ``CanvasRendererCTX``, draw
primitives :381-1000; measures' ``draw_to_canvas`` at
invesalius/data/measures.py:877 (linear), :1533 (angular), :1320
(annotation), :1818/:2138 (density)).  Here the composite happens directly
in the slice RGB array — no GUI toolkit — so the HTTP viewer and picture
export get the same overlays the reference shows on screen.

All draw_* functions mutate ``img`` (H, W, 3) uint8 in place and clip to
bounds.  Coordinates are (col x, row y) pixel floats like the reference's
canvas primitives.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# 5x7 bitmap font (classic public-domain LCD glyph shapes, re-encoded by
# hand; each glyph = 7 rows x 5 bits, MSB = leftmost column)
# ---------------------------------------------------------------------------

_FONT = {
    "0": (0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E),
    "1": (0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "2": (0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F),
    "3": (0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E),
    "4": (0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02),
    "5": (0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E),
    "6": (0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E),
    "7": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08),
    "8": (0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E),
    "9": (0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C),
    "A": (0x0E, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11),
    "B": (0x1E, 0x11, 0x11, 0x1E, 0x11, 0x11, 0x1E),
    "C": (0x0E, 0x11, 0x10, 0x10, 0x10, 0x11, 0x0E),
    "D": (0x1C, 0x12, 0x11, 0x11, 0x11, 0x12, 0x1C),
    "E": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x1F),
    "F": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x10),
    "G": (0x0E, 0x11, 0x10, 0x17, 0x11, 0x11, 0x0F),
    "H": (0x11, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11),
    "I": (0x0E, 0x04, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "J": (0x07, 0x02, 0x02, 0x02, 0x02, 0x12, 0x0C),
    "K": (0x11, 0x12, 0x14, 0x18, 0x14, 0x12, 0x11),
    "L": (0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x1F),
    "M": (0x11, 0x1B, 0x15, 0x15, 0x11, 0x11, 0x11),
    "N": (0x11, 0x19, 0x15, 0x13, 0x11, 0x11, 0x11),
    "O": (0x0E, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "P": (0x1E, 0x11, 0x11, 0x1E, 0x10, 0x10, 0x10),
    "Q": (0x0E, 0x11, 0x11, 0x11, 0x15, 0x12, 0x0D),
    "R": (0x1E, 0x11, 0x11, 0x1E, 0x14, 0x12, 0x11),
    "S": (0x0F, 0x10, 0x10, 0x0E, 0x01, 0x01, 0x1E),
    "T": (0x1F, 0x04, 0x04, 0x04, 0x04, 0x04, 0x04),
    "U": (0x11, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "V": (0x11, 0x11, 0x11, 0x11, 0x11, 0x0A, 0x04),
    "W": (0x11, 0x11, 0x11, 0x15, 0x15, 0x1B, 0x11),
    "X": (0x11, 0x11, 0x0A, 0x04, 0x0A, 0x11, 0x11),
    "Y": (0x11, 0x11, 0x0A, 0x04, 0x04, 0x04, 0x04),
    "Z": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x10, 0x1F),
    ".": (0x00, 0x00, 0x00, 0x00, 0x00, 0x0C, 0x0C),
    ",": (0x00, 0x00, 0x00, 0x00, 0x0C, 0x04, 0x08),
    ":": (0x00, 0x0C, 0x0C, 0x00, 0x0C, 0x0C, 0x00),
    "-": (0x00, 0x00, 0x00, 0x1F, 0x00, 0x00, 0x00),
    "+": (0x00, 0x04, 0x04, 0x1F, 0x04, 0x04, 0x00),
    "/": (0x01, 0x01, 0x02, 0x04, 0x08, 0x10, 0x10),
    "(": (0x02, 0x04, 0x08, 0x08, 0x08, 0x04, 0x02),
    ")": (0x08, 0x04, 0x02, 0x02, 0x02, 0x04, 0x08),
    "%": (0x18, 0x19, 0x02, 0x04, 0x08, 0x13, 0x03),
    "°": (0x0C, 0x12, 0x12, 0x0C, 0x00, 0x00, 0x00),
    "²": (0x0C, 0x02, 0x04, 0x0E, 0x00, 0x00, 0x00),
    "³": (0x0E, 0x06, 0x02, 0x0C, 0x00, 0x00, 0x00),
    " ": (0, 0, 0, 0, 0, 0, 0),
}


def _glyph(ch: str) -> np.ndarray:
    rows = _FONT.get(ch.upper(), _FONT.get(ch, _FONT[" "]))
    bits = np.array(rows, np.uint8)[:, None] >> np.arange(4, -1, -1)[None, :]
    return (bits & 1).astype(bool)  # (7, 5)


def text_mask(text: str, scale: int = 1) -> np.ndarray:
    """Boolean (7*scale, (6*len-1)*scale) pixel mask for ``text``."""
    if not text:
        return np.zeros((7, 0), bool)
    cols = []
    for i, ch in enumerate(text):
        if i:
            cols.append(np.zeros((7, 1), bool))
        cols.append(_glyph(ch))
    m = np.concatenate(cols, axis=1)
    if scale > 1:
        m = np.repeat(np.repeat(m, scale, 0), scale, 1)
    return m


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _blend(img: np.ndarray, rows, cols, colour, alpha: float = 1.0) -> None:
    h, w = img.shape[:2]
    ok = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    r, c = rows[ok], cols[ok]
    colour = np.asarray(colour, np.float32)
    if alpha >= 1.0:
        img[r, c] = colour.astype(np.uint8)
    else:
        img[r, c] = (img[r, c] * (1 - alpha) + colour * alpha).astype(np.uint8)


def draw_line(img, p0, p1, colour=(255, 128, 0), thickness: int = 1,
              alpha: float = 1.0) -> None:
    """p0/p1 = (x, y) pixel coords."""
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2 + 1
    t = np.linspace(0.0, 1.0, n)
    xs = np.rint(x0 + (x1 - x0) * t).astype(np.int64)
    ys = np.rint(y0 + (y1 - y0) * t).astype(np.int64)
    if thickness <= 1:
        _blend(img, ys, xs, colour, alpha)
        return
    r = thickness // 2
    off = np.arange(-r, r + 1)
    oy, ox = np.meshgrid(off, off, indexing="ij")
    keep = oy ** 2 + ox ** 2 <= r * r + 1
    oy, ox = oy[keep], ox[keep]
    _blend(img, (ys[:, None] + oy[None, :]).ravel(),
           (xs[:, None] + ox[None, :]).ravel(), colour, alpha)


def draw_polyline(img, pts, colour=(255, 128, 0), closed: bool = False,
                  thickness: int = 1) -> None:
    pts = list(pts)
    for a, b in zip(pts, pts[1:]):
        draw_line(img, a, b, colour, thickness)
    if closed and len(pts) > 2:
        draw_line(img, pts[-1], pts[0], colour, thickness)


def draw_circle(img, center, radius: float, colour=(255, 128, 0),
                filled: bool = False, thickness: int = 1) -> None:
    cx, cy = float(center[0]), float(center[1])
    if filled:
        r = int(np.ceil(radius))
        off = np.arange(-r, r + 1)
        oy, ox = np.meshgrid(off, off, indexing="ij")
        keep = oy ** 2 + ox ** 2 <= radius * radius
        _blend(img, (np.rint(cy) + oy[keep]).astype(np.int64),
               (np.rint(cx) + ox[keep]).astype(np.int64), colour)
        return
    n = max(int(2 * np.pi * radius) * 2, 16)
    th = np.linspace(0, 2 * np.pi, n)
    for k in range(thickness):
        xs = np.rint(cx + (radius + k) * np.cos(th)).astype(np.int64)
        ys = np.rint(cy + (radius + k) * np.sin(th)).astype(np.int64)
        _blend(img, ys, xs, colour)


def draw_ellipse(img, center, rx: float, ry: float, colour=(255, 128, 0)) -> None:
    cx, cy = float(center[0]), float(center[1])
    n = max(int(2 * np.pi * max(rx, ry)) * 2, 16)
    th = np.linspace(0, 2 * np.pi, n)
    xs = np.rint(cx + rx * np.cos(th)).astype(np.int64)
    ys = np.rint(cy + ry * np.sin(th)).astype(np.int64)
    _blend(img, ys, xs, colour)


def draw_rect(img, p0, p1, colour=(255, 255, 0), thickness: int = 1,
              dashed: bool = False) -> None:
    x0, x1 = sorted((float(p0[0]), float(p1[0])))
    y0, y1 = sorted((float(p0[1]), float(p1[1])))
    corners = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
    if not dashed:
        draw_polyline(img, corners, colour, closed=True, thickness=thickness)
        return
    for a, b in zip(corners, corners[1:] + corners[:1]):
        ln = np.hypot(b[0] - a[0], b[1] - a[1])
        n_seg = max(int(ln // 6), 1)
        for s in range(n_seg):
            t0, t1 = s / n_seg, (s + 0.6) / n_seg
            draw_line(img, (a[0] + (b[0] - a[0]) * t0, a[1] + (b[1] - a[1]) * t0),
                      (a[0] + (b[0] - a[0]) * t1, a[1] + (b[1] - a[1]) * t1),
                      colour, thickness)


def draw_handle(img, center, colour=(255, 128, 0), radius: int = 3) -> None:
    """Measure endpoint marker: filled dot + white rim (the reference's
    CircleHandler look, canvas_renderer.py:1104)."""
    draw_circle(img, center, radius, colour, filled=True)
    draw_circle(img, center, radius + 0.5, (255, 255, 255))


def draw_text(img, pos, text: str, colour=(255, 255, 255), scale: int = 1,
              background: Optional[Tuple[int, int, int]] = (0, 0, 0),
              bg_alpha: float = 0.55) -> None:
    """Top-left anchored label with an optional translucent background box
    (the reference's TextBox, canvas_renderer.py:1005)."""
    m = text_mask(text, scale)
    if m.size == 0:
        return
    x, y = int(round(float(pos[0]))), int(round(float(pos[1])))
    h, w = m.shape
    if background is not None:
        yy, xx = np.mgrid[y - 1:y + h + 1, x - 1:x + w + 1]
        _blend(img, yy.ravel(), xx.ravel(), background, bg_alpha)
    ys, xs = np.nonzero(m)
    _blend(img, ys + y, xs + x, colour)


def draw_cross(img, center, colour=(0, 255, 0), size: int = 6,
               gap: int = 2) -> None:
    """Crosshair pointer (viewer cross focal marker)."""
    cx, cy = float(center[0]), float(center[1])
    for d in (-1, 1):
        draw_line(img, (cx + d * gap, cy), (cx + d * (gap + size), cy), colour)
        draw_line(img, (cx, cy + d * gap), (cx, cy + d * (gap + size)), colour)


def draw_ruler(img, px_per_mm: float, colour=(255, 255, 255)) -> None:
    """On-screen mm scale bar (reference data/ruler.py: left-edge ruler
    sized to a round number of mm for the current zoom).

    Picks the largest of 10/20/50/100 mm that fits a third of the image
    height, draws it with end ticks and a label along the left edge.
    """
    h = img.shape[0]
    for mm in (100, 50, 20, 10, 5, 2, 1):
        bar = mm * px_per_mm
        if bar <= h / 3 and bar >= 8:
            break
    else:
        return
    x = 10
    y0 = (h - bar) / 2
    y1 = y0 + bar
    draw_line(img, (x, y0), (x, y1), colour)
    draw_line(img, (x - 3, y0), (x + 3, y0), colour)
    draw_line(img, (x - 3, y1), (x + 3, y1), colour)
    draw_text(img, (x + 5, (y0 + y1) / 2 - 4), f"{mm} MM", colour,
              background=None)


# per-orientation edge letters: (top, bottom, left, right) as seen in the
# rendered array (reference data/orientation.py + viewer_slice directional
# annotations; radiological convention: patient left on screen right)
_ORIENT_LABELS = {
    "AXIAL": ("A", "P", "R", "L"),
    "CORONAL": ("S", "I", "R", "L"),
    "SAGITAL": ("S", "I", "A", "P"),
}


def draw_orientation_labels(img, orientation: str,
                            colour=(255, 220, 90)) -> None:
    """Anatomical direction letters on the four slice edges."""
    labels = _ORIENT_LABELS.get(orientation)
    if labels is None:
        return
    h, w = img.shape[:2]
    top, bottom, left, right = labels
    draw_text(img, (w / 2 - 2, 2), top, colour, background=None)
    draw_text(img, (w / 2 - 2, h - 10), bottom, colour, background=None)
    draw_text(img, (2, h / 2 - 4), left, colour, background=None)
    draw_text(img, (w - 8, h / 2 - 4), right, colour, background=None)


# ---------------------------------------------------------------------------
# measure compositing
# ---------------------------------------------------------------------------


def _measure_label(m) -> str:
    if m.type == "angular":
        return f"{m.value:.1f}°"
    if m.type in ("density_ellipse", "density_polygon"):
        return f"M {m.value:.1f}"
    if m.type == "annotation":
        return str(m.value)
    return f"{m.value:.2f} MM"


def world_to_pixel(point_xyz, orientation: str, spacing) -> Tuple[float, float]:
    """World mm (x, y, z) -> slice pixel (col, row) for an orientation.

    AXIAL slices index z and show (row=y, col=x); CORONAL indexes y showing
    (row=z, col=x); SAGITAL indexes x showing (row=z, col=y) — matching
    ``matrix.select(ORIENTATION_AXIS[o], i)`` on (z, y, x) volumes.
    """
    sx, sy, sz = spacing
    x, y, z = (float(v) for v in point_xyz)
    if orientation == "AXIAL":
        return x / sx, y / sy
    if orientation == "CORONAL":
        return x / sx, z / sz
    return y / sy, z / sz  # SAGITAL


def measure_slice_index(point_xyz, orientation: str, spacing) -> int:
    sx, sy, sz = spacing
    x, y, z = (float(v) for v in point_xyz)
    if orientation == "AXIAL":
        return int(round(z / sz))
    if orientation == "CORONAL":
        return int(round(y / sy))
    return int(round(x / sx))


def draw_measure(img, m, orientation: str, slice_number: int, spacing,
                 scale: float = 1.0) -> bool:
    """Composite one measurement onto a rendered slice if it belongs there.
    Returns True when drawn.  ``scale`` maps slice pixels to image pixels
    (resized viewer outputs)."""
    if not getattr(m, "visible", True):
        return False
    if m.location != orientation:
        return False
    pts = [world_to_pixel(p, orientation, spacing) for p in m.points]
    if m.points and measure_slice_index(m.points[0], orientation,
                                        spacing) != slice_number:
        if m.slice_number != slice_number:
            return False
    elif not m.points:
        return False
    pts = [(x * scale, y * scale) for x, y in pts]
    colour = tuple(int(c * 255) for c in m.colour)
    label_anchor = pts[-1]
    if m.type == "linear" and len(pts) >= 2:
        draw_line(img, pts[0], pts[1], colour)
        draw_handle(img, pts[0], colour)
        draw_handle(img, pts[1], colour)
        label_anchor = ((pts[0][0] + pts[1][0]) / 2 + 6,
                        (pts[0][1] + pts[1][1]) / 2 - 10)
    elif m.type == "angular" and len(pts) >= 3:
        draw_line(img, pts[1], pts[0], colour)
        draw_line(img, pts[1], pts[2], colour)
        for p in pts:
            draw_handle(img, p, colour)
        label_anchor = (pts[1][0] + 8, pts[1][1] - 10)
    elif m.type == "annotation":
        anchor = pts[0]
        lead = pts[1] if len(pts) > 1 else (anchor[0] + 14, anchor[1] - 14)
        draw_handle(img, anchor, colour)
        draw_line(img, anchor, lead, colour)
        label_anchor = (lead[0] + 3, lead[1] - 4)
    elif m.type == "density_ellipse":
        center = pts[0] if pts else (0, 0)
        rx = float(m.extra.get("rx", 10.0)) * scale
        ry = float(m.extra.get("ry", 10.0)) * scale
        draw_ellipse(img, center, rx, ry, colour)
        label_anchor = (center[0] + rx + 4, center[1] - 4)
    elif m.type == "density_polygon":
        draw_polyline(img, pts, colour, closed=True)
    else:
        draw_polyline(img, pts, colour)
    draw_text(img, label_anchor, _measure_label(m), (255, 255, 255))
    return True


def draw_crop_box(img, box, orientation: str, slice_number: int,
                  scale: float = 1.0) -> bool:
    """Dashed crop rectangle on slices the box intersects (reference
    geometry.py:269 2D crop drawing).  ``box.limits`` = (zi, zf, yi, yf,
    xi, xf) voxel indices."""
    zi, zf, yi, yf, xi, xf = box.limits
    if orientation == "AXIAL":
        if not zi <= slice_number <= zf:
            return False
        p0, p1 = (xi, yi), (xf, yf)
    elif orientation == "CORONAL":
        if not yi <= slice_number <= yf:
            return False
        p0, p1 = (xi, zi), (xf, zf)
    else:
        if not xi <= slice_number <= xf:
            return False
        p0, p1 = (yi, zi), (yf, zf)
    draw_rect(img, (p0[0] * scale, p0[1] * scale),
              (p1[0] * scale, p1[1] * scale), (255, 255, 0), dashed=True)
    return True

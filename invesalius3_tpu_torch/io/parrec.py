"""Philips PAR/REC reader (research export format).

The port's copy of invesalius3_tpu/io/parrec.py (numpy on the host; the
caller moves the volume to its device).

Reference: invesalius/reader/others_reader.py:29 ``ReadOthers`` accepts
PAR/REC through nibabel's parrec module; this is an independent minimal
reader for the common V4.x single-volume case (text .PAR header + raw
little-endian .REC pixel data), returning the same (volume zyx, spacing
xyz) contract as io.nifti.read_nifti.

Supported: 8/16-bit REC data, per-image rescale (DV = PV * RS + RI,
the "displayed value" nibabel also defaults to), slice ordering by the
slice-number column, single echo/dynamic/phase. Multi-dynamic files
return the first dynamic.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Tuple

import numpy as np

# General-information keys we need (PAR "=" lines; names stable across
# V3/V4/V4.1/V4.2).
_GEN_PATTERNS = {
    "slices": r"Max\. number of slices/locations\s*:\s*(\d+)",
    "dynamics": r"Max\. number of dynamics\s*:\s*(\d+)",
    "fov": r"FOV \(ap,fh,rl\) \[mm\]\s*:\s*([\d.\-]+)\s+([\d.\-]+)\s+([\d.\-]+)",
    "recon": r"Recon resolution \(x, y\)\s*:\s*(\d+)\s+(\d+)",
    "thickness": r"Slice thickness \[mm\]\s*:\s*([\d.]+)",
    "gap": r"Slice gap \[mm\]\s*:\s*([\d.\-]+)",
}

# Image-table column indices for PAR V4.x (fixed leading layout; see the
# "sl ec dyn ph ty idx pix scan% rec-x rec-y ri rs ss ..." column
# definition block every V4 PAR carries).
_COL = {
    "slice": 0,
    "echo": 1,
    "dynamic": 2,
    "phase": 3,
    "scan_seq": 5,
    "rec_index": 6,
    "pix_bits": 7,
    "recon_x": 9,
    "recon_y": 10,
    "ri": 11,
    "rs": 12,
    "ss": 13,
    "pixel_spacing_x": 28,
    "pixel_spacing_y": 29,
}


def _parse_par(par_text: str) -> dict:
    gen: dict = {}
    for key, pat in _GEN_PATTERNS.items():
        m = re.search(pat, par_text)
        if m:
            gen[key] = [float(g) for g in m.groups()]
    rows = []
    for line in par_text.splitlines():
        s = line.strip()
        if not s or s.startswith(("#", ".", "*")):
            continue
        parts = s.split()
        try:
            rows.append([float(p) for p in parts])
        except ValueError:
            continue
    if not rows:
        raise ValueError("PAR file has no image-information rows")
    gen["rows"] = rows
    return gen


def list_par_volumes(path) -> list:
    """Enumerate the (dynamic, echo, phase, scan_seq) combinations a
    multi-volume PAR contains — pick one and pass it to read_par_rec."""
    par_path, _ = _find_pair(path)
    gen = _parse_par(par_path.read_text(errors="replace"))
    ncol = len(gen["rows"][0])

    def col(row, name):
        i = _COL[name]
        return row[i] if i < ncol else 0.0

    seen = sorted({(int(col(r, "dynamic")), int(col(r, "echo")),
                    int(col(r, "phase")), int(col(r, "scan_seq")))
                   for r in gen["rows"]})
    return [{"dynamic": d, "echo": e, "phase": p, "scan_seq": s}
            for d, e, p, s in seen]


def _find_pair(path):
    p = Path(path)
    stem = p.with_suffix("")
    par_path = rec_path = None
    for ext in (".PAR", ".par"):
        if stem.with_suffix(ext).exists():
            par_path = stem.with_suffix(ext)
    for ext in (".REC", ".rec"):
        if stem.with_suffix(ext).exists():
            rec_path = stem.with_suffix(ext)
    if par_path is None or rec_path is None:
        raise FileNotFoundError(f"PAR/REC pair not found for {path}")
    return par_path, rec_path


def _check_version(par_text: str) -> None:
    """Reject pre-V4 exports with a clear error — the reference reads
    PAR/REC through nibabel, which likewise supports V4/V4.1/V4.2 only."""
    m = re.search(r"image export tool\s+V(\d+)", par_text, re.IGNORECASE)
    if m and int(m.group(1)) < 4:
        raise ValueError(
            f"PAR V{m.group(1)} is not supported (V4/V4.1/V4.2 only, "
            "matching the reference's nibabel reader); re-export with a "
            "V4.x tool")


def read_par_rec(path, dynamic: int = None, echo: int = None,
                 phase: int = None) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """Load a PAR/REC pair; ``path`` may point at either file.
    Returns (volume zyx float32-or-int16, spacing xyz mm).

    Multi-dynamic/echo/phase exports default to the first of each;
    pass ``dynamic=``/``echo=``/``phase=`` (values from list_par_volumes)
    to select another volume."""
    par_path, rec_path = _find_pair(path)
    par_text = par_path.read_text(errors="replace")
    _check_version(par_text)
    gen = _parse_par(par_text)
    rows = gen["rows"]
    ncol = len(rows[0])

    def col(row, name, default=0.0):
        i = _COL[name]
        return row[i] if i < ncol else default

    # one volume per read: the requested dynamic/echo/phase, defaulting to
    # the first of each (reference loads one nibabel volume; without the
    # echo/phase filter, multi-echo rows would stack as extra slices)
    requested = {"dynamic": dynamic, "echo": echo, "phase": phase,
                 "scan_seq": None}
    for name, want in requested.items():
        values = {col(r, name) for r in rows}
        sel = float(want) if want is not None else min(values)
        if sel not in values:
            raise ValueError(
                f"PAR has no {name}={want}; available: {sorted(values)}")
        rows = [r for r in rows if col(r, name) == sel]
    rows.sort(key=lambda r: col(r, "slice"))

    bits = int(col(rows[0], "pix_bits", 16))
    rx = int(col(rows[0], "recon_x", 0)) or int(gen.get("recon", [0, 0])[0])
    ry = int(col(rows[0], "recon_y", 0)) or int(gen.get("recon", [0, 0])[1])
    nz = len(rows)
    dtype = np.int16 if bits == 16 else np.uint8

    raw = np.fromfile(rec_path, dtype="<" + np.dtype(dtype).str[1:])
    px_per_slice = ry * rx
    # Gather each selected row's pixel block via its 'index in REC file'
    # column — PAR tables may list rows out of REC order (interleaved
    # dynamics/echoes), so sequential slicing would scramble slices.
    vol = np.empty((nz, ry, rx), np.float32)
    for k, r in enumerate(rows):
        idx = int(col(r, "rec_index", k))
        start = idx * px_per_slice
        if start + px_per_slice > raw.size:
            raise ValueError(
                f"REC too small: block {idx} needs pixels up to "
                f"{start + px_per_slice}, file has {raw.size}")
        vol[k] = raw[start : start + px_per_slice].reshape(ry, rx)

    # per-slice rescale to displayed values: DV = PV * RS + RI
    rs = np.array([col(r, "rs", 1.0) or 1.0 for r in rows], np.float32)
    ri = np.array([col(r, "ri", 0.0) for r in rows], np.float32)
    vol = vol * rs[:, None, None] + ri[:, None, None]
    if np.all(rs == 1.0) and np.all(ri == 0.0) and bits == 16:
        vol = vol.astype(np.int16)

    # spacing: per-image pixel spacing columns when present, else FOV/matrix
    sx = float(col(rows[0], "pixel_spacing_x", 0.0))
    sy = float(col(rows[0], "pixel_spacing_y", 0.0))
    if not (sx and sy):
        fov = gen.get("fov", [0.0, 0.0, 0.0])  # (ap, fh, rl)
        sx = fov[2] / rx if fov[2] else 1.0
        sy = fov[0] / ry if fov[0] else 1.0
    thick = gen.get("thickness", [1.0])[0]
    gap = gen.get("gap", [0.0])[0]
    return vol, (sx or 1.0, sy or 1.0, thick + gap)

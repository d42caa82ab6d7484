"""Bitmap slice-stack reader: TIFF/BMP/JPEG/PNG stacks (incl. micro-CT)
via Pillow (port of invesalius3_tpu/io/bitmap.py; numpy on the host, the
caller moves the volume to its device).

Pillow is imported when a stack is read.  Without it ``load_bitmap_dir``
raises an ImportError that names Pillow; the JAX package skips every file
then and reports that none was readable.

Reference behavior: invesalius/reader/bitmap_reader.py (LoadBitmap :144,
per-type VTK readers :314, ScipyRead fallback :298) — a directory of 2D
images becomes a volume, sorted naturally by filename.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Tuple

import numpy as np

from invesalius3_tpu_torch.io.dicom_codecs import pil_image

BITMAP_EXTENSIONS = {".tif", ".tiff", ".bmp", ".png", ".jpg", ".jpeg"}


def _natural_key(name: str):
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", name)]


def list_bitmap_files(directory) -> List[Path]:
    files = [
        Path(directory) / n
        for n in os.listdir(directory)
        if Path(n).suffix.lower() in BITMAP_EXTENSIONS
    ]
    return sorted(files, key=lambda p: _natural_key(p.name))


def read_bitmap(path) -> np.ndarray:
    """One 2D image as grayscale array (int16 for 16-bit, else uint8)."""
    with pil_image().open(path) as im:
        if im.mode in ("I;16", "I;16B", "I"):
            arr = np.asarray(im, dtype=np.int32)
            return np.clip(arr, -32768, 32767).astype(np.int16)
        if im.mode not in ("L", "F"):
            im = im.convert("L")
        arr = np.asarray(im)
        if arr.dtype == np.float32:
            return arr
        return arr.astype(np.uint8)


def load_bitmap_dir(
    directory, spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """Stack every readable bitmap in ``directory`` into (Z, Y, X).

    Images with mismatched shapes are skipped (the reference warns and
    drops them)."""
    files = list_bitmap_files(directory)
    if not files:
        raise ValueError(f"no bitmap slices found in {directory}")
    pil_image()  # without Pillow, say so instead of skipping every file
    slices = []
    shape = None
    for p in files:
        try:
            arr = read_bitmap(p)
        except Exception:
            continue
        if shape is None:
            shape = arr.shape
        if arr.shape != shape:
            continue
        slices.append(arr)
    if not slices:
        raise ValueError(f"no readable bitmap slices in {directory}")
    vol = np.stack(slices)
    if vol.dtype == np.uint8:
        vol = vol.astype(np.int16)
    return vol, spacing

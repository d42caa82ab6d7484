"""Pure-Python DICOM reader and writer (port of invesalius3_tpu/io/dicom.py):
Part-10 parser, series grouping, and volume assembly on a device.

Replaces the reference's GDCM-based stack (reference
invesalius/reader/dicom.py ``Parser``, dicom_reader.py ``yGetDicomGroups``
:245 / ``LoadDicom`` :86, dicom_grouper.py ``DicomPatientGrouper`` :340 —
grouping by patient/series/orientation with z-spacing from consecutive
ImagePositionPatient and mixed-series splitting) and imagedata_utils
``dcm2memmap``/``dcmmf2memmap`` :419/:463 which materialize the voxel
volume.

Scope: implicit/explicit VR little endian and deflated explicit VR little
endian, single- and multi-frame, MONOCHROME1/2, rescale slope/intercept.
Compressed transfer syntaxes are decoded on the host: RLE Lossless and JPEG
Lossless (SV1) by the native library through ``io/dicom_codecs.py``, lossy
12-bit JPEG (.4.51) by ``io/jpeg12.py``, JPEG-LS (.4.80/.4.81) by
``io/jpegls.py``, 8-bit baseline JPEG and JPEG 2000 (.4.90/.4.91) by Pillow
— the full set the reference reads through GDCM (reference
dicom_reader.py:86-140).

Headers and pixels are parsed with numpy on the host.  ``group_to_volume``
writes the rescaled slices into one host array, moves it to the device once
and returns the tensor; ``fix_gantry_tilt`` resamples a tilted series there.
Both default to the card and raise without one unless given
``device="cpu"``.

One difference from the JAX package: a deflated dataset (.1.2.1.99) keeps
its inflated bytes, and ``pixel_array`` reads the pixels from them.  The JAX
reader seeks the inflated dataset's pixel offset in the compressed file and
fails.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.io import dicom_codecs as codecs

# transfer syntaxes
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"
DEFLATED_LE = "1.2.840.10008.1.2.1.99"

_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UT", b"UN", b"UC", b"UR", b"OV"}

# tags we materialize (group, element) -> name
TAGS = {
    (0x0008, 0x0018): "SOPInstanceUID",
    (0x0008, 0x0060): "Modality",
    (0x0008, 0x103E): "SeriesDescription",
    (0x0008, 0x1030): "StudyDescription",
    (0x0008, 0x0020): "StudyDate",
    (0x0008, 0x0030): "StudyTime",
    (0x0010, 0x0010): "PatientName",
    (0x0010, 0x0020): "PatientID",
    (0x0018, 0x0050): "SliceThickness",
    (0x0018, 0x0088): "SpacingBetweenSlices",
    (0x0018, 0x1120): "GantryDetectorTilt",
    (0x0020, 0x000D): "StudyInstanceUID",
    (0x0020, 0x000E): "SeriesInstanceUID",
    (0x0020, 0x0011): "SeriesNumber",
    (0x0020, 0x0013): "InstanceNumber",
    (0x0020, 0x0032): "ImagePositionPatient",
    (0x0020, 0x0037): "ImageOrientationPatient",
    (0x0028, 0x0002): "SamplesPerPixel",
    (0x0028, 0x0004): "PhotometricInterpretation",
    (0x0028, 0x0008): "NumberOfFrames",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0030): "PixelSpacing",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0101): "BitsStored",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1050): "WindowCenter",
    (0x0028, 0x1051): "WindowWidth",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
}
PIXEL_DATA = (0x7FE0, 0x0010)

_NUMERIC = {
    "SliceThickness", "SpacingBetweenSlices", "GantryDetectorTilt",
    "RescaleIntercept", "RescaleSlope", "SeriesNumber", "InstanceNumber",
    "SamplesPerPixel", "NumberOfFrames", "WindowCenter", "WindowWidth",
}
_NUMERIC_LIST = {"ImagePositionPatient", "ImageOrientationPatient", "PixelSpacing"}


class DicomError(ValueError):
    pass


@dataclass
class DicomFile:
    path: str
    tags: Dict[str, object] = field(default_factory=dict)
    pixel_offset: int = -1
    pixel_length: int = 0
    transfer_syntax: str = EXPLICIT_VR_LE
    # encapsulated (compressed) PixelData: [(offset, length)] item fragments,
    # first item being the Basic Offset Table (PS3.5 A.4)
    fragments: Optional[list] = None
    _pixels: Optional[np.ndarray] = None
    # a deflated dataset's inflated bytes (file meta included): the pixel
    # offset points into these, not into the file
    _inflated: Optional[bytes] = None

    def get(self, name, default=None):
        return self.tags.get(name, default)

    # -- pixel decoding ------------------------------------------------------
    def pixel_array(self) -> np.ndarray:
        """Decode raw pixel data -> (frames, rows, cols) or (rows, cols)."""
        if self._pixels is not None:
            return self._pixels
        if self.fragments is not None:
            self._pixels = self._decode_encapsulated()
            return self._pixels
        if self.pixel_offset < 0:
            raise DicomError(f"{self.path}: no PixelData")
        bits = int(self.get("BitsAllocated", 16))
        signed = int(self.get("PixelRepresentation", 0)) == 1
        rows = int(self.get("Rows"))
        cols = int(self.get("Columns"))
        spp = int(self.get("SamplesPerPixel", 1))
        frames = int(self.get("NumberOfFrames", 1) or 1)
        if bits == 16:
            dtype = np.int16 if signed else np.uint16
        elif bits == 8:
            dtype = np.int8 if signed else np.uint8
        elif bits == 32:
            dtype = np.int32 if signed else np.uint32
        else:
            raise DicomError(f"{self.path}: unsupported BitsAllocated={bits}")
        count = rows * cols * spp * frames
        nbytes = count * np.dtype(dtype).itemsize
        if self._inflated is not None:
            buf = self._inflated[self.pixel_offset:self.pixel_offset + nbytes]
        else:
            with open(self.path, "rb") as f:
                f.seek(self.pixel_offset)
                buf = f.read(nbytes)
        arr = np.frombuffer(buf, dtype=dtype, count=count)
        if spp > 1:  # RGB etc -> luminance
            arr = arr.reshape(-1, spp).mean(axis=1).astype(dtype)
        arr = arr.reshape((frames, rows, cols)) if frames > 1 else arr.reshape((rows, cols))
        self._pixels = arr
        return arr

    def _decode_encapsulated(self) -> np.ndarray:
        """Decode RLE / JPEG-Lossless encapsulated PixelData (the syntaxes
        the reference routes through GDCM, dicom_reader.py:86-140)."""
        rows = int(self.get("Rows"))
        cols = int(self.get("Columns"))
        spp = int(self.get("SamplesPerPixel", 1))
        bits = int(self.get("BitsAllocated", 16))
        signed = int(self.get("PixelRepresentation", 0)) == 1
        frames = int(self.get("NumberOfFrames", 1) or 1)
        with open(self.path, "rb") as f:
            buf = f.read()
        frame_bytes = codecs.fragments_to_frames(buf, self.fragments, frames)
        decoded = []
        for fb in frame_bytes:
            if self.transfer_syntax == codecs.RLE_LOSSLESS:
                arr = codecs.rle_decode_frame(fb, rows, cols, bits, spp)
            elif self.transfer_syntax == codecs.JPEG_BASELINE:
                arr = codecs.jpeg_baseline_decode(fb)
            elif self.transfer_syntax == codecs.JPEG_EXTENDED:
                from invesalius3_tpu_torch.io import jpeg12

                arr = jpeg12.decode(fb)  # lossy 12-bit (.4.51)
            elif self.transfer_syntax in (codecs.JPEG_LS_LOSSLESS,
                                          codecs.JPEG_LS_NEAR):
                from invesalius3_tpu_torch.io import jpegls

                arr = jpegls.decode(fb)
            elif self.transfer_syntax in (codecs.J2K_LOSSLESS, codecs.J2K):
                arr = codecs.j2k_decode(fb)
            else:  # JPEG lossless process 14
                arr = codecs.jpegll_decode(fb)
            if arr.shape[:2] != (rows, cols):
                raise DicomError(
                    f"{self.path}: frame {arr.shape} != ({rows},{cols})")
            if arr.ndim == 3:  # RGB etc -> luminance, like the raw path
                arr = arr.mean(axis=2)
            if signed:
                arr = arr.astype(np.uint16).view(np.int16) if bits == 16 else (
                    arr.astype(np.uint8).view(np.int8))
            else:
                arr = arr.astype({8: np.uint8, 16: np.uint16}.get(bits, np.uint16))
            decoded.append(arr)
        out = np.stack(decoded) if frames > 1 else decoded[0]
        return out

    def rescaled_slice(self) -> np.ndarray:
        """Pixels with modality rescale applied, int16 (the reference
        materializes int16 HU volumes — imagedata_utils.py:419-496)."""
        arr = self.pixel_array().astype(np.float32)
        slope = float(self.get("RescaleSlope", 1.0) or 1.0)
        inter = float(self.get("RescaleIntercept", 0.0) or 0.0)
        arr = arr * slope + inter
        if str(self.get("PhotometricInterpretation", "")).strip() == "MONOCHROME1":
            # invert about a constant pivot derived from the stored bit
            # depth, not each slice's own max — a per-slice pivot shifts
            # every slice of a stack by a different offset (banding)
            bits_stored = int(self.get("BitsStored", self.get("BitsAllocated", 16)))
            pivot = ((1 << bits_stored) - 1) * slope + inter
            arr = pivot - arr + inter
        return np.clip(arr, -32768, 32767).astype(np.int16)


def _parse_elements(buf: bytes, start: int, explicit: bool, want_pixels: bool,
                    file_offset: int = 0, fragments_out: Optional[list] = None):
    """Walk a dataset, returning (tags dict, pixel_offset, pixel_len).
    Encapsulated PixelData item fragments are appended to `fragments_out`
    when given, else rejected."""
    tags: Dict[str, object] = {}
    pos = start
    n = len(buf)
    pixel_offset = -1
    pixel_len = 0
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        if (group, elem) == (0xFFFE, 0xE00D) or (group, elem) == (0xFFFE, 0xE0DD):
            pos += 4
            continue
        if explicit and group != 0xFFFE:
            vr = buf[pos : pos + 2]
            if vr in _LONG_VRS:
                (length,) = struct.unpack_from("<I", buf, pos + 4)
                pos += 8
            else:
                (length,) = struct.unpack_from("<H", buf, pos + 2)
                pos += 4
        else:
            vr = b"UN"
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4

        if (group, elem) == PIXEL_DATA:
            if length == 0xFFFFFFFF:
                if fragments_out is None:
                    raise DicomError("encapsulated (compressed) PixelData not supported")
                frags, pos = codecs.parse_fragments(buf, pos)
                fragments_out.extend(
                    (file_offset + off, ln) for off, ln in frags)
                continue
            pixel_offset = file_offset + pos
            pixel_len = length
            pos += length
            continue

        is_sq = vr == b"SQ" or (length == 0xFFFFFFFF)
        if is_sq:
            if length == 0xFFFFFFFF:
                pos = _skip_undefined_sequence(buf, pos)
            else:
                pos += length
            continue

        name = TAGS.get((group, elem))
        if name is not None:
            raw = buf[pos : pos + length]
            tags[name] = _decode_value(name, vr, raw)
        pos += length
    return tags, pixel_offset, pixel_len


def _skip_undefined_sequence(buf: bytes, pos: int) -> int:
    """Skip items until the sequence delimitation item."""
    depth = 1
    n = len(buf)
    while pos + 8 <= n and depth > 0:
        group, elem = struct.unpack_from("<HH", buf, pos)
        (length,) = struct.unpack_from("<I", buf, pos + 4)
        pos += 8
        if (group, elem) == (0xFFFE, 0xE000):  # item
            if length == 0xFFFFFFFF:
                depth += 1
            else:
                pos += length
        elif (group, elem) == (0xFFFE, 0xE00D):  # item delimiter
            pass
        elif (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimiter
            depth -= 1
        else:
            # nested undefined-length element inside an item
            if length == 0xFFFFFFFF:
                depth += 1
            else:
                pos += length
    return pos


def _decode_value(name: str, vr: bytes, raw: bytes):
    if name in ("Rows", "Columns", "BitsAllocated", "BitsStored", "PixelRepresentation",
                "SamplesPerPixel") and len(raw) >= 2:
        return struct.unpack_from("<H", raw, 0)[0]
    text = raw.decode("latin-1", errors="replace").strip("\x00 ").strip()
    if name in _NUMERIC:
        try:
            # multi-valued numerics (e.g. WindowCenter "40\400") -> first
            return float(text.split("\\")[0])
        except ValueError:
            return None
    if name in _NUMERIC_LIST:
        try:
            return [float(t) for t in text.split("\\")]
        except ValueError:
            return None
    return text


def read_dicom(path) -> DicomFile:
    """Parse one DICOM file's header (pixels decoded lazily)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 140:
        raise DicomError(f"{path}: too small")
    if data[128:132] == b"DICM":
        # file meta group is always explicit VR LE
        pos = 132
        meta, _, _ = _parse_file_meta(data, pos)
        ts = meta.get("TransferSyntaxUID", EXPLICIT_VR_LE)
        body_start = meta["_end"]
    else:
        ts = None
        body_start = 0

    encapsulated = ts in codecs.DECODABLE_SYNTAXES
    if ts in (None, IMPLICIT_VR_LE, EXPLICIT_VR_LE):
        explicit = _looks_explicit(data, body_start) if ts is None else (ts == EXPLICIT_VR_LE)
    elif ts == DEFLATED_LE:
        import zlib

        data = data[:body_start] + zlib.decompress(data[body_start:], -15)
        explicit = True
    elif encapsulated:
        explicit = True  # encapsulated syntaxes use explicit VR LE datasets
    elif ts == EXPLICIT_VR_BE:
        raise DicomError(f"{path}: big-endian transfer syntax not supported")
    else:
        raise DicomError(f"{path}: compressed transfer syntax {ts} not supported "
                         "(lossless JPEG/RLE are decoded natively; "
                         "decompress lossy/J2K with dcmdjpeg/gdcmconv first)")

    frags: list = []
    tags, pix_off, pix_len = _parse_elements(
        data, body_start, explicit, True,
        fragments_out=frags if encapsulated else None)
    d = DicomFile(path=str(path), tags=tags, pixel_offset=pix_off,
                  pixel_length=pix_len,
                  fragments=frags if encapsulated else None,
                  transfer_syntax=ts or (EXPLICIT_VR_LE if explicit else IMPLICIT_VR_LE),
                  _inflated=data if ts == DEFLATED_LE else None)
    return d


def _parse_file_meta(data: bytes, pos: int):
    """Parse group 0002 (explicit VR LE); returns dict incl '_end'."""
    meta: Dict[str, object] = {}
    n = len(data)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", data, pos)
        if group != 0x0002:
            break
        vr = data[pos + 4 : pos + 6]
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from("<I", data, pos + 8)
            val_pos = pos + 12
        else:
            (length,) = struct.unpack_from("<H", data, pos + 6)
            val_pos = pos + 8
        if (group, elem) == (0x0002, 0x0010):
            meta["TransferSyntaxUID"] = (
                data[val_pos : val_pos + length].decode("ascii", errors="replace").strip("\x00 ")
            )
        pos = val_pos + length
    meta["_end"] = pos
    return meta, None, None


def _looks_explicit(data: bytes, pos: int) -> bool:
    vr = data[pos + 4 : pos + 6]
    return vr.isalpha() and vr.isupper()


def is_dicom(path) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(132)
        if head[128:132] == b"DICM":
            return True
        # headerless: first tag should be a small group number
        if len(head) >= 4:
            group = struct.unpack_from("<H", head, 0)[0]
            return group in (0x0002, 0x0008)
    except OSError:
        return False
    return False


# ---------------------------------------------------------------------------
# Grouping (reference dicom_grouper.py semantics)
# ---------------------------------------------------------------------------


@dataclass
class DicomGroup:
    """One coherent stack of slices (a renderable series)."""

    key: tuple
    files: List[DicomFile] = field(default_factory=list)

    @property
    def title(self) -> str:
        f = self.files[0]
        return f"{f.get('PatientName', '?')} / {f.get('SeriesDescription', '') or f.get('SeriesInstanceUID', '?')}"

    def sorted_files(self) -> List[DicomFile]:
        """Sort by position along the slice normal (the clinically-correct
        order — reference dicom_grouper.py:161), falling back to
        InstanceNumber."""
        files = self.files
        f0 = files[0]
        iop = f0.get("ImageOrientationPatient")
        if iop and all(f.get("ImagePositionPatient") for f in files):
            r = np.asarray(iop[:3])
            c = np.asarray(iop[3:])
            normal = np.cross(r, c)
            return sorted(files, key=lambda f: float(np.dot(normal, f.get("ImagePositionPatient"))))
        return sorted(files, key=lambda f: (f.get("InstanceNumber") or 0))

    def z_spacing(self) -> float:
        files = self.sorted_files()
        if len(files) >= 2:
            p0 = files[0].get("ImagePositionPatient")
            p1 = files[1].get("ImagePositionPatient")
            if p0 and p1:
                d = float(np.linalg.norm(np.asarray(p1) - np.asarray(p0)))
                if d > 0:
                    return d
        f = files[0]
        return float(f.get("SpacingBetweenSlices") or f.get("SliceThickness") or 1.0)

    def preview_info(self) -> dict:
        """Series metadata for an import UI row (reference
        dicom_preview_panel.py consumes the Parser fields collected at
        dicom_reader.py:86-140)."""
        f = self.sorted_files()[len(self.files) // 2]
        return {
            "patient_name": str(f.get("PatientName", "") or ""),
            "patient_id": str(f.get("PatientID", "") or ""),
            "study_description": str(f.get("StudyDescription", "") or ""),
            "series_description": str(f.get("SeriesDescription", "") or ""),
            "series_uid": str(f.get("SeriesInstanceUID", "") or ""),
            "modality": str(f.get("Modality", "") or ""),
            "n_slices": len(self.files),
            "rows": int(f.get("Rows") or 0),
            "columns": int(f.get("Columns") or 0),
            "z_spacing": self.z_spacing(),
            "acquisition_date": str(f.get("AcquisitionDate", "") or ""),
        }

    def thumbnail(self, index: Optional[int] = None, size: int = 64,
                  window: Optional[Tuple[float, float]] = None) -> np.ndarray:
        """Windowed, downscaled (size, size) uint8 preview of one slice
        (reference dicom_reader.py:86 builds a wx bitmap per file via
        imagedata_utils.py:260; here it's a plain array for any UI).

        ``window`` = (ww, wl); defaults to the file's stored WW/WL, else
        the slice min/max.
        """
        files = self.sorted_files()
        f = files[len(files) // 2 if index is None else index]
        img = f.pixel_array().astype(np.float32)
        if img.ndim == 3:  # multiframe: middle frame
            img = img[img.shape[0] // 2]
        slope = float(f.get("RescaleSlope") or 1.0)
        inter = float(f.get("RescaleIntercept") or 0.0)
        img = img * slope + inter
        if window is None:
            ww, wl = f.get("WindowWidth"), f.get("WindowCenter")
            if isinstance(ww, (list, tuple)):
                ww = ww[0]
            if isinstance(wl, (list, tuple)):
                wl = wl[0]
            if not ww:
                lo, hi = float(img.min()), float(img.max())
                ww, wl = max(hi - lo, 1.0), (hi + lo) / 2.0
        else:
            ww, wl = window
        lo = float(wl) - float(ww) / 2.0
        u8 = np.clip((img - lo) / max(float(ww), 1.0) * 255.0, 0, 255)
        # strided decimation (nearest) to <= size in each dim
        sy = max(1, u8.shape[0] // size)
        sx = max(1, u8.shape[1] // size)
        return u8[::sy, ::sx].astype(np.uint8)


def group_dicom_files(files: List[DicomFile]) -> List[DicomGroup]:
    """Group by patient / series / orientation / shape (reference
    DicomPatientGrouper + FixProblem1 split of mixed series)."""
    groups: Dict[tuple, DicomGroup] = {}
    for f in files:
        iop = f.get("ImageOrientationPatient")
        iop_key = tuple(round(x, 3) for x in iop) if iop else None
        key = (
            f.get("PatientID"),
            f.get("StudyInstanceUID"),
            f.get("SeriesInstanceUID"),
            iop_key,
            f.get("Rows"),
            f.get("Columns"),
        )
        groups.setdefault(key, DicomGroup(key=key)).files.append(f)
    return list(groups.values())


def scan_directory(directory, recursive: bool = True) -> Iterator[DicomFile]:
    """Walk a directory yielding parsed DICOM files (reference
    yGetDicomGroups os.walk)."""
    walker = os.walk(directory) if recursive else [(directory, [], os.listdir(directory))]
    for root, _dirs, names in walker:
        for name in sorted(names):
            p = Path(root) / name
            if not p.is_file() or not is_dicom(p):
                continue
            try:
                yield read_dicom(p)
            except DicomError:
                continue


def load_dicom_dir(directory) -> List[DicomGroup]:
    return group_dicom_files(list(scan_directory(directory)))


# ---------------------------------------------------------------------------
# Volume assembly (reference imagedata_utils.dcm2memmap/dcmmf2memmap)
# ---------------------------------------------------------------------------


def group_to_volume(group: DicomGroup, correct_tilt: bool = True,
                    device=DEFAULT_DEVICE):
    """Assemble a group into ((Z, Y, X) int16 tensor on ``device``, spacing
    (sx, sy, sz), affine 4x4); gantry tilt is shear-corrected on ``device``
    when present (reference dcm2memmap applies FixGantryTilt).

    The rescaled slices are written into one host array (the values of the
    JAX package's ``np.stack``, without its second copy), which moves to
    ``device`` once."""
    device = resolve_device(device)
    files = group.sorted_files()
    f0 = files[0]
    frames = int(f0.get("NumberOfFrames", 1) or 1)
    if len(files) == 1 and frames > 1:
        host = files[0].rescaled_slice()
        if host.ndim == 2:
            host = host[None]
    else:
        first = files[0].rescaled_slice()
        host = np.empty((len(files),) + first.shape, first.dtype)
        host[0] = first
        for k, f in enumerate(files[1:], 1):
            host[k] = f.rescaled_slice()
    data = torch.from_numpy(host).to(device)

    tilt = float(f0.get("GantryDetectorTilt") or 0.0)
    if correct_tilt and abs(tilt) > 0.01 and len(data) > 1:
        ps = f0.get("PixelSpacing") or [1.0, 1.0]
        sp = (float(ps[1]), float(ps[0]), group.z_spacing())
        data = fix_gantry_tilt(data, sp, tilt, device=device)

    ps = f0.get("PixelSpacing") or [1.0, 1.0]
    sy, sx = float(ps[0]), float(ps[1])  # PixelSpacing is row\col
    sz = group.z_spacing()
    spacing = (sx, sy, sz)

    affine = np.eye(4)
    iop = f0.get("ImageOrientationPatient")
    ipp = f0.get("ImagePositionPatient")
    if iop and ipp:
        r = np.asarray(iop[:3])
        c = np.asarray(iop[3:])
        normal = np.cross(r, c)
        affine[:3, 0] = r * sx
        affine[:3, 1] = c * sy
        affine[:3, 2] = normal * sz
        affine[:3, 3] = ipp
    else:
        affine = np.diag([sx, sy, sz, 1.0])
    return data, spacing, affine


# ---------------------------------------------------------------------------
# Minimal writer (explicit VR LE) — used for tests and mask/volume export
# ---------------------------------------------------------------------------

_WRITE_VRS = {
    "SOPInstanceUID": "UI", "Modality": "CS", "SeriesDescription": "LO",
    "StudyDate": "DA", "StudyTime": "TM", "PatientName": "PN",
    "PatientID": "LO", "SliceThickness": "DS", "SpacingBetweenSlices": "DS",
    "GantryDetectorTilt": "DS", "StudyInstanceUID": "UI",
    "SeriesInstanceUID": "UI", "SeriesNumber": "IS", "InstanceNumber": "IS",
    "ImagePositionPatient": "DS", "ImageOrientationPatient": "DS",
    "SamplesPerPixel": "US", "PhotometricInterpretation": "CS",
    "NumberOfFrames": "IS", "Rows": "US", "Columns": "US",
    "PixelSpacing": "DS", "BitsAllocated": "US", "BitsStored": "US",
    "PixelRepresentation": "US", "RescaleIntercept": "DS",
    "RescaleSlope": "DS", "WindowCenter": "DS", "WindowWidth": "DS",
}
_TAG_BY_NAME = {v: k for k, v in TAGS.items()}


def _encode_element(group: int, elem: int, vr: str, value) -> bytes:
    if vr == "US":
        payload = struct.pack("<H", int(value))
    elif vr in ("DS", "IS"):
        if isinstance(value, (list, tuple)):
            text = "\\".join(f"{v:g}" if vr == "DS" else str(int(v)) for v in value)
        else:
            text = f"{value:g}" if vr == "DS" else str(int(value))
        payload = text.encode("ascii")
    else:
        payload = str(value).encode("latin-1")
    if len(payload) % 2:
        payload += b"\x00" if vr == "UI" else b" "
    head = struct.pack("<HH2sH", group, elem, vr.encode(), len(payload))
    return head + payload


def write_dicom(path, pixels: "np.ndarray", tags: dict,
                transfer_syntax: str = EXPLICIT_VR_LE) -> None:
    """Write a single-frame int16/uint16/uint8 DICOM.  transfer_syntax may
    be explicit VR LE (raw), RLE Lossless, or JPEG Lossless (encapsulated,
    encoded via io/dicom_codecs)."""
    pixels = np.ascontiguousarray(pixels)
    assert pixels.ndim == 2
    bits = pixels.dtype.itemsize * 8
    all_tags = dict(tags)
    all_tags.setdefault("Rows", pixels.shape[0])
    all_tags.setdefault("Columns", pixels.shape[1])
    all_tags.setdefault("BitsAllocated", bits)
    all_tags.setdefault("BitsStored", bits)
    all_tags.setdefault("PixelRepresentation", 1 if pixels.dtype.kind == "i" else 0)
    all_tags.setdefault("SamplesPerPixel", 1)
    all_tags.setdefault("PhotometricInterpretation", "MONOCHROME2")

    # file meta group (0002): just the transfer syntax + required UIDs
    def meta_el(elem, vr, value):
        payload = str(value).encode("ascii")
        if len(payload) % 2:
            payload += b"\x00"
        return struct.pack("<HH2sH", 0x0002, elem, vr.encode(), len(payload)) + payload

    meta_body = meta_el(0x0010, "UI", transfer_syntax)
    meta_len = struct.pack("<HH2sHI", 0x0002, 0x0000, b"UL", 4, len(meta_body))

    body = b""
    for name in sorted(_TAG_BY_NAME, key=lambda n: _TAG_BY_NAME[n]):
        if name in all_tags and all_tags[name] is not None:
            g, e = _TAG_BY_NAME[name]
            body += _encode_element(g, e, _WRITE_VRS[name], all_tags[name])

    if transfer_syntax == EXPLICIT_VR_LE:
        pix = pixels.tobytes()
        vr = b"OW" if bits == 16 else b"OB"
        body += struct.pack("<HH2sHI", 0x7FE0, 0x0010, vr, 0, len(pix)) + pix
    elif transfer_syntax in codecs.DECODABLE_SYNTAXES:
        if transfer_syntax == codecs.RLE_LOSSLESS:
            frag = codecs.rle_encode_frame(pixels)
        elif transfer_syntax == codecs.JPEG_BASELINE:
            frag = codecs.jpeg_baseline_encode(pixels)
        elif transfer_syntax == codecs.JPEG_EXTENDED:
            from invesalius3_tpu_torch.io import jpeg12

            # .4.51 is a 12-bit unsigned codec: signed or >12-bit values
            # would alias through the uint view and decode clamped to
            # [0, 4095] — corrupt silently.  Demand pre-rescaled data
            # (DICOM RescaleIntercept is the standard way to shift HU).
            precision = min(bits, 12)
            if int(pixels.min()) < 0 or int(pixels.max()) >= (1 << precision):
                raise DicomError(
                    "JPEG Extended (.4.51) stores 12-bit unsigned samples; "
                    f"pixel range [{int(pixels.min())}, {int(pixels.max())}]"
                    " does not fit — rescale into [0, 4095] first (and set "
                    "RescaleIntercept/Slope accordingly)")
            frag = jpeg12.encode(
                np.ascontiguousarray(pixels.astype(np.uint16)),
                precision=precision)
        elif transfer_syntax in (codecs.JPEG_LS_LOSSLESS,
                                 codecs.JPEG_LS_NEAR):
            from invesalius3_tpu_torch.io import jpegls

            near = 2 if transfer_syntax == codecs.JPEG_LS_NEAR else 0
            if near and pixels.dtype in (np.int16, np.int8):
                # near-lossless reconstruction can cross the two's-
                # complement wrap (e.g. int16 32766 -> 32768 -> -32768):
                # the |err|<=NEAR promise would not survive the signed
                # view.  Lossless is exact through the bit pattern.
                raise DicomError(
                    "JPEG-LS near-lossless (.4.81) on signed pixel data "
                    "can wrap at the int16 boundary; use JPEG-LS lossless "
                    "(.4.80) or rescale to unsigned first")
            u = pixels.view(np.uint16) if pixels.dtype == np.int16 else (
                pixels.view(np.uint8) if pixels.dtype == np.int8 else pixels)
            frag = jpegls.encode(np.ascontiguousarray(u), near=near,
                                 maxval=(1 << bits) - 1)
        elif transfer_syntax in (codecs.J2K_LOSSLESS, codecs.J2K):
            u = pixels.view(np.uint16) if pixels.dtype == np.int16 else (
                pixels.view(np.uint8) if pixels.dtype == np.int8 else pixels)
            frag = codecs.j2k_encode(np.ascontiguousarray(u), lossless=True)
        else:
            # JPEG lossless encodes unsigned sample values; signed pixels
            # round-trip through their uint bit pattern
            u = pixels.view(np.uint16) if pixels.dtype == np.int16 else (
                pixels.view(np.uint8) if pixels.dtype == np.int8 else pixels)
            frag = codecs.jpegll_encode(np.ascontiguousarray(u), precision=bits)
        if len(frag) % 2:
            frag += b"\x00"
        body += struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF)
        body += struct.pack("<HHI", 0xFFFE, 0xE000, 0)          # empty BOT
        body += struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag
        body += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)          # seq delimiter
    else:
        raise DicomError(f"write_dicom: unsupported transfer syntax {transfer_syntax}")

    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM")
        f.write(meta_len + meta_body)
        f.write(body)


def fix_gantry_tilt(volume, spacing, tilt_degrees: float,
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """Shear-correct a gantry-tilted acquisition on ``device``: slice n
    shifts by -tan(tilt) * n * sz / sy rows with linear interpolation
    (reference imagedata_utils.py:143-155 FixGantryTilt, scipy.ndimage.shift
    per slice).  ``volume`` is a (Z, Y, X) array or tensor; returns a tensor
    of its dtype on ``device``.

    The JAX package's arithmetic step by step, each step rounded to float32
    as its eager ops round: the offset ``gntan * n * sz / sy``, the floor,
    two clamped row gathers, ``a * (1 - t) + b * t``, ``min(v)`` where the
    source row falls outside the slice, and the cast back by truncation.
    The row index depends on (z, y) only, so each gather picks whole rows
    of X voxels from the (Z * Y, X) view by a (Z * Y,) index."""
    device = resolve_device(device)
    if isinstance(volume, np.ndarray):
        volume = torch.from_numpy(np.array(volume, copy=not volume.flags.writeable))
    v = volume.to(device)
    sx, sy, sz = spacing
    Z, Y, X = v.shape

    def f32(x):  # a 0-d float32 tensor on the device: divisions stay IEEE
        return torch.tensor(x, dtype=torch.float32, device=device)

    gntan = f32(float(np.tan(np.radians(tilt_degrees))))
    n = torch.arange(Z, dtype=torch.float32, device=device)[:, None]
    offset = gntan * n * f32(sz) / f32(sy)  # rows to shift slice n by
    yy = torch.arange(Y, dtype=torch.float32, device=device)[None, :]
    src = yy + offset  # (Z, Y) sample rows
    y0 = torch.floor(src).to(torch.int32)
    t = (src - y0.to(torch.float32))[:, :, None]
    base = torch.arange(Z, device=device)[:, None] * Y
    rows = v.reshape(Z * Y, X)
    a = rows.index_select(0, (base + y0.clamp(0, Y - 1)).reshape(-1))
    b = rows.index_select(0, (base + (y0 + 1).clamp(0, Y - 1)).reshape(-1))
    a = a.view(Z, Y, X).to(torch.float32)
    b = b.view(Z, Y, X).to(torch.float32)
    out = a.mul_(f32(1.0) - t).add_(b.mul_(t))
    del b
    valid = ((src >= 0) & (src <= Y - 1))[:, :, None]
    out = torch.where(valid, out, v.min().to(torch.float32))
    return out.to(v.dtype)

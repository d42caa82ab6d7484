"""NIfTI-1 / NIfTI-2 / Analyze 7.5 reader and NIfTI-1 writer, pure numpy
(the port's copy of invesalius3_tpu/io/nifti.py; the same bytes in give the
same arrays and affine out, and the writer writes the same bytes).

Replaces the reference's nibabel path (reference
invesalius/reader/others_reader.py:29 ``ReadOthers`` ->
imagedata_utils.img2memmap:498, which does ``as_closest_canonical`` +
``get_fdata``).

Supports: .nii, .nii.gz, .hdr/.img pairs (Analyze + NIfTI-1 two-file),
gzip transparently; scl_slope/scl_inter scaling; canonical RAS+
reorientation from the sform/qform like nibabel's as_closest_canonical.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class NiftiImage:
    def __init__(self, data: np.ndarray, affine: np.ndarray, header: dict):
        self.data = data  # (Z, Y, X) canonical RAS+ ordering: data[z, y, x]
        self.affine = affine  # 4x4 voxel (x, y, z index) -> world RAS mm
        self.header = header

    @property
    def spacing(self) -> Tuple[float, float, float]:
        """(sx, sy, sz) mm from the affine column norms."""
        return tuple(float(np.linalg.norm(self.affine[:3, i])) for i in range(3))


def _open_maybe_gz(path: Path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _quaternion_affine(hdr) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    qfac = -1.0 if hdr["pixdim"][0] < 0 else 1.0
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
            [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
            [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
        ]
    )
    sx, sy, sz = hdr["pixdim"][1:4]
    aff = np.eye(4)
    aff[:3, :3] = R @ np.diag([sx, sy, sz * qfac])
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _read_header_nifti1(raw: bytes) -> dict:
    h = {}
    (h["sizeof_hdr"],) = struct.unpack("<i", raw[0:4])
    h["dim"] = struct.unpack("<8h", raw[40:56])
    (h["datatype"],) = struct.unpack("<h", raw[70:72])
    (h["bitpix"],) = struct.unpack("<h", raw[72:74])
    h["pixdim"] = struct.unpack("<8f", raw[76:108])
    (h["vox_offset"],) = struct.unpack("<f", raw[108:112])
    (h["scl_slope"],) = struct.unpack("<f", raw[112:116])
    (h["scl_inter"],) = struct.unpack("<f", raw[116:120])
    (h["qform_code"],) = struct.unpack("<h", raw[252:254])
    (h["sform_code"],) = struct.unpack("<h", raw[254:256])
    (h["quatern_b"],) = struct.unpack("<f", raw[256:260])
    (h["quatern_c"],) = struct.unpack("<f", raw[260:264])
    (h["quatern_d"],) = struct.unpack("<f", raw[264:268])
    (h["qoffset_x"],) = struct.unpack("<f", raw[268:272])
    (h["qoffset_y"],) = struct.unpack("<f", raw[272:276])
    (h["qoffset_z"],) = struct.unpack("<f", raw[276:280])
    h["srow_x"] = struct.unpack("<4f", raw[280:296])
    h["srow_y"] = struct.unpack("<4f", raw[296:312])
    h["srow_z"] = struct.unpack("<4f", raw[312:328])
    h["magic"] = raw[344:348]
    return h


def _read_header_nifti2(raw: bytes) -> dict:
    h = {}
    (h["sizeof_hdr"],) = struct.unpack("<i", raw[0:4])
    h["magic"] = raw[4:12]
    (h["datatype"],) = struct.unpack("<h", raw[12:14])
    (h["bitpix"],) = struct.unpack("<h", raw[14:16])
    h["dim"] = struct.unpack("<8q", raw[16:80])
    h["pixdim"] = struct.unpack("<8d", raw[104:168])
    (h["vox_offset"],) = struct.unpack("<q", raw[168:176])
    (h["scl_slope"],) = struct.unpack("<d", raw[176:184])
    (h["scl_inter"],) = struct.unpack("<d", raw[184:192])
    (h["qform_code"],) = struct.unpack("<i", raw[344:348])
    (h["sform_code"],) = struct.unpack("<i", raw[348:352])
    (h["quatern_b"],) = struct.unpack("<d", raw[352:360])
    (h["quatern_c"],) = struct.unpack("<d", raw[360:368])
    (h["quatern_d"],) = struct.unpack("<d", raw[368:376])
    (h["qoffset_x"],) = struct.unpack("<d", raw[376:384])
    (h["qoffset_y"],) = struct.unpack("<d", raw[384:392])
    (h["qoffset_z"],) = struct.unpack("<d", raw[392:400])
    h["srow_x"] = struct.unpack("<4d", raw[400:432])
    h["srow_y"] = struct.unpack("<4d", raw[432:464])
    h["srow_z"] = struct.unpack("<4d", raw[464:496])
    return h


def read_nifti(path, keep_4d: bool = False) -> NiftiImage:
    """Read a NIfTI-1/2 or Analyze volume into canonical RAS+ (Z, Y, X).

    With ``keep_4d`` a 4-D file (FOD spherical harmonics, direction
    fields, fMRI series) returns (Z, Y, X, C) in file-native orientation
    instead of the first component volume."""
    path = Path(path)
    img_path: Optional[Path] = None
    name = path.name
    if ".hdr" in name or ".img" in name:
        hdr_path = path.with_name(name.replace(".img", ".hdr"))
        img_path = path.with_name(name.replace(".hdr", ".img"))
    else:
        hdr_path = path

    with _open_maybe_gz(hdr_path) as f:
        raw = f.read(4 if img_path else 548)
        if len(raw) < 4:
            raise ValueError(f"{path}: truncated header")
        (size,) = struct.unpack("<i", raw[:4])
        swapped = False
        if size not in (348, 540):
            (size_be,) = struct.unpack(">i", raw[:4])
            if size_be in (348, 540):
                raise ValueError("big-endian NIfTI not supported yet")
            raise ValueError(f"{path}: not a NIfTI/Analyze file (sizeof_hdr={size})")
        if img_path:
            raw += f.read(548 - len(raw))
        while len(raw) < (540 if size == 540 else 348):
            chunk = f.read(548 - len(raw))
            if not chunk:
                break
            raw += chunk
        hdr = _read_header_nifti2(raw) if size == 540 else _read_header_nifti1(raw)

        ndim = hdr["dim"][0]
        shape_xyz = tuple(int(d) for d in hdr["dim"][1 : 1 + max(ndim, 3)])[:3]
        dtype = _DTYPES.get(hdr["datatype"])
        if dtype is None:
            raise ValueError(f"unsupported NIfTI datatype code {hdr['datatype']}")
        n_vox = int(np.prod(shape_xyz))
        nt = int(hdr["dim"][4]) if ndim >= 4 else 1
        want4d = keep_4d and nt > 1
        n_read = n_vox * (nt if want4d else 1)

        is_onefile = hdr.get("magic", b"")[:3] in (b"n+1", b"n+2")
        if is_onefile and img_path is None:
            f.seek(int(hdr["vox_offset"]))
            buf = f.read(n_read * np.dtype(dtype).itemsize)
        else:
            buf = None

    if buf is None:
        # two-file (.hdr/.img) or Analyze
        ipath = img_path or path.with_suffix(".img")
        with _open_maybe_gz(ipath) as f:
            f.seek(int(hdr.get("vox_offset", 0)))
            buf = f.read(n_read * np.dtype(dtype).itemsize)

    data = np.frombuffer(buf, dtype=dtype, count=n_read)
    # NIfTI stores x fastest: data[x, y, z(, t)] in Fortran order
    if want4d:
        # (Z, Y, X, C) component-last; kept in FILE-NATIVE orientation (no
        # canonical reorientation — consumers like the tractography fields
        # map world->voxel with this same file's affine, so orientation is
        # self-consistent)
        data = np.moveaxis(data.reshape((nt,) + shape_xyz[::-1]), 0, -1)
    else:
        data = data.reshape(shape_xyz[::-1])  # now (z, y, x)

    # affine: prefer sform, then qform, then pixdim scaling
    if hdr.get("sform_code", 0) > 0:
        affine = np.vstack([hdr["srow_x"], hdr["srow_y"], hdr["srow_z"], [0, 0, 0, 1]])
    elif hdr.get("qform_code", 0) > 0:
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag(list(hdr["pixdim"][1:4]) + [1.0])

    slope = hdr.get("scl_slope", 0.0) or 0.0
    inter = hdr.get("scl_inter", 0.0) or 0.0
    if slope not in (0.0, 1.0) or inter != 0.0:
        s = slope if slope != 0.0 else 1.0
        data = data.astype(np.float32) * s + inter

    if not want4d:
        data, affine = _to_closest_canonical(data,
                                             np.asarray(affine, np.float64))
    return NiftiImage(np.ascontiguousarray(data),
                      np.asarray(affine, np.float64), hdr)


def _to_closest_canonical(data_zyx: np.ndarray, affine: np.ndarray):
    """Reorient so the affine is closest to diagonal-positive RAS
    (nibabel.as_closest_canonical semantics, used by the reference's
    img2memmap)."""
    R = affine[:3, :3]
    # ornt: for each voxel axis (x, y, z storage order), the world axis it
    # maps to and the sign
    perm = []
    flips = []
    used = set()
    for vox_ax in range(3):
        col = R[:, vox_ax]
        order = np.argsort(-np.abs(col))
        world_ax = next(int(a) for a in order if int(a) not in used)
        used.add(world_ax)
        perm.append(world_ax)
        flips.append(col[world_ax] < 0)

    # build new affine/data: we want voxel axis i to map to world axis i
    # with positive direction
    data = data_zyx
    aff = affine.copy()
    # data_zyx axes: 0=z(vox z), 1=y, 2=x -> voxel axis = 2 - array axis
    for vox_ax in range(3):
        if flips[vox_ax]:
            arr_ax = 2 - vox_ax
            data = np.flip(data, axis=arr_ax)
            n = data.shape[arr_ax]
            # origin_new = origin_old + col_old * (n - 1); col_new = -col_old
            aff[:3, 3] += aff[:3, vox_ax] * (n - 1)
            aff[:3, vox_ax] = -aff[:3, vox_ax]
    # permute voxel axes so perm becomes identity
    inv = np.argsort(perm)
    if list(inv) != [0, 1, 2]:
        arr_axes = [2 - inv[2], 2 - inv[1], 2 - inv[0]]
        data = np.transpose(data, arr_axes)
        aff3 = aff[:3, [inv[0], inv[1], inv[2]]]
        aff = np.vstack([np.column_stack([aff3, aff[:3, 3]]), [0, 0, 0, 1]])
    return data, aff


def write_nifti(path, data_zyx: np.ndarray, affine: Optional[np.ndarray] = None,
                spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> None:
    """Write a NIfTI-1 single file (.nii / .nii.gz by extension)."""
    data = np.ascontiguousarray(data_zyx)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]
    if affine is None:
        sx, sy, sz = spacing
        affine = np.diag([sx, sy, sz, 1.0])

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    if data.ndim == 4:  # (Z, Y, X, C) -> 4-D file, component slowest
        nt = data.shape[3]
        dims = (data.shape[2], data.shape[1], data.shape[0])
        data = np.ascontiguousarray(np.moveaxis(data, -1, 0))
    else:
        nt = 1
        dims = data.shape[::-1]  # (x, y, z)
    struct.pack_into("<8h", hdr, 40, 4 if nt > 1 else 3,
                     dims[0], dims[1], dims[2], nt, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    sx = float(np.linalg.norm(affine[:3, 0]))
    sy = float(np.linalg.norm(affine[:3, 1]))
    sz = float(np.linalg.norm(affine[:3, 2]))
    struct.pack_into("<8f", hdr, 76, 1.0, sx, sy, sz, 0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + data.tobytes()
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)

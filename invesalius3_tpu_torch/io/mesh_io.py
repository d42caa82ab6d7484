"""Mesh file I/O (port of invesalius3_tpu/io/mesh_io.py): STL (binary and
ASCII), PLY (binary and ASCII), OBJ, VTP (VTK XML PolyData), X3D, 3MF,
VRML, OpenInventor and the neuronavigation ``.bin``; the ``WRITERS`` /
``READERS`` tables; and the binary STL of a device mesh.

Every writer takes host (vertices (V, 3), faces (F, 3)) in world mm and
writes the JAX package's bytes for the same arrays: the binary STL records
are packed by the port's native packer (``csrc/meshpack.cpp``, the JAX
package's arithmetic), the text formats by the same format strings.

``write_stl_from_device`` streams a device mesh to the file: its face
table comes to the host in int32 chunks on a background thread
(``DeviceFaceStream``, which a caller may start right after marching so the
copy overlaps smoothing), its vertices, rounded through float16 on the
device as the JAX package's packed transfer does, on another, while the
calling thread packs and writes records.  ``write_stl_sharded`` does the
same for the shards of ``parallel.sharded_ops.sharded_mask_to_surface``.
Both write the bytes ``write_stl`` writes for the assembled mesh.
"""

from __future__ import annotations

import os
import queue
import struct
import threading
import zipfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch import _build
from invesalius3_tpu_torch.ops import marching

# ---------------------------------------------------------------------------
# STL
# ---------------------------------------------------------------------------


def stl_records(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(F, 50)-byte binary-STL records (normal, 3 corners, attribute 0)."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    out = np.empty((len(faces), 50), np.uint8)
    rc = _build.meshpack_lib().stl_pack_mt(
        verts.ctypes.data, len(verts), faces.ctypes.data, len(faces),
        out.ctypes.data, min(os.cpu_count() or 1, 16))
    if rc != 0:
        raise RuntimeError("stl_pack: face index out of range")
    return out


def _stl_header(name: str, n_faces: int) -> bytes:
    return (name.encode()[:80]).ljust(80, b"\0") + struct.pack("<I", n_faces)


def _tri_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(p1 - p0, p2 - p0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.where(norm == 0, 1.0, norm)).astype(np.float32)


def write_stl(path, verts: np.ndarray, faces: np.ndarray, binary: bool = True,
              name: str = "invesalius3_tpu") -> None:
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    if binary:
        with open(path, "wb") as f:
            f.write(_stl_header(name, len(faces)))
            f.write(stl_records(verts, faces))
        return
    normals = _tri_normals(verts, faces)
    with open(path, "w") as f:
        f.write(f"solid {name}\n")
        tv = verts[faces]
        for n, (a, b, c) in zip(normals, tv):
            f.write(f" facet normal {n[0]:e} {n[1]:e} {n[2]:e}\n  outer loop\n")
            f.write(f"   vertex {a[0]:e} {a[1]:e} {a[2]:e}\n")
            f.write(f"   vertex {b[0]:e} {b[1]:e} {b[2]:e}\n")
            f.write(f"   vertex {c[0]:e} {c[1]:e} {c[2]:e}\n")
            f.write("  endloop\n endfacet\n")
        f.write(f"endsolid {name}\n")


def chunk_max(faces3t: torch.Tensor, chunk: int) -> torch.Tensor:
    """Per face chunk the largest vertex id it references, (K,) on the
    faces' device: the vertices a streamed STL chunk waits for."""
    T = int(faces3t.shape[1])
    K = -(-T // chunk)
    pad = K * chunk - T
    if pad:
        faces3t = torch.cat([faces3t, faces3t.new_zeros((3, pad))], dim=1)
    return faces3t.reshape(3, K, chunk).amax(dim=(0, 2))


class DeviceFaceStream:
    """Background device-to-host copy of a device mesh's face table in
    (n, 3) int32 chunks.

    Marching fixes the faces; smoothing only moves vertices.  Start the
    stream right after marching: on a card it copies on a side stream,
    after an event recorded on the current stream, into pinned buffers, so
    the transfer runs while the card smooths.  ``write_stl_from_device``
    takes it and consumes the chunks in order."""

    def __init__(self, dm, chunk: int = 1 << 20):
        faces = dm.faces3t
        self.n_tris = int(faces.shape[1])
        self.chunk = max(1, min(int(chunk), self.n_tris))
        ready = None
        if faces.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(faces.device))
        self._q: queue.Queue = queue.Queue()
        self._th = threading.Thread(target=self._run, args=(faces, ready),
                                    daemon=True, name="face-stream")
        self._th.start()

    def _chunks(self, faces: torch.Tensor):
        """(n, 3) int32 chunks, transposed on the faces' device."""
        for i in range(0, self.n_tris, self.chunk):
            n = min(self.chunk, self.n_tris - i)
            yield n, faces[:, i:i + n].t().to(torch.int32).contiguous()

    def _run(self, faces: torch.Tensor, ready) -> None:
        try:
            if ready is None:
                for n, part in self._chunks(faces):
                    self._q.put((part.numpy(), n))
            else:
                with torch.cuda.device(faces.device):
                    side = torch.cuda.Stream()
                    side.wait_event(ready)
                    with torch.cuda.stream(side):
                        for n, part in self._chunks(faces):
                            host = torch.empty((n, 3), dtype=torch.int32, pin_memory=True)
                            host.copy_(part, non_blocking=True)
                            side.synchronize()
                            self._q.put((host.numpy(), n))
            self._q.put(None)
        except Exception as e:  # raised again on the consumer's thread
            self._q.put(e)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                self._th.join()
                return
            if isinstance(item, Exception):
                self._th.join()
                raise item
            yield item


class _Filled:
    """Rows of a host vertex array that a producer thread has filled; the
    writer waits until the rows a face chunk references are there."""

    def __init__(self, verts: np.ndarray):
        self.verts = verts
        self.rows = 0
        self.done = False
        self.error = None
        self.cond = threading.Condition()

    def run(self, pieces) -> threading.Thread:
        """Fill from ``pieces``, an iterable of (start row, (n, 3) array),
        on a background thread."""

        def fill():
            try:
                for a, rows in pieces:
                    self.verts[a:a + len(rows)] = rows
                    with self.cond:
                        self.rows = a + len(rows)
                        self.cond.notify_all()
            except Exception as e:  # raised again on the writer's thread
                self.error = e
            finally:
                with self.cond:
                    self.done = True
                    self.cond.notify_all()

        th = threading.Thread(target=fill, daemon=True, name="verts-stream")
        th.start()
        return th

    def wait(self, need: int) -> None:
        """Until ``need`` rows are filled or the producer has stopped."""
        with self.cond:
            while self.rows < need and not self.done:
                self.cond.wait(timeout=1.0)
        if self.error is not None:
            raise self.error


def write_stl_from_device(path, dm, name: str = "invesalius3_tpu",
                          face_stream: "DeviceFaceStream | None" = None) -> None:
    """Write a ``marching.DeviceMesh`` as a binary STL: the face chunks of
    ``face_stream`` (started here if None) and the float16-rounded vertices
    come to the host on background threads; each chunk is packed and
    written once the vertices it references are there."""
    if face_stream is None:
        face_stream = DeviceFaceStream(dm)
    V = dm.n_verts
    # rounded through float16 and laid out (V, 3) on the device
    rows = dm.verts3v.to(torch.float16).to(torch.float32).t().contiguous()
    step = max(1, -(-V // 8))
    filled = _Filled(np.empty((V, 3), np.float32))
    bound = (chunk_max(dm.faces3t, face_stream.chunk).cpu().numpy()
             if face_stream.n_tris else np.zeros(0, np.int64))

    def pieces():
        for a in range(0, V, step):
            yield a, rows[a:a + step].cpu().numpy()

    th = filled.run(pieces())
    try:
        with open(path, "wb") as f:
            f.write(_stl_header(name, face_stream.n_tris))
            for k, (faces, _) in enumerate(face_stream):
                filled.wait(int(bound[k]) + 1)
                f.write(stl_records(filled.verts, faces))
    finally:
        th.join()
    filled.wait(V)


def write_stl_sharded(path, verts_sh: List[Optional[torch.Tensor]],
                      faces_sh: List[Optional[torch.Tensor]], name: str = "invesalius3_tpu",
                      shards=None) -> None:
    """Write the parts of ``sharded_mask_to_surface(return_parts=True)``
    (each shard's (3, n_own) world vertices and (3, n_tri) global faces) as
    a binary STL: a producer thread copies the shards' vertices to the host
    in shard order (global key order) while this thread packs and writes
    each shard's records once the vertices they reference are there (a
    cut's triangles reach into the next shard's).  The bytes of ``write_stl``
    of the assembled mesh.

    With ``shards``, a mesh across processes (its shards held elsewhere are
    None here), every rank sends its parts' host world vertices and wound
    faces to rank 0, lengths first, and returns; rank 0 writes the same
    bytes."""
    from invesalius3_tpu_torch.parallel.sharded_ops import (shard_wound_faces,
                                                            shard_world_verts)

    if shards is not None and shards.multiprocess:
        from invesalius3_tpu_torch.parallel.sharded_ops import gather_parts_to_rank0

        got = gather_parts_to_rank0(shards, verts_sh, faces_sh)
        if got is None:
            return
        verts_sh, faces_sh = got
    elif any(v is None for v in verts_sh):
        raise ValueError("parts held by other processes: pass their mesh as shards=")
    sizes = [int(v.shape[1]) for v in verts_sh]
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    filled = _Filled(np.empty((starts[-1], 3), np.float32))
    th = filled.run((starts[s], shard_world_verts(v)) for s, v in enumerate(verts_sh))
    try:
        with open(path, "wb") as f:
            f.write(_stl_header(name, sum(int(x.shape[1]) for x in faces_sh)))
            for faces_dev in faces_sh:
                faces = shard_wound_faces(faces_dev)
                if len(faces):
                    filled.wait(int(faces.max()) + 1)
                    f.write(stl_records(filled.verts, faces))
    finally:
        th.join()
    filled.wait(starts[-1])


def read_stl(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read an STL (binary or ASCII, detected); returns deduplicated
    (verts, faces)."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        # could still be binary with a 'solid' header; try ascii first
        try:
            return _read_stl_ascii(path)
        except ValueError:
            pass
    return _read_stl_binary(path)


def _read_stl_binary(path) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        f.seek(80)
        (n,) = struct.unpack("<I", f.read(4))
        dt = np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")])
        tri = np.frombuffer(f.read(n * dt.itemsize), dtype=dt)
    flat = tri["v"].reshape(-1, 3)
    verts, inverse = np.unique(flat, axis=0, return_inverse=True)
    return verts.astype(np.float32), inverse.reshape(-1, 3).astype(np.int32)


def _read_stl_ascii(path) -> Tuple[np.ndarray, np.ndarray]:
    pts = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            ls = line.strip()
            if ls.startswith("vertex"):
                parts = ls.split()
                pts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if not pts or len(pts) % 3:
        raise ValueError("not a valid ascii STL")
    flat = np.asarray(pts, np.float32)
    verts, inverse = np.unique(flat, axis=0, return_inverse=True)
    return verts, inverse.reshape(-1, 3).astype(np.int32)


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_FACE = np.dtype([("n", "u1"), ("v", "<i4", 3)])


def write_ply(path, verts: np.ndarray, faces: np.ndarray, binary: bool = True) -> None:
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        "comment created by invesalius3_tpu\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    if binary:
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(verts.astype("<f4").tobytes())
            rec = np.zeros(len(faces), dtype=_PLY_FACE)
            rec["n"] = 3
            rec["v"] = faces
            f.write(rec.tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
            for t in faces:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def read_ply(path) -> Tuple[np.ndarray, np.ndarray]:
    data = Path(path).read_bytes()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii", errors="replace")
    body = data[head_end:]
    n_verts = n_faces = 0
    for line in header.splitlines():
        if line.startswith("element vertex"):
            n_verts = int(line.split()[-1])
        elif line.startswith("element face"):
            n_faces = int(line.split()[-1])
    if "binary_little_endian" in header:
        verts = np.frombuffer(body, "<f4", n_verts * 3).reshape(-1, 3).copy()
        rec = np.frombuffer(body, _PLY_FACE, n_faces, offset=n_verts * 12)
        faces = rec["v"].copy()
    else:
        lines = body.decode().splitlines()
        verts = np.array([[float(x) for x in ln.split()[:3]]
                          for ln in lines[:n_verts]], np.float32)
        faces = np.array([[int(x) for x in ln.split()[1:4]]
                          for ln in lines[n_verts:n_verts + n_faces]], np.int32)
    return verts.astype(np.float32), faces.astype(np.int32)


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------


def write_obj(path, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("# created by invesalius3_tpu\n")
        for v in np.asarray(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in np.asarray(faces):
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def read_obj(path) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for i in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


# ---------------------------------------------------------------------------
# VTP (VTK XML PolyData): written as ascii; read in every mode the
# reference's vtkXMLPolyDataWriter emits
# ---------------------------------------------------------------------------


def vtp_text(verts: np.ndarray, faces: np.ndarray) -> str:
    """The ascii VTP document ``write_vtp`` writes (the .inv3 surface
    members hold these bytes)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    connectivity = " ".join(map(str, faces.ravel()))
    offsets = " ".join(map(str, (np.arange(1, len(faces) + 1) * 3)))
    points = " ".join(f"{x:g}" for x in verts.ravel())
    return (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="PolyData" version="0.1" byte_order="LittleEndian">\n'
        " <PolyData>\n"
        f'  <Piece NumberOfPoints="{len(verts)}" NumberOfVerts="0" '
        f'NumberOfLines="0" NumberOfStrips="0" NumberOfPolys="{len(faces)}">\n'
        "   <Points>\n"
        f'    <DataArray type="Float32" NumberOfComponents="3" format="ascii">{points}</DataArray>\n'
        "   </Points>\n"
        "   <Polys>\n"
        f'    <DataArray type="Int64" Name="connectivity" format="ascii">{connectivity}</DataArray>\n'
        f'    <DataArray type="Int64" Name="offsets" format="ascii">{offsets}</DataArray>\n'
        "   </Polys>\n"
        "  </Piece>\n"
        " </PolyData>\n"
        "</VTKFile>\n"
    )


def write_vtp(path, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(vtp_text(verts, faces))


_VTK_XML_DTYPES = {
    "Float32": np.float32, "Float64": np.float64,
    "Int8": np.int8, "UInt8": np.uint8, "Int16": np.int16,
    "UInt16": np.uint16, "Int32": np.int32, "UInt32": np.uint32,
    "Int64": np.int64, "UInt64": np.uint64,
}


def _vtk_b64_read(b64: str, header_dtype, compressed: bool) -> bytes:
    """Decode one VTK XML base64 payload (inline ``format="binary"`` or one
    appended-data slice).  Uncompressed: base64(header || data), the header
    one byte count.  Compressed (vtkZLibDataCompressor): the header
    ``[n_blocks, block_size, last_block_size, z_size_0..]`` is base64-coded
    apart from the zlib blocks, so it decodes in two passes (the block
    count is known only after the first integer)."""
    import base64
    import zlib

    hsize = np.dtype(header_dtype).itemsize
    if not compressed:
        raw = base64.b64decode(b64 + "===")
        n = int(np.frombuffer(raw[:hsize], header_dtype)[0])
        return raw[hsize:hsize + n]
    first = base64.b64decode(b64[: -(-hsize // 3) * 4])
    n_blocks = int(np.frombuffer(first[:hsize], header_dtype)[0])
    header_len = (3 + n_blocks) * hsize
    b64_header_chars = -(-header_len // 3) * 4  # ceil to base64 quantum
    header = np.frombuffer(
        base64.b64decode(b64[:b64_header_chars] + "==="), header_dtype)
    data = base64.b64decode(b64[b64_header_chars:] + "===")
    out = []
    pos = 0
    for zsize in header[3:3 + n_blocks]:
        out.append(zlib.decompress(data[pos:pos + int(zsize)]))
        pos += int(zsize)
    return b"".join(out)


def _vtk_raw_appended(buf: bytes, offset: int, header_dtype,
                      compressed: bool) -> bytes:
    import zlib

    hsize = np.dtype(header_dtype).itemsize
    if not compressed:
        n = int(np.frombuffer(buf[offset:offset + hsize], header_dtype)[0])
        return buf[offset + hsize:offset + hsize + n]
    head = np.frombuffer(buf[offset:offset + 3 * hsize], header_dtype)
    n_blocks = int(head[0])
    header = np.frombuffer(buf[offset:offset + (3 + n_blocks) * hsize],
                           header_dtype)
    pos = offset + (3 + n_blocks) * hsize
    out = []
    for zsize in header[3:3 + n_blocks]:
        out.append(zlib.decompress(buf[pos:pos + int(zsize)]))
        pos += int(zsize)
    return b"".join(out)


def read_vtp_bytes(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """(verts, faces) of a VTK XML PolyData document: inline ascii, inline
    base64 ``format="binary"`` and ``format="appended"`` (base64 or raw),
    with optional vtkZLibDataCompressor blocks and UInt32/UInt64 headers."""
    import re
    import xml.etree.ElementTree as ET

    # the <AppendedData encoding="raw"> body is not valid XML: split it off
    appended_raw = None
    m = re.search(br'<AppendedData\s+encoding="raw"\s*>', data)
    if m:
        body_start = data.index(b"_", m.end()) + 1
        end = data.rindex(b"</AppendedData>")
        appended_raw = data[body_start:end]
        data = data[:m.start()] + b"</VTKFile>"
    root = ET.fromstring(data.decode("utf-8", errors="replace"))
    header_dtype = _VTK_XML_DTYPES[root.get("header_type", "UInt32")]
    compressed = root.get("compressor", "") == "vtkZLibDataCompressor"
    appended_b64 = None
    app = root.find("AppendedData")
    if app is not None and app.get("encoding", "base64") == "base64":
        appended_b64 = "".join(app.itertext()).strip().lstrip("_")

    def decode_array(da) -> np.ndarray:
        dtype = _VTK_XML_DTYPES[da.get("type")]
        fmt = da.get("format", "ascii")
        if fmt == "ascii":
            return np.array("".join(da.itertext()).split(), dtype=dtype)
        if fmt == "binary":
            raw = _vtk_b64_read("".join(da.itertext()).strip(),
                                header_dtype, compressed)
        elif fmt == "appended":
            off = int(da.get("offset", 0))
            if appended_raw is not None:
                raw = _vtk_raw_appended(appended_raw, off, header_dtype,
                                        compressed)
            elif appended_b64 is not None:
                raw = _vtk_b64_read(appended_b64[off:], header_dtype,
                                    compressed)
            else:
                raise ValueError("appended DataArray without AppendedData")
        else:
            raise ValueError(f"unknown DataArray format {fmt!r}")
        return np.frombuffer(raw, dtype)

    piece = root.find(".//Piece")
    verts = decode_array(piece.find("./Points/DataArray")).astype(
        np.float32).reshape(-1, 3)
    conn = None
    for da in piece.find("./Polys"):
        if da.get("Name") == "connectivity":
            conn = decode_array(da)
    return verts, conn.reshape(-1, 3).astype(np.int32)


def read_vtp(path) -> Tuple[np.ndarray, np.ndarray]:
    return read_vtp_bytes(Path(path).read_bytes())


# ---------------------------------------------------------------------------
# X3D, 3MF, VRML, OpenInventor
# ---------------------------------------------------------------------------


def write_x3d(path, verts: np.ndarray, faces: np.ndarray) -> None:
    """Minimal X3D IndexedFaceSet."""
    coord_index = " ".join(f"{a} {b} {c} -1" for a, b, c in np.asarray(faces))
    points = " ".join(f"{x:g}" for x in np.asarray(verts).ravel())
    with open(path, "w") as f:
        f.write(
            '<?xml version="1.0" encoding="UTF-8"?>\n'
            '<X3D profile="Interchange" version="3.2">\n <Scene>\n  <Shape>\n'
            f'   <IndexedFaceSet coordIndex="{coord_index}">\n'
            f'    <Coordinate point="{points}"/>\n'
            "   </IndexedFaceSet>\n  </Shape>\n </Scene>\n</X3D>\n"
        )


def write_3mf(path, verts: np.ndarray, faces: np.ndarray, name: str = "Surface") -> None:
    """Single-object 3MF model in its zip container (3MF core spec)."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    vtx_xml = "".join(f'<vertex x="{v[0]:g}" y="{v[1]:g}" z="{v[2]:g}"/>' for v in verts)
    tri_xml = "".join(f'<triangle v1="{t[0]}" v2="{t[1]}" v3="{t[2]}"/>' for t in faces)
    model = (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<model unit="millimeter" xml:lang="en-US" '
        'xmlns="http://schemas.microsoft.com/3dmanufacturing/core/2015/02">\n'
        " <resources>\n"
        f'  <object id="1" type="model" name="{name}">\n'
        f"   <mesh><vertices>{vtx_xml}</vertices><triangles>{tri_xml}</triangles></mesh>\n"
        "  </object>\n </resources>\n"
        ' <build><item objectid="1"/></build>\n'
        "</model>\n"
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">\n'
        ' <Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>\n'
        ' <Default Extension="model" ContentType="application/vnd.ms-package.3dmanufacturing-3dmodel+xml"/>\n'
        "</Types>\n"
    )
    rels = (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">\n'
        ' <Relationship Target="/3D/3dmodel.model" Id="rel0" '
        'Type="http://schemas.microsoft.com/3dmanufacturing/2013/01/3dmodel"/>\n'
        "</Relationships>\n"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", rels)
        z.writestr("3D/3dmodel.model", model)


def read_3mf(path) -> Tuple[np.ndarray, np.ndarray]:
    import xml.etree.ElementTree as ET

    with zipfile.ZipFile(path) as z:
        model_name = next(n for n in z.namelist() if n.endswith(".model"))
        root = ET.fromstring(z.read(model_name))
    ns = root.tag.split("}")[0][1:]
    verts = [[float(v.get("x")), float(v.get("y")), float(v.get("z"))]
             for v in root.iter(f"{{{ns}}}vertex")]
    faces = [[int(t.get("v1")), int(t.get("v2")), int(t.get("v3"))]
             for t in root.iter(f"{{{ns}}}triangle")]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _write_indexed(path, verts, faces, head: str, mid: str, tail: str,
                   face_fmt: str) -> None:
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    with open(path, "w") as fh:
        fh.write(head)
        np.savetxt(fh, v, fmt="%.6g %.6g %.6g,")
        fh.write(mid)
        np.savetxt(fh, np.column_stack([f, np.full(len(f), -1, np.int64)]),
                   fmt=face_fmt)
        fh.write(tail)


def write_vrml(path, verts: np.ndarray, faces: np.ndarray) -> None:
    """VRML 2.0 (utf8) IndexedFaceSet (reference export via vtkVRMLExporter)."""
    _write_indexed(path, verts, faces,
                   "#VRML V2.0 utf8\n# written by invesalius3_tpu\n"
                   "Shape {\n geometry IndexedFaceSet {\n  coord Coordinate { point [\n",
                   "  ] }\n  coordIndex [\n", "  ]\n }\n}\n", "%d %d %d %d,")


def read_vrml(path) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal VRML 2.0 IndexedFaceSet reader (point and coordIndex blocks,
    triangles only)."""
    text = Path(path).read_text()

    def block(after: str) -> str:
        start = text.index(after) + len(after)
        start = text.index("[", start) + 1
        return text[start:text.index("]", start)]

    pts = np.array(block("point").replace(",", " ").split(), np.float64)
    idx = np.array(block("coordIndex").replace(",", " ").split(), np.float64)
    verts = pts.reshape(-1, 3).astype(np.float32)
    faces = idx.astype(np.int64).reshape(-1, 4)[:, :3].astype(np.int32)
    return verts, faces


def write_iv(path, verts: np.ndarray, faces: np.ndarray) -> None:
    """OpenInventor 2.x ascii IndexedFaceSet (reference export via
    vtkIVExporter)."""
    _write_indexed(path, verts, faces,
                   "#Inventor V2.1 ascii\n\nSeparator {\n Coordinate3 { point [\n",
                   " ] }\n IndexedFaceSet { coordIndex [\n", " ] }\n}\n",
                   "%d, %d, %d, %d,")


# ---------------------------------------------------------------------------
# The neuronavigation ".bin" (reference converters.py:206): int32[3] header
# (?, n_points, n_triangles), float32 points in meters, int32 triangles
# ---------------------------------------------------------------------------


def read_neuronav_bin(path) -> Tuple[np.ndarray, np.ndarray]:
    numbers = np.fromfile(path, count=3, dtype=np.int32)
    points = np.fromfile(path, dtype=np.float32)
    elements = np.fromfile(path, dtype=np.int32)
    n_pts, n_tris = int(numbers[1]), int(numbers[2])
    verts = (points[3:n_pts * 3 + 3] * 1000.0).reshape(n_pts, 3)
    faces = elements[n_pts * 3 + 3:].reshape(n_tris, 3)
    return verts.astype(np.float32), faces.astype(np.int32)


def write_neuronav_bin(path, verts: np.ndarray, faces: np.ndarray) -> None:
    verts = np.asarray(verts, np.float32) / 1000.0  # mm -> meters
    faces = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        np.asarray([0, len(verts), len(faces)], np.int32).tofile(f)
        verts.astype(np.float32).tofile(f)
        faces.tofile(f)


# ---------------------------------------------------------------------------
# Dispatch (the reference's export filetype table, surface.py:1647+)
# ---------------------------------------------------------------------------

WRITERS = {
    ".stl": write_stl,
    ".ply": write_ply,
    ".obj": write_obj,
    ".vtp": write_vtp,
    ".x3d": write_x3d,
    ".3mf": write_3mf,
    ".wrl": write_vrml,
    ".vrml": write_vrml,
    ".iv": write_iv,
    ".bin": write_neuronav_bin,
}

READERS = {
    ".stl": read_stl,
    ".ply": read_ply,
    ".obj": read_obj,
    ".vtp": read_vtp,
    ".3mf": read_3mf,
    ".wrl": read_vrml,
    ".vrml": read_vrml,
    ".bin": read_neuronav_bin,
}


def export_surface(path, verts: np.ndarray, faces: np.ndarray, **kw) -> None:
    ext = Path(path).suffix.lower()
    if ext not in WRITERS:
        raise ValueError(f"unsupported mesh format: {ext}")
    WRITERS[ext](path, verts, faces, **kw)


def import_surface(path) -> Tuple[np.ndarray, np.ndarray]:
    ext = Path(path).suffix.lower()
    if ext not in READERS:
        raise ValueError(f"unsupported mesh format: {ext}")
    return READERS[ext](path)

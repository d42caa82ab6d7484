"""The port's mesh formats (``io/mesh_io.py``) against the JAX package's.

Every writer writes the JAX writer's bytes for the same arrays (3MF, a zip
whose entries carry the time they were written, member by member), and each
package reads the other's files into the same arrays.  The VTP reader is
also held on the encodings the reference's VTK writer emits: inline base64
with and without zlib blocks, appended base64, and raw appended data with
UInt64 headers.
"""

import base64
import struct
import zipfile
import zlib

import numpy as np
import pytest

from invesalius3_tpu.io import mesh_io as mesh_io_jax
from invesalius3_tpu_torch.io import mesh_io
from tests.fixtures.gen_fixtures import (write_vtp_appended_raw,
                                         write_vtp_binary_compressed)


def _mesh():
    """A closed octahedron-like mesh subdivided once, its vertices moved by
    seeded noise so that the text formats print many digits."""
    v = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0],
                  [0, 0, -1]], np.float32) * 11.5
    f = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1],
                  [5, 2, 1], [5, 3, 2], [5, 4, 3], [5, 1, 4]], np.int32)
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    uniq, inv = np.unique(e[:, 0] * 6 + e[:, 1], return_inverse=True)
    mids = (v[uniq // 6] + v[uniq % 6]) * 0.5
    m = inv.reshape(3, -1).T + 6
    f = np.concatenate([np.stack([f[:, 0], m[:, 0], m[:, 2]], 1),
                        np.stack([m[:, 0], f[:, 1], m[:, 1]], 1),
                        np.stack([m[:, 2], m[:, 1], f[:, 2]], 1), m]).astype(np.int32)
    v = np.concatenate([v, mids])
    v = v + np.random.default_rng(5).normal(0, 0.37, v.shape).astype(np.float32)
    return v.astype(np.float32), f


WRITE_CASES = {  # case -> (extension, writer kwargs)
    "stl": (".stl", {}), "stl_ascii": (".stl", {"binary": False}),
    "ply": (".ply", {}), "ply_ascii": (".ply", {"binary": False}),
    "obj": (".obj", {}), "vtp": (".vtp", {}), "x3d": (".x3d", {}),
    "3mf": (".3mf", {}), "wrl": (".wrl", {}), "vrml": (".vrml", {}),
    "iv": (".iv", {}), "bin": (".bin", {}),
}


def _zip_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_writers_write_the_jax_bytes(tmp_path, case):
    ext, kw = WRITE_CASES[case]
    v, f = _mesh()
    got, want = tmp_path / f"port{ext}", tmp_path / f"jax{ext}"
    mesh_io.export_surface(got, v, f, **kw)
    mesh_io_jax.export_surface(want, v, f, **kw)
    if ext == ".3mf":
        assert _zip_members(got) == _zip_members(want)
    else:
        assert got.read_bytes() == want.read_bytes()
    assert got.stat().st_size > 100


@pytest.mark.parametrize("case", sorted(c for c in WRITE_CASES
                                        if WRITE_CASES[c][0] in mesh_io_jax.READERS))
def test_each_reads_the_others_files(tmp_path, case):
    ext, kw = WRITE_CASES[case]
    v, f = _mesh()
    port_file, jax_file = tmp_path / f"port{ext}", tmp_path / f"jax{ext}"
    mesh_io.export_surface(port_file, v, f, **kw)
    mesh_io_jax.export_surface(jax_file, v, f, **kw)
    for path in (port_file, jax_file):
        got = mesh_io.import_surface(path)
        want = mesh_io_jax.import_surface(path)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(got[1]) == len(f)


def test_write_stl_names_and_reads_both_encodings(tmp_path):
    v, f = _mesh()
    for binary in (True, False):
        p, q = tmp_path / f"a{binary}.stl", tmp_path / f"b{binary}.stl"
        mesh_io.write_stl(p, v, f, binary=binary, name="bone")
        mesh_io_jax.write_stl(q, v, f, binary=binary, name="bone")
        assert p.read_bytes() == q.read_bytes()
        rv, rf = mesh_io.read_stl(p)
        assert len(rf) == len(f) and len(rv) == len(v)


def _b64_array(raw: bytes) -> str:
    """Uncompressed inline-binary encoding: base64(UInt32 byte count + data)."""
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def _z_array(raw: bytes) -> bytes:
    """One zlib block with its UInt32 header, unencoded (appended raw)."""
    comp = zlib.compress(raw)
    return struct.pack("<4I", 1, len(raw), len(raw), len(comp)) + comp


def _vtp(points: str, conn: str, offs: str, head_attrs: str = "",
         appended: bytes = b"") -> bytes:
    doc = (
        '<?xml version="1.0"?>\n'
        f'<VTKFile type="PolyData" version="1.0" byte_order="LittleEndian"{head_attrs}>\n'
        f' <PolyData>\n  <Piece NumberOfPoints="1" NumberOfPolys="1">\n'
        f'   <Points>{points}</Points>\n'
        f'   <Polys>{conn}{offs}</Polys>\n'
        '  </Piece>\n </PolyData>\n'
    ).encode()
    return doc + appended + b"</VTKFile>\n"


def _vtp_variants(v, f):
    pts, conn = v.astype(np.float32).tobytes(), f.astype(np.int64).ravel().tobytes()
    offs = (np.arange(1, len(f) + 1, dtype=np.int64) * 3).tobytes()
    inline = _vtp(
        f'<DataArray type="Float32" NumberOfComponents="3" format="binary">{_b64_array(pts)}</DataArray>',
        f'<DataArray type="Int64" Name="connectivity" format="binary">{_b64_array(conn)}</DataArray>',
        f'<DataArray type="Int64" Name="offsets" format="binary">{_b64_array(offs)}</DataArray>')
    blob = b""
    offsets = []
    for raw in (pts, conn, offs):
        offsets.append(len(base64.b64encode(blob)))
        blob += struct.pack("<I", len(raw)) + raw
        blob += b"\0" * (-len(blob) % 3)  # keep each array on a base64 quantum
    appended_b64 = _vtp(
        f'<DataArray type="Float32" NumberOfComponents="3" format="appended" offset="{offsets[0]}"/>',
        f'<DataArray type="Int64" Name="connectivity" format="appended" offset="{offsets[1]}"/>',
        f'<DataArray type="Int64" Name="offsets" format="appended" offset="{offsets[2]}"/>',
        appended=b' <AppendedData encoding="base64">_' + base64.b64encode(blob)
        + b"</AppendedData>\n")
    zraw, zoff = b"", []
    for raw in (pts, conn, offs):
        zoff.append(len(zraw))
        zraw += _z_array(raw)
    appended_zraw = _vtp(
        f'<DataArray type="Float32" NumberOfComponents="3" format="appended" offset="{zoff[0]}"/>',
        f'<DataArray type="Int64" Name="connectivity" format="appended" offset="{zoff[1]}"/>',
        f'<DataArray type="Int64" Name="offsets" format="appended" offset="{zoff[2]}"/>',
        head_attrs=' header_type="UInt32" compressor="vtkZLibDataCompressor"',
        appended=b' <AppendedData encoding="raw">_' + zraw + b"</AppendedData>\n")
    return {"inline_b64": inline, "inline_zlib": write_vtp_binary_compressed(v, f),
            "appended_b64": appended_b64, "appended_raw_u64": write_vtp_appended_raw(v, f),
            "appended_raw_zlib": appended_zraw}


@pytest.mark.parametrize("variant", ["inline_b64", "inline_zlib", "appended_b64",
                                     "appended_raw_u64", "appended_raw_zlib"])
def test_read_vtp_encodings(tmp_path, variant):
    v, f = _mesh()
    p = tmp_path / "s.vtp"
    p.write_bytes(_vtp_variants(v, f)[variant])
    got, want = mesh_io.read_vtp(p), mesh_io_jax.read_vtp(p)
    np.testing.assert_array_equal(got[0], v)
    np.testing.assert_array_equal(got[1], f)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_tables_and_unsupported_formats(tmp_path):
    assert sorted(mesh_io.WRITERS) == sorted(mesh_io_jax.WRITERS)
    assert sorted(mesh_io.READERS) == sorted(mesh_io_jax.READERS)
    v, f = _mesh()
    with pytest.raises(ValueError, match="unsupported mesh format"):
        mesh_io.export_surface(tmp_path / "s.xyz", v, f)
    with pytest.raises(ValueError, match="unsupported mesh format"):
        mesh_io.import_surface(tmp_path / "s.x3d")

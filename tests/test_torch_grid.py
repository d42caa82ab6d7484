"""The port's stimulation grids (``navigation/grid.py``) on the JAX package's
cases (tests/test_navigation.py: a rectangular grid on a sphere's scalp, the
circular grid's counts and z offset, the degenerate grids and the CSV
fields), and against the JAX module on the same meshes and reference
markers: positions and orientations within 1e-9 (float64 numpy on both
sides), the same labels, marker fields and CSV rows, the same chosen
vertices (``argmin``'s first minimum, ties included) however the port
blocks its distance queries."""

import numpy as np
import pytest

from invesalius3_tpu import events as events_jax
from invesalius3_tpu.navigation import grid as grid_jax
from invesalius3_tpu.navigation import markers as markers_jax
from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.navigation import grid
from invesalius3_tpu_torch.navigation.grid import GridGenerator, ScalpGeometry
from invesalius3_tpu_torch.navigation.markers import Marker, MarkersControl, MarkerType
from invesalius3_tpu_torch.ops import transforms as tr


def _sphere_mesh(radius=80.0, n=48):
    """Lat-long sphere mesh centred at the origin, and its radial normals."""
    th = np.linspace(0, np.pi, n)
    ph = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    verts = radius * np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)],
                              -1).reshape(-1, 3)
    return verts, verts / radius


def _sphere_faces(n=48):
    """Triangles of the lat-long grid of ``_sphere_mesh`` (outward)."""
    m = 2 * n
    faces = []
    for i in range(n - 1):
        for j in range(m):
            a, b = i * m + j, i * m + (j + 1) % m
            c, d = a + m, b + m
            faces += [(a, c, b), (b, c, d)]
    return np.array(faces)


def test_grid_generator_rectangular_on_scalp():
    verts, normals = _sphere_mesh()
    ref = Marker(marker_type=MarkerType.COIL_TARGET, position=(0.0, 0.0, 80.0), label="T",
                 z_rotation=10.0, z_offset=0.0)
    out = GridGenerator(ScalpGeometry(verts, normals=normals)).generate_rectangular_grid(
        ref, rows=3, cols=3, spacing=10.0)
    assert len(out) == 8
    assert {m.label for m in out} == {f"T {r}_{c}" for r in (1, 2, 3)
                                      for c in (1, 2, 3)} - {"T 2_2"}
    for m in out:
        p = np.array(m.position) * [1, -1, 1]
        assert abs(np.linalg.norm(p) - 80.0) < 2.0
        zhat = tr.euler_matrix(*np.radians(m.orientation), axes="sxyz")[:3, :3] @ [0, 0, 1]
        np.testing.assert_allclose(zhat, p / np.linalg.norm(p), atol=0.1)
        assert m.marker_type == MarkerType.COIL_TARGET and not m.is_target
        assert m.z_rotation == 10.0


def test_grid_generator_circular_counts_and_offset():
    verts, normals = _sphere_mesh()
    ref = Marker(marker_type=MarkerType.COIL_TARGET, position=(0.0, 0.0, 80.0), label="C",
                 z_offset=5.0)
    gg = GridGenerator(ScalpGeometry(verts, normals=normals))
    out = gg.generate_circular_grid(ref, rings=2, points_per_ring=6, spacing=8.0)
    assert len(out) == 12
    for m in out:
        assert 82.0 < np.linalg.norm(np.array(m.position) * [1, -1, 1]) < 88.0
    with pytest.raises(ValueError):
        gg.generate_rectangular_grid(ref, rows=101, cols=2, spacing=1.0)
    with pytest.raises(ValueError):
        gg.generate_circular_grid(ref, rings=101, points_per_ring=100, spacing=1.0)


def test_grid_generator_degenerate_and_csv_fields(tmp_path):
    verts, normals = _sphere_mesh()
    gg = GridGenerator(ScalpGeometry(verts, normals=normals))
    ref = Marker(marker_type=MarkerType.COIL_TARGET, position=(0, 0, 80.0), label="M",
                 z_rotation=15.0, z_offset=2.0)
    assert gg.generate_rectangular_grid(ref, 1, 1, 5.0) == []
    assert gg.generate_circular_grid(ref, 0, 6, 4.0) == []
    mc = MarkersControl(bus=events.Publisher())
    mc.add(ref)
    mc.save_csv(tmp_path / "m.csv")
    mc2 = MarkersControl(bus=events.Publisher())
    mc2.load_csv(tmp_path / "m.csv")
    assert mc2.markers[0].z_rotation == 15.0 and mc2.markers[0].z_offset == 2.0


def test_scalp_geometry_needs_faces_or_normals():
    with pytest.raises(ValueError, match="faces or precomputed normals"):
        ScalpGeometry(np.zeros((3, 3)))


# -- against the JAX module ---------------------------------------------------------------

def _jax_marker(m: Marker):
    return markers_jax.Marker.from_dict(m.to_dict())


@pytest.mark.parametrize("kind,args", [
    ("rectangular", (5, 4, 7.5)), ("rectangular", (3, 3, 10.0)),
    ("circular", (3, 8, 6.0)), ("circular", (1, 5, 12.0))])
@pytest.mark.parametrize("ref_kw", [
    {"position": (0.0, 0.0, 80.0), "z_rotation": 10.0},
    {"position": (30.0, -25.0, 70.0), "orientation": (12.0, -20.0, 35.0),
     "z_rotation": -30.0, "z_offset": 3.0}])
@pytest.mark.parametrize("with_faces", [False, True])
def test_grids_equal_jax(kind, args, ref_kw, with_faces, tmp_path):
    """Same mesh, same reference marker: the same targets (positions and
    orientations within 1e-9), labels, fields and CSV rows."""
    verts, normals = _sphere_mesh()
    faces = _sphere_faces()
    if with_faces:
        scalp, scalp_j = ScalpGeometry(verts, faces), grid_jax.ScalpGeometry(verts, faces)
        np.testing.assert_array_equal(scalp.normals, scalp_j.normals)
    else:
        scalp = ScalpGeometry(verts, normals=normals)
        scalp_j = grid_jax.ScalpGeometry(verts, normals=normals)
    ref = Marker(marker_type=MarkerType.COIL_TARGET, label="R", **ref_kw)
    fn = f"generate_{kind}_grid"
    got = getattr(GridGenerator(scalp), fn)(ref, *args)
    want = getattr(grid_jax.GridGenerator(scalp_j), fn)(_jax_marker(ref), *args)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.position, w.position, rtol=0, atol=1e-9)
        np.testing.assert_allclose(g.orientation, w.orientation, rtol=0, atol=1e-9)
        gd, wd = g.to_dict(), w.to_dict()
        for k in ("position", "orientation"):
            gd.pop(k), wd.pop(k)
        assert gd == wd
    mc, mj = MarkersControl(bus=events.Publisher()), markers_jax.MarkersControl(
        bus=events_jax.Publisher())
    for g, w in zip(got, want):
        mc.add(g)
        mj.add(w)
    mc.save_csv(tmp_path / "port.csv")
    mj.save_csv(tmp_path / "jax.csv")
    rows = [(tmp_path / f).read_text().splitlines() for f in ("port.csv", "jax.csv")]
    assert [r.split(",")[0] for r in rows[0]] == [r.split(",")[0] for r in rows[1]]
    for a, b in zip(*rows):
        fa, fb = a.split(","), b.split(",")
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            try:
                assert abs(float(x) - float(y)) <= 1e-9
            except ValueError:
                assert x == y


def test_project_blocks_keep_the_jax_vertices(monkeypatch):
    """The port's query blocks (here 37 distances at most) choose the JAX
    module's vertices, ties to the first, with its normals."""
    verts, normals = _sphere_mesh(n=12)
    verts = np.concatenate([verts, verts[:5]])  # exact duplicates: distance ties
    normals = np.concatenate([normals, -normals[:5]])
    pts = np.concatenate([verts[:40] * 1.01, np.random.default_rng(0).normal(0, 60, (200, 3))])
    want = grid_jax.ScalpGeometry(verts, normals=normals).project(pts)
    monkeypatch.setattr(grid, "PROJECT_BLOCK", 37)
    got = ScalpGeometry(verts, normals=normals).project(pts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
    monkeypatch.setattr(grid, "PROJECT_BLOCK", 1 << 22)
    full = ScalpGeometry(verts, normals=normals).project(pts)
    np.testing.assert_array_equal(full[0], want[0])
    np.testing.assert_array_equal(full[1], want[1])


@pytest.mark.parametrize("normal", [(0, 0, 1), (0, 0, -1), (1, 0, 0), (0.3, -0.5, 0.8)])
def test_normal_to_euler_equals_jax(normal):
    n = np.asarray(normal, float)
    np.testing.assert_array_equal(grid._normal_to_euler_deg(n), grid_jax._normal_to_euler_deg(n))


def test_move_marker_equals_jax():
    m = Marker(position=(10.0, 20.0, 30.0), orientation=(5.0, -10.0, 15.0))
    mj = _jax_marker(m)
    for d in ([1, 2, 3, 0, 0, 0], [0, 0, 0, 10, 20, 30], [4, -5, 6, 7, -8, 9]):
        grid.move_marker(m, d)
        grid_jax.move_marker(mj, d)
    np.testing.assert_array_equal(m.position, mj.position)
    np.testing.assert_array_equal(m.orientation, mj.orientation)
    assert grid.MAX_GRID_DIMENSION == grid_jax.MAX_GRID_DIMENSION

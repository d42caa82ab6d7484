"""The port's measurements (``invesalius3_tpu_torch.core.measures``) against
the JAX package's on the same inputs, made from a numpy seed (the JAX tests:
tests/test_navigation.py:213-280).  Both are numpy and scipy on the host;
the values agree exactly."""

import numpy as np
import pytest

from invesalius3_tpu import events as events_jax
from invesalius3_tpu.core import measures as mj
from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.core import measures as mt

RNG = np.random.default_rng(0)


def _image(h=20, w=24):
    return np.random.default_rng(1).integers(-1000, 2000, (h, w)).astype(np.int16)


@pytest.mark.parametrize("p1,p2", [((1, 0, 0), (3, 4, 0)), ((1.5, -2, 7), (0.25, 3, -1))])
def test_distance_and_angle(p1, p2):
    assert mt.calculate_distance(p1, p2) == mj.calculate_distance(p1, p2)
    assert mt.calculate_angle(p1, p2) == mj.calculate_angle(p1, p2)
    p0 = (2.0, 1.0, 0.5)
    assert mt.angle_from_3_points(p0, p1, p2) == mj.angle_from_3_points(p0, p1, p2)


def test_polygon_area_perimeter():
    pts = RNG.uniform(0, 30, (7, 2))
    assert mt.polygon_area_perimeter(pts) == mj.polygon_area_perimeter(pts)
    assert mt.polygon_area_perimeter([(0, 0), (0, 2), (2, 2), (2, 0)]) == (4.0, 8.0)


@pytest.mark.parametrize("center,ry,rx", [((10, 12), 3, 4), ((0, 0), 5, 2.5),
                                          ((19.5, 23), 30, 30), ((8, 8), 0.4, 0.4)])
def test_density_ellipse(center, ry, rx):
    img = _image()
    assert mt.density_ellipse(img, center, ry, rx) == mj.density_ellipse(img, center, ry, rx)


POLYGONS = [[(5, 5), (5, 14), (14, 14), (14, 5)],
            [(2.5, 1), (18, 3.5), (11, 22.2), (6, 12)],
            [(0, 0), (19, 23), (0, 23), (19, 0)],  # self-crossing: even-odd
            [(3, 3), (3, 3), (4, 4)]]


@pytest.mark.parametrize("poly", POLYGONS)
def test_polygon2mask_and_density_polygon(poly):
    img = _image()
    np.testing.assert_array_equal(mt.polygon2mask(img.shape, poly),
                                  mj.polygon2mask(img.shape, poly))
    assert mt.density_polygon(img, poly) == mj.density_polygon(img, poly)


def _sphere_mesh():
    """A closed mesh: an octahedron subdivided twice, onto the unit sphere."""
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                 np.float64)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int64)
    for _ in range(2):
        verts, mid, faces = list(v), {}, []

        def m(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                p = (verts[a] + verts[b]) / 2
                verts.append(p / np.linalg.norm(p))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v, f = np.array(verts), np.array(faces, np.int64)
    return (v * 10).astype(np.float32), f.astype(np.int32)


def test_geodesic_and_ray_pick():
    v, f = _sphere_mesh()
    for i0, i1 in ((0, 1), (2, 5), (7, 40)):
        assert mt.geodesic_distance(v, f, i0, i1) == mj.geodesic_distance(v, f, i0, i1)
    rays = [([0.5, 0.3, -40], [0, 0, 1]), ([0, 0, 40], [0, 0.1, -1]),
            ([40, 40, 40], [-1, -1, -1]), ([50, 50, 0], [0, 0, 1])]
    for o, d in rays:
        got, want = mt.ray_pick(v, f, o, d), mj.ray_pick(v, f, o, d)
        if want is None:
            assert got is None
            continue
        assert got[:3] == want[:3]
        np.testing.assert_array_equal(got[3], want[3])
    # chunked: the same hit with faces cut into small chunks
    assert mt.ray_pick(v, f, *rays[0], chunk=7)[:3] == mj.ray_pick(v, f, *rays[0])[:3]


def _fill(mgr, img, v, f):
    mgr.add_linear((0, 0, 0), (3, 4, 0))
    mgr.add_angular((1, 0, 0), (0, 0, 0), (0, 1, 0), location="CORONAL", slice_number=3)
    mgr.add_annotation((2, 3, 4), "LESION", lead_point=(5, 5, 5))
    mgr.add_density_ellipse(img, (10, 10), 3, 4, location="AXIAL", slice_number=2)
    mgr.add_density_polygon(img, POLYGONS[1], location="SAGITAL", slice_number=1)
    mgr.add_geodesic(v.astype(np.float64), f, 0, 1)
    mgr.remove(1)
    return mgr


def test_measurement_manager_equals_the_jax_package():
    img = _image()
    v, f = _sphere_mesh()
    heard = []
    bus = events.Publisher()
    bus.subscribe(events.wants_topic(lambda topic=None, **kw: heard.append((topic, kw))),
                  events.ALL_TOPICS)
    got = _fill(mt.MeasurementManager(bus=bus), img, v, f)
    want = _fill(mj.MeasurementManager(bus=events_jax.Publisher()), img, v, f)
    assert got.to_dict() == want.to_dict()
    assert [t for t, _ in heard] == ["measures.added"] * 6 + ["measures.removed"]
    again = mt.MeasurementManager(bus=events.Publisher())
    again.load_dict(want.to_dict())
    assert again.to_dict() == got.to_dict()
    assert again.add_linear((0, 0, 0), (1, 0, 0)).index == 6


def test_geodesic_across_components_is_refused():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 0], [6, 5, 0], [5, 6, 0]],
                     np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    with pytest.raises(ValueError, match="different connected components"):
        mt.MeasurementManager(bus=events.Publisher()).add_geodesic(verts, faces, 0, 4)


def test_reference_measure_codes():
    d = {"index": 4, "type": 7, "location": 3, "points": [(1, 2, 3)] * 3,
         "colour": (0.1, 0.2, 0.3, 1.0), "value": 45.0, "unknown_key": 1}
    got, want = mt.Measurement.from_dict(d), mj.Measurement.from_dict(d)
    assert got.to_dict() == want.to_dict()
    assert got.type == "angular" and got.location == "SAGITAL" and got.colour == (0.1, 0.2, 0.3)

"""Transforms, oblique reslicing, resizing and ``Slice.apply_reorientation``
of the port against the JAX package's, on the CPU, on seeded volumes of
16^3 to 24^3 (the JAX tests/test_reslice_raycast.py :42-107 and :218-233,
tests/test_editor_ops.py :86-96 and tests/test_slice_editing.py :259-322,
case for case, through both packages).

Tolerances:
- transforms, ``_wrap``, ``_gather``, jnp.linspace's coordinates, the
  4x4 row in XLA's FMA order: equal;
- nearest resampling: equal (identity, translation and oblique matrices:
  the sample coordinates are evaluated in XLA's order);
- float resampling (trilinear, tricubic, Lanczos, their weights): within
  1e-4 of the volume's value range (XLA fuses the blends differently in
  different programs, and sums the taps in another order);
- integer resampling: within 1 level (a sum that lands near .5 rounds
  either way), on at most 1% of voxels;
- ``apply_reorientation``: the matrix as integer resampling; the edited
  mask (nearest) equal; the unedited mask is the threshold of the port's
  own new matrix, so it differs from JAX's only where the matrices do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu import constants as const_jax
from invesalius3_tpu import events as events_jax
from invesalius3_tpu.core.slice import Slice as SliceJax
from invesalius3_tpu.core.volume import Volume as VolumeJax
from invesalius3_tpu.ops import reslice as reslice_jax
from invesalius3_tpu.ops import resize as resize_jax
from invesalius3_tpu.ops import transforms as tr_jax
from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch import convert, events
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.core.slice import Slice
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.ops import reslice, resize, transforms, xla_float

torch.set_num_threads(1)
rng = np.random.default_rng(9)
METHODS = [const.INTERP_NEAREST, const.INTERP_TRILINEAR, const.INTERP_TRICUBIC,
           const.INTERP_LANCZOS]
ORIENTS = [("AXIAL", 0), ("CORONAL", 3), ("SAGITAL", 2), ("SAGITTAL", 1)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rotation(shape, spacing, angles=(0.3, -0.2, 0.35)):
    """M = T1 R^T T0 about the volume's physical centre, float32."""
    c = np.array([s * n / 2.0 for s, n in zip(spacing[::-1], shape)])
    R = tr_jax.euler_matrix(*angles)
    return (tr_jax.translation_matrix(c) @ R.T @ tr_jax.translation_matrix(-c)
            ).astype(np.float32)


def _close_float(got, want, ref):
    span = float(np.ptp(ref)) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * span)


def _close_int(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-2, (d > 0).mean()


# ---------------------------------------------------------------------------
# constants and transforms
# ---------------------------------------------------------------------------


def test_interp_constants_equal():
    for name in ("INTERP_NEAREST", "INTERP_TRILINEAR", "INTERP_TRICUBIC",
                 "INTERP_LANCZOS"):
        assert getattr(const, name) == getattr(const_jax, name)


@pytest.mark.parametrize("axes", sorted(transforms._AXES2TUPLE))
def test_euler_matrix_and_back_equal(axes):
    angles = rng.uniform(-1.2, 1.2, 3)
    m = transforms.euler_matrix(*angles, axes=axes)
    np.testing.assert_array_equal(m, tr_jax.euler_matrix(*angles, axes=axes))
    assert transforms.euler_from_matrix(m, axes) == tr_jax.euler_from_matrix(m, axes)


def test_euler_roundtrip():
    for axes in ("sxyz", "rzyx", "szyx"):
        angles = rng.uniform(-1.2, 1.2, 3)
        m = transforms.euler_matrix(*angles, axes=axes)
        back = transforms.euler_from_matrix(m, axes=axes)
        np.testing.assert_allclose(m, transforms.euler_matrix(*back, axes=axes), atol=1e-9)


@pytest.mark.parametrize("angles", [(0.1, -0.7, 1.3), (2.9, 0.2, -2.5), (0.0, 0.0, 0.0),
                                    (np.pi, 0.0, 0.0)])
def test_quaternion_and_helpers_equal(angles):
    m = transforms.euler_matrix(*angles, axes="sxyz")
    q = transforms.quaternion_from_matrix(m)
    np.testing.assert_array_equal(q, tr_jax.quaternion_from_matrix(m))
    np.testing.assert_array_equal(transforms.quaternion_matrix(q),
                                  tr_jax.quaternion_matrix(q))
    np.testing.assert_allclose(transforms.quaternion_matrix(q), m, atol=1e-9)
    t = transforms.translation_matrix((1.5, -2.0, 3.0))
    np.testing.assert_array_equal(t, tr_jax.translation_matrix((1.5, -2.0, 3.0)))
    np.testing.assert_array_equal(transforms.concatenate_matrices(t, m, t),
                                  tr_jax.concatenate_matrices(t, m, t))
    np.testing.assert_array_equal(transforms.quaternion_matrix([0, 0, 0, 0]), np.eye(4))


# ---------------------------------------------------------------------------
# interpolators
# ---------------------------------------------------------------------------


def _oracle_trilinear(v, x, y, z):
    import math

    def get(xi, yi, zi):
        dz, dy, dx = v.shape
        xi = xi + dx if xi < 0 else xi - dx if xi >= dx else xi
        yi = yi + dy if yi < 0 else yi - dy if yi >= dy else yi
        zi = zi + dz if zi < 0 else zi - dz if zi >= dz else zi
        return float(v[zi, yi, xi])

    x0, y0, z0 = math.floor(x), math.floor(y), math.floor(z)
    xd, yd, zd = x - x0, y - y0, z - z0
    c00 = get(x0, y0, z0) * (1 - xd) + get(x0 + 1, y0, z0) * xd
    c10 = get(x0, y0 + 1, z0) * (1 - xd) + get(x0 + 1, y0 + 1, z0) * xd
    c01 = get(x0, y0, z0 + 1) * (1 - xd) + get(x0 + 1, y0, z0 + 1) * xd
    c11 = get(x0, y0 + 1, z0 + 1) * (1 - xd) + get(x0 + 1, y0 + 1, z0 + 1) * xd
    return (c00 * (1 - yd) + c10 * yd) * (1 - zd) + (c01 * (1 - yd) + c11 * yd) * zd


def test_trilinear_matches_oracle_and_jax():
    v = rng.integers(0, 100, (6, 7, 8)).astype(np.int16)
    pts = rng.uniform(-1.5, 7.5, (400, 3)).astype(np.float32)
    got = reslice.trilinear(_t(v), *(_t(pts[:, i]) for i in range(3))).numpy()
    want = np.asarray(jax.jit(reslice_jax.trilinear)(jnp.asarray(v),
                                                     *(pts[:, i] for i in range(3))))
    _close_float(got, want, v)
    eager = np.asarray(reslice_jax.trilinear(jnp.asarray(v), *(pts[:, i] for i in range(3))))
    _close_float(got, eager, v)
    inner = (pts >= 0.5).all(1) & (pts <= 4.5).all(1)
    np.testing.assert_allclose(got[inner], [_oracle_trilinear(v, *p) for p in pts[inner]],
                               rtol=1e-5)


def test_trilinear_far_outside_reads_as_the_jax_gather():
    """Coordinates beyond one period of the volume (a tracker pose far off
    the field) read the voxels JAX's clamping gather reads, instead of
    raising."""
    v = rng.integers(0, 100, (6, 7, 9)).astype(np.int16)
    pts = rng.uniform(-60, 70, (500, 3)).astype(np.float32)
    got = reslice.trilinear(_t(v), *(_t(pts[:, i]) for i in range(3))).numpy()
    want = np.asarray(jax.jit(reslice_jax.trilinear)(jnp.asarray(v),
                                                     *(pts[:, i] for i in range(3))))
    _close_float(got, want, v)
    zi = _t(np.array([-40, 3, 50]))
    np.testing.assert_array_equal(
        reslice._gather(_t(v), zi, zi, zi).numpy(),
        np.asarray(reslice_jax._gather(jnp.asarray(v), *(np.array([-40, 3, 50]),) * 3)))


def test_tricubic_interpolates_smoothly():
    zz, yy, xx = np.mgrid[:8, :8, :8].astype(np.float32)
    v = 2 * xx + 3 * yy + 5 * zz
    got = float(reslice.tricubic(_t(v), _t(np.float32([3.25])), _t(np.float32([2.5])),
                                 _t(np.float32([4.75])))[0])
    assert abs(got - (2 * 3.25 + 3 * 2.5 + 5 * 4.75)) < 1e-3


def test_lanczos_near_constant():
    v = np.full((10, 10, 10), 7.0, np.float32)
    got = float(reslice.lanczos(_t(v), _t(np.float32([4.3])), _t(np.float32([5.1])),
                                _t(np.float32([4.9])))[0])
    assert abs(got - 7.0) / 7.0 < 0.03
    got_int = float(reslice.lanczos(_t(v), _t(np.float32([4.0])), _t(np.float32([5.0])),
                                    _t(np.float32([4.0])))[0])
    assert abs(got_int - 7.0) < 1e-4


@pytest.mark.parametrize("fn", ["tricubic", "lanczos"])
def test_tap_interpolators_against_jax(fn):
    v = (rng.normal(size=(9, 10, 11)) * 400).astype(np.float32)
    pts = rng.uniform(-3.5, 12.5, (3, 500)).astype(np.float32)
    got = getattr(reslice, fn)(_t(v), *map(_t, pts)).numpy()
    want = np.asarray(getattr(reslice_jax, fn)(jnp.asarray(v), *pts))
    _close_float(got, want, v)


def test_weights_wrap_and_gather_against_jax():
    t = rng.uniform(0, 1, 300).astype(np.float32)
    t[:3] = (0.0, 0.5, 0.999)
    np.testing.assert_allclose(reslice._cr_weights(_t(t)).numpy(),
                               np.asarray(reslice_jax._cr_weights(jnp.asarray(t))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(reslice._lanczos_weights(_t(t)).numpy(),
                               np.asarray(reslice_jax._lanczos_weights(jnp.asarray(t))),
                               rtol=0, atol=1e-6)
    idx = np.arange(-5, 15, dtype=np.int64)
    np.testing.assert_array_equal(reslice._wrap(_t(idx), 10).numpy(),
                                  np.asarray(reslice_jax._wrap(jnp.asarray(idx), 10)))
    v = rng.integers(-50, 50, (4, 5, 6)).astype(np.int16)
    zi, yi, xi = (rng.integers(-2, 8, 50) for _ in range(3))
    np.testing.assert_array_equal(
        reslice._gather(_t(v), *map(_t, (zi, yi, xi))).numpy(),
        np.asarray(reslice_jax._gather(jnp.asarray(v), *(jnp.asarray(a, jnp.int32)
                                                          for a in (zi, yi, xi)))))


def test_fma_order_is_xla_order():
    """``xla_float`` evaluates the sums XLA contracts as JAX does."""
    x, y, z = (rng.normal(size=5000).astype(np.float32) * 100 for _ in range(3))
    m = rng.normal(size=4).astype(np.float32)
    got = xla_float.row4(m, _t(x), _t(y), _t(z)).numpy()
    want = np.asarray(jax.jit(lambda m, x, y, z: m[0] * x + m[1] * y + m[2] * z + m[3])(
        m, x, y, z))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", METHODS)
def test_sample_volume_against_jax(method):
    v = (rng.normal(size=(8, 9, 10)) * 300).astype(np.float32)
    pts = rng.uniform(-1.0, 10.0, (3, 600)).astype(np.float32)
    got = reslice.sample_volume(_t(v), *map(_t, pts), method, -500.0).numpy()
    want = np.asarray(reslice_jax.sample_volume(jnp.asarray(v), *pts, method, -500.0))
    if method == const.INTERP_NEAREST:
        np.testing.assert_array_equal(got, want)
    else:
        _close_float(got, want, v)


# ---------------------------------------------------------------------------
# apply_view_matrix_transform
# ---------------------------------------------------------------------------


def _both_avmt(v, spacing, m, n, orient, method, cval, out_shape):
    got = reslice.apply_view_matrix_transform(
        _t(v), spacing, m, n, orient, method, cval, out_shape).numpy()
    want = np.asarray(reslice_jax.apply_view_matrix_transform(
        jnp.asarray(v), spacing, jnp.asarray(m), n, orient, method, cval, out_shape))
    assert got.dtype == want.dtype and got.shape == want.shape
    return got, want


def test_apply_view_matrix_identity():
    v = rng.integers(0, 100, (8, 10, 12)).astype(np.int16)
    got, want = _both_avmt(v, (1.0, 1.0, 1.0), np.eye(4), 0, "AXIAL",
                           const.INTERP_NEAREST, float(v.min()), (8, 10, 12))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:7, :9, :11], v[:7, :9, :11])


def test_apply_view_matrix_translation():
    v = rng.integers(0, 100, (8, 10, 12)).astype(np.int16)
    m = np.eye(4)
    m[0, 3] = 2.0
    got, want = _both_avmt(v, (1.0, 1.0, 1.0), m, 0, "AXIAL", const.INTERP_NEAREST,
                           -1, (8, 10, 12))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:5, :9, :11], v[2:7, :9, :11])


@pytest.mark.parametrize("method", METHODS)
def test_identity_keeps_the_interior(method):
    v = rng.integers(-1000, 2000, (10, 11, 12)).astype(np.int16)
    got = reslice.apply_view_matrix_transform(
        _t(v), (0.5, 0.5, 0.5), np.eye(4), 0, "AXIAL", method, float(v.min()),
        v.shape).numpy()
    np.testing.assert_array_equal(got[:9, :10, :11], v[:9, :10, :11])


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
@pytest.mark.parametrize("orient,n", ORIENTS)
@pytest.mark.parametrize("method", METHODS)
def test_oblique_reslice_against_jax(method, orient, n, dtype):
    shape, spacing = (16, 18, 20), (0.7, 0.8, 0.9)
    hi = 250 if dtype == np.uint8 else 3000
    v = rng.integers(0, hi, shape).astype(dtype)
    m = _rotation(shape, spacing)
    cval = float(v.min())
    got, want = _both_avmt(v, spacing, m, n, orient, method, cval, (12, 18, 20))
    if method == const.INTERP_NEAREST:
        np.testing.assert_array_equal(got, want)
    elif dtype == np.float32:
        _close_float(got, want, v)
    else:
        _close_int(got, want)


def test_reslice_in_several_slabs(monkeypatch):
    """Slabs of two output planes give the same volume as one slab."""
    v = rng.integers(-1000, 2000, (12, 13, 14)).astype(np.int16)
    m = _rotation(v.shape, (1.0, 1.0, 1.0), (0.2, 0.5, -0.4))
    for method in METHODS:
        one = reslice.apply_view_matrix_transform(_t(v), (1, 1, 1), m, 0, "AXIAL",
                                                  method, -1000.0, v.shape)
        monkeypatch.setattr(reslice, "_SLAB_VOXELS", 2 * 13 * 14)
        two = reslice.apply_view_matrix_transform(_t(v), (1, 1, 1), m, 0, "AXIAL",
                                                  method, -1000.0, v.shape)
        monkeypatch.undo()
        assert torch.equal(one, two)


def test_integer_samples_round_half_to_even_and_saturate():
    v = np.zeros((6, 6, 6), np.int16)
    v[:, :, 3:] = 32767
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = 0.5  # sample halfway along x
    got, want = _both_avmt(v, (1.0, 1.0, 1.0), m, 0, "AXIAL", const.INTERP_LANCZOS,
                           -32768.0, v.shape)
    np.testing.assert_array_equal(got, want)
    got, want = _both_avmt(v, (1.0, 1.0, 1.0), m, 0, "AXIAL", const.INTERP_TRILINEAR,
                           0.0, v.shape)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


def test_resize_volume():
    v = np.arange(8 * 8 * 8, dtype=np.float32).reshape(8, 8, 8)
    out = resize.resize_volume(_t(v), (4, 4, 4), order=1).numpy()
    assert out.shape == (4, 4, 4)
    np.testing.assert_allclose(out[0, 0, 0], 0.0)
    np.testing.assert_allclose(out[-1, -1, -1], 511.0)
    assert resize.resize_volume(_t(v), (16, 16, 16), order=0).shape == (16, 16, 16)


def test_axis_coords_are_jnp_linspace():
    for n_in in range(1, 40):
        for n_out in range(1, 80):
            got = resize._axis_coords(n_in, n_out, "cpu").numpy()
            want = (np.zeros(1, np.float32) if n_out == 1 else
                    np.asarray(jnp.linspace(0.0, n_in - 1.0, n_out)))
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.uint8])
@pytest.mark.parametrize("out_shape", [(4, 4, 4), (9, 17, 5), (23, 1, 30)])
@pytest.mark.parametrize("order", [0, 1])
def test_resize_against_jax(order, out_shape, dtype):
    v = rng.integers(0, 250, (9, 11, 13)).astype(dtype)
    got = resize.resize_volume(_t(v), out_shape, order).numpy()
    want = np.asarray(resize_jax.resize_volume(jnp.asarray(v), out_shape, order=order))
    assert got.dtype == want.dtype
    if order == 0:
        np.testing.assert_array_equal(got, want)
    elif dtype == np.float32:
        _close_float(got, want, v)
    else:
        _close_int(got, want)


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_resize_by_spacing_scale(scale):
    v = rng.integers(-1000, 2000, (13, 14, 9)).astype(np.int16)
    got = resize.resize_by_spacing_scale(_t(v), scale).numpy()
    want = np.asarray(resize_jax.resize_by_spacing_scale(jnp.asarray(v), scale))
    assert got.shape == want.shape
    _close_int(got, want)


# ---------------------------------------------------------------------------
# Slice.apply_reorientation
# ---------------------------------------------------------------------------


def _slices(ct, spacing=(1.0, 1.0, 1.0)):
    Mask.general_index = -1
    from invesalius3_tpu.core.mask import Mask as MaskJax

    MaskJax.general_index = -1
    sj = SliceJax(VolumeJax.from_numpy(ct, spacing=spacing), bus=events_jax.Publisher())
    unedited = sj.create_new_mask(threshold_range=(500, 2000))
    edited = sj.create_new_mask(threshold_range=(226, 3071))
    d = np.asarray(edited.data).copy()
    d[5:9, 4:10, 6:11] = 254
    d[2:4, 2:4, 2:4] = 1
    edited.apply(jnp.asarray(d))
    assert edited.was_edited and not unedited.was_edited
    bus = events.Publisher()
    sp = convert.slice_from_jax(sj, device="cpu", bus=bus)
    return sj, sp, bus


@pytest.mark.parametrize("interp", METHODS)
def test_apply_reorientation_against_jax(interp):
    ct = rng.integers(-1000, 2000, (16, 18, 17)).astype(np.int16)
    sj, sp, bus = _slices(ct, (0.9, 1.0, 1.1))
    seen = []
    bus.subscribe(lambda **kw: seen.append(kw), "slice.reoriented")
    angles = (0.2, -0.1, 0.35)
    sj.apply_reorientation(angles=angles, interp_method=interp)
    sp.apply_reorientation(angles=angles, interp_method=interp)
    got, want = sp.matrix.numpy(), np.asarray(sj.matrix)
    if interp == const.INTERP_NEAREST:
        np.testing.assert_array_equal(got, want)
    else:
        _close_int(got, want)
    for i, mj in sj.masks.items():
        mp = sp.masks[i]
        assert len(mp.history._undo) == len(mp.history._redo) == 0
        if mj.was_edited:
            np.testing.assert_array_equal(mp.data.numpy(), np.asarray(mj.data))
        else:
            tmin, tmax = mp.threshold_range
            own = np.where((got >= tmin) & (got <= tmax), 255, 0)
            np.testing.assert_array_equal(mp.data.numpy(), own)
            differ = got != want
            np.testing.assert_array_equal(mp.data.numpy()[~differ],
                                          np.asarray(mj.data)[~differ])
    assert seen == [{"angles": angles}]


def test_apply_reorientation_quaternion_and_identity():
    ct = rng.integers(-1000, 2000, (10, 12, 14)).astype(np.int16)
    sj, sp, _ = _slices(ct)
    before = sp.matrix.clone()
    sj.apply_reorientation(angles=(0.0, 0.0, 0.0))
    sp.apply_reorientation(angles=(0.0, 0.0, 0.0))
    assert torch.equal(sp.matrix[1:-1, 1:-1, 1:-1], before[1:-1, 1:-1, 1:-1])
    np.testing.assert_array_equal(sp.matrix.numpy(), np.asarray(sj.matrix))
    q = transforms.quaternion_from_matrix(transforms.euler_matrix(0.3, 0.1, -0.2))
    sj.apply_reorientation(q_orientation=q, interp_method=const.INTERP_TRILINEAR)
    sp.apply_reorientation(q_orientation=q, interp_method=const.INTERP_TRILINEAR)
    _close_int(sp.matrix.numpy(), np.asarray(sj.matrix))
    with pytest.raises(ValueError):
        sp.apply_reorientation()


def test_apply_reorientation_scipy_oracle():
    from scipy import ndimage

    ct = rng.integers(-1000, 2000, (16, 16, 16)).astype(np.int16)
    slc = Slice(Volume.from_numpy(ct, spacing=(1.0, 1.0, 1.0), device="cpu"),
                bus=events.Publisher())
    m1 = slc.create_new_mask(threshold_range=(500, 2000))
    angles = (0.2, -0.1, np.pi / 2)
    slc.apply_reorientation(angles=angles, interp_method=const.INTERP_TRILINEAR)
    got = slc.matrix.numpy()
    ax, ay, az = angles
    R = transforms.euler_matrix(az, ay, ax, axes="sxyz")
    c = 8.0
    M = (transforms.translation_matrix((c, c, c)) @ R.T
         @ transforms.translation_matrix((-c, -c, -c)))
    want = ndimage.affine_transform(ct.astype(np.float64), M[:3, :3], offset=M[:3, 3],
                                    order=1, mode="constant", cval=float(ct.min()))
    zz, yy, xx = np.mgrid[:16, :16, :16].astype(np.float64)
    q = np.einsum("ij,jzyx->izyx", M, np.stack([zz, yy, xx, np.ones_like(zz)]))
    interior = ((q[:3] >= 0) & (q[:3] < 15)).all(0)
    diff = np.abs(got.astype(np.float64) - want)[interior]
    assert (diff <= 1.0).mean() > 0.999, diff.max()
    np.testing.assert_array_equal(m1.data.numpy() == 255, (got >= 500) & (got <= 2000))


def test_apply_reorientation_carries_edited_mask():
    ct = np.full((12, 12, 12), -1000, np.int16)
    slc = Slice(Volume.from_numpy(ct, device="cpu"), bus=events.Publisher())
    m = slc.create_new_mask(threshold_range=(500, 2000))
    d = np.zeros((12, 12, 12), np.uint8)
    d[5:7, 5:7, 5:7] = 254
    m.apply(_t(d))
    assert m.was_edited
    slc.apply_reorientation(angles=(0.0, 0.0, np.pi / 2))
    assert int((m.data == 254).sum()) >= 4


def test_slice_has_every_method_of_the_jax_slice():
    names = {m for m in dir(SliceJax) if not m.startswith("__")}
    assert names <= {m for m in dir(Slice) if not m.startswith("__")}

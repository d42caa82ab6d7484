"""The port's slab projections, windowing and thresholds against the JAX
package's, on the CPU, from the same seeded numpy inputs.

Tolerances (those of the JAX package's own tests, tests/test_projections.py
and tests/test_pallas_kernels.py):
- maxip, minip, meanip, lmip, the windowing and threshold functions and
  ``cast_like_jax``: exact;
- mida on integer volumes: atol 1 after the cast (XLA on the CPU contracts
  ``a * b + c`` into one fused multiply-add, the port rounds twice, and the
  cast to an integer can land one apart); on float32 volumes the same
  rounding, scaled by the slab's range (about 2300 here), so atol 1e-3;
- fcm_intensity: atol 1; fast_contour_mip: atol 2 (integer volumes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu import constants as const_jax
from invesalius3_tpu.ops import pallas_kernels
from invesalius3_tpu.ops import projections as proj_jax
from invesalius3_tpu.ops import threshold as thr_jax
from invesalius3_tpu.ops import windowing as win_jax
from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch.ops import projection_kernels as rays
from invesalius3_tpu_torch.ops import projections, threshold, windowing
from invesalius3_tpu_torch.ops.casting import cast_like_jax

torch.set_num_threads(1)

DTYPES = [np.int16, np.uint8, np.float32]
SHAPES = [(9, 13, 150), (12, 10, 11)]
AXES = [0, 1, 2]


def _vol(shape, dtype, seed=0):
    return rays.ray_case(shape, dtype, seed)


def _window(dtype):
    """(tmin, tmax) and (wl, ww) that land inside the case's intensities."""
    return ((30.0, 500.0), (40.0, 400.0)) if dtype != np.uint8 else \
        ((100.0, 200.0), (110.0, 60.0))


def _mida_close(got, want, dtype):
    if np.issubdtype(np.dtype(dtype), np.integer):
        np.testing.assert_allclose(got.astype(np.int64), want.astype(np.int64), atol=1)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, equal_nan=True)


def test_constants_equal_the_jax_package():
    names = [n for n in dir(const) if n[0].isupper()]
    assert len(names) == 34
    for n in names:
        assert getattr(const, n) == getattr(const_jax, n), n


# --------------------------------------------------------------------------
# cast_like_jax
# --------------------------------------------------------------------------

CAST_VALUES = np.array([np.nan, np.inf, -np.inf, 4e4, -4e4, -1.7, 1.7, 255.9,
                        256.0, -0.5, 3e9, -3e9, 127.5, -128.5], np.float32)


@pytest.mark.parametrize("dtype", ["int16", "uint8", "int32", "int8", "float32"])
def test_cast_like_jax_matches_astype(dtype):
    want = np.asarray(jnp.asarray(CAST_VALUES).astype(dtype))
    got = cast_like_jax(torch.from_numpy(CAST_VALUES), getattr(torch, dtype)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# windowing and thresholds (exact)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window,level", [(400.0, 40.0), (255.0, 127.5), (1.0, 40.0),
                                          (2000.0, -300.0)])
def test_windowing_exact(window, level):
    v = _vol((6, 17, 19), np.int16, seed=3)
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(
        windowing.get_lut_value_255(t, window, level).numpy(),
        np.asarray(win_jax.get_lut_value_255(v, window, level)))
    np.testing.assert_array_equal(
        windowing.apply_ww_wl_rgb(t, window, level).numpy(),
        np.asarray(win_jax.apply_ww_wl_rgb(v, window, level)))
    np.testing.assert_array_equal(
        windowing.get_opacity(t, level, window).numpy(),
        np.asarray(win_jax.get_opacity(v, level, window)))


@pytest.mark.parametrize("args", [(-1000.0, 3000.0), (-200.0, 1200.0, 0.0, 255.0),
                                  (0.0, 1000.0, -1.0, 1.0)])
def test_lut_value_normalized_exact(args):
    v = _vol((5, 23, 29), np.float32, seed=4)
    np.testing.assert_array_equal(
        windowing.get_lut_value_normalized(torch.from_numpy(v), *args).numpy(),
        np.asarray(win_jax.get_lut_value_normalized(v, *args)))


def test_opacity_zero_width_window_gives_nan_like_jax():
    v = np.array([[[20, 40, 60]]], np.int16)
    got = windowing.get_opacity(torch.from_numpy(v), 40.0, 0.0).numpy()
    want = np.asarray(win_jax.get_opacity(v, 40.0, 0.0))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(got, want)


def test_threshold_ops_exact_and_editor_codes_survive():
    v = _vol((7, 11, 13), np.int16, seed=5)
    r = np.random.default_rng(5)
    mask = r.choice(np.array([0, 1, 2, 253, 254, 255], np.uint8), size=v.shape)
    t, m = torch.from_numpy(v), torch.from_numpy(mask)
    for tmin, tmax in [(226, 3071), (-700, 225), (40.5, 40.5)]:
        got = threshold.threshold_mask(t, m, tmin, tmax).numpy()
        np.testing.assert_array_equal(got, np.asarray(thr_jax.threshold_mask(v, mask, tmin, tmax)))
        codes = np.isin(mask, const.MASK_EDIT_CODES)
        np.testing.assert_array_equal(got[codes], mask[codes])
        np.testing.assert_array_equal(
            threshold.threshold_new_mask(t, tmin, tmax).numpy(),
            np.asarray(thr_jax.threshold_new_mask(v, tmin, tmax)))
    np.testing.assert_array_equal(threshold.mask_visible(m).numpy(),
                                  np.asarray(thr_jax.mask_visible(mask)))
    p = r.random((4, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        threshold.apply_threshold_probability(torch.from_numpy(p), 0.5).numpy(),
        np.asarray(thr_jax.apply_threshold_probability(p, 0.5)))


# --------------------------------------------------------------------------
# projections
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", AXES)
def test_simple_projections_exact(axis, dtype, shape):
    v = _vol(shape, dtype, seed=axis)
    t = torch.from_numpy(v)
    for fn in ("maxip", "minip", "meanip"):
        got = getattr(projections, fn)(t, axis).numpy()
        want = np.asarray(getattr(proj_jax, fn)(v, axis))
        assert got.dtype == want.dtype, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", AXES)
def test_lmip_exact(axis, dtype, shape):
    v = _vol(shape, dtype, seed=10 + axis)
    (tmin, tmax), (wl, _) = _window(dtype)
    t = torch.from_numpy(v)
    for lo, hi in [(tmin, tmax), (wl, wl)]:   # tmin == tmax: the Slice's quirk
        got = projections.lmip(t, axis, lo, hi).numpy()
        want = np.asarray(proj_jax.lmip(v, axis, lo, hi))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", AXES)
def test_mida_within_atol_1(axis, dtype, shape):
    v = _vol(shape, dtype, seed=20 + axis)
    _, (wl, ww) = _window(dtype)
    t = torch.from_numpy(v)
    for w in [(wl, ww), (wl, wl), (0.0, 0.0)]:   # (wl, wl): the Slice's quirk
        got = projections.mida(t, axis, *w).numpy()
        want = np.asarray(proj_jax.mida(v, axis, *w))
        assert got.dtype == want.dtype
        _mida_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mida_constant_slab_nan_path(dtype):
    """rng = 0: every fpi is NaN; the integer cast maps it to 0, float32
    keeps NaN — as in JAX."""
    v = np.full((5, 6, 7), 77, dtype)
    for axis in AXES:
        got = projections.mida(torch.from_numpy(v), axis, 40.0, 40.0).numpy()
        want = np.asarray(proj_jax.mida(v, axis, 40.0, 40.0))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", AXES)
def test_fcm_intensity_within_atol_1(axis, dtype):
    v = _vol((12, 10, 11), dtype, seed=30 + axis)
    for n in (1.0, 2.0):
        got = projections.fcm_intensity(torch.from_numpy(v), n, axis).numpy()
        want = np.asarray(proj_jax.fcm_intensity(v, n, axis))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                                   atol=1, rtol=1e-6 if dtype == np.float32 else 0)


def test_fcm_intensity_saturates_past_int16():
    """|g| reaches about 32767 * sqrt(3): the cast saturates as JAX's does
    (torch's own cast would wrap)."""
    v = np.where(np.indices((6, 7, 8)).sum(0) % 2 == 0, 32000, -32000).astype(np.int16)
    for axis in AXES:
        got = projections.fcm_intensity(torch.from_numpy(v), 1.0, axis).numpy()
        want = np.asarray(proj_jax.fcm_intensity(v, 1.0, axis))
        assert want.max() == 32767
        np.testing.assert_allclose(got.astype(np.int64), want.astype(np.int64), atol=1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("tmip", [0, 1, 2])
def test_fast_contour_mip_within_atol_2(tmip, axis, dtype):
    v = _vol((12, 10, 11), dtype, seed=40 + axis)
    _, (wl, ww) = _window(dtype)
    got = projections.fast_contour_mip(torch.from_numpy(v), 1.0, axis, wl, ww, tmip).numpy()
    want = np.asarray(proj_jax.fast_contour_mip(v, 1.0, axis, wl, ww, tmip))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               atol=2, rtol=1e-5 if dtype == np.float32 else 0)


# --------------------------------------------------------------------------
# the plain versions against the TPU kernels (Pallas interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(9, 13, 150), (24, 20, 140)])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_ray_refs_match_the_pallas_kernels(dtype, shape):
    v = _vol(shape, dtype, seed=50)
    (tmin, tmax), (wl, ww) = _window(dtype)
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(
        rays.lmip_ref(t, 0, tmin, tmax).numpy(),
        np.asarray(pallas_kernels.lmip_axis0(jnp.asarray(v), tmin, tmax)))
    _mida_close(rays.mida_ref(t, 0, wl, ww).numpy(),
                np.asarray(pallas_kernels.mida_axis0(jnp.asarray(v), wl, ww)), dtype)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    v = torch.from_numpy(_vol((9, 13, 150), np.int16, seed=60))
    rays.reset_launches()
    for axis in AXES:
        slab = v.narrow(axis, 2, 5)
        assert torch.equal(rays.lmip_rays(slab, axis, 30.0, 500.0),
                           rays.lmip_ref(slab, axis, 30.0, 500.0))
        assert torch.equal(rays.mida_rays(slab, axis, 40.0, 400.0),
                           rays.mida_ref(slab, axis, 40.0, 400.0))
    assert all(n == 0 for per_axis in rays.LAUNCHES.values()
               for n in per_axis.values())


@pytest.mark.parametrize("fn", [rays.lmip_rays, rays.mida_rays,
                                rays.lmip_ref, rays.mida_ref])
def test_wrappers_reject_bad_arguments(fn):
    v = torch.zeros((4, 5, 6), dtype=torch.int16)
    with pytest.raises(ValueError, match="3-D"):
        fn(v[0], 0, 1.0, 2.0)
    with pytest.raises(ValueError, match="axis"):
        fn(v, 3, 1.0, 2.0)
    with pytest.raises(ValueError, match="empty"):
        fn(v.narrow(1, 0, 0), 1, 1.0, 2.0)
    with pytest.raises(TypeError, match="dtype"):
        fn(v.bool(), 0, 1.0, 2.0)


def test_wrappers_refuse_other_devices():
    v = torch.zeros((4, 5, 6), dtype=torch.int16, device="meta")
    for fn in (rays.lmip_rays, rays.mida_rays):
        with pytest.raises(ValueError, match="device"):
            fn(v, 0, 1.0, 2.0)


# --------------------------------------------------------------------------
# the ray kernels' edge cases (shared with the card's tests and
# chip_smoke.py phase [6]) through the plain versions, against the JAX
# package's projections and its Pallas kernels in interpret mode
# --------------------------------------------------------------------------

EDGE_WORDS = ("odd x", "offset 1", "long rows", "rays of", "every other", "capacity",
              "full range", "NaN")
EDGE_CASES = [c for c in rays.ray_cases() if any(w in c.label for w in EDGE_WORDS)]


def _mida_close_nan(got, want, dtype):
    both = np.isnan(got) & np.isnan(want) if got.dtype.kind == "f" else False
    _mida_close(np.where(both, 0, got), np.where(both, 0, want), dtype)


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c.label for c in EDGE_CASES])
def test_ray_refs_on_the_edge_cases(case):
    slab = rays.case_slab(case, "cpu")
    v, axis, dtype = slab.numpy(), case.axis, case.volume.dtype
    (tmin, tmax), (wl, ww) = _window(dtype)
    lmip = rays.lmip_ref(slab, axis, tmin, tmax).numpy()
    mida = rays.mida_ref(slab, axis, wl, ww).numpy()
    np.testing.assert_array_equal(lmip, np.asarray(proj_jax.lmip(v, axis, tmin, tmax)))
    _mida_close_nan(mida, np.asarray(proj_jax.mida(v, axis, wl, ww)), dtype)
    v0 = jnp.asarray(np.ascontiguousarray(np.moveaxis(v, axis, 0)))
    np.testing.assert_array_equal(
        lmip, np.asarray(pallas_kernels.lmip_axis0(v0, tmin, tmax)))
    _mida_close_nan(mida, np.asarray(pallas_kernels.mida_axis0(v0, wl, ww)), dtype)
    if "NaN" in case.label:   # the slab's min and max are NaN: so is every pixel
        assert np.isnan(mida).all()


def test_edge_cases_build_the_layouts_they_name():
    labels = [c.label for c in rays.ray_cases()]
    assert len(labels) == len(set(labels))
    for case in EDGE_CASES:
        slab = rays.case_slab(case, "cpu")
        want = case.volume[:, ::case.step, ::case.step]
        assert slab.shape == want.shape
        assert slab.storage_offset() == case.offset
        np.testing.assert_array_equal(slab.numpy(), want)
    by_label = {c.label: c for c in EDGE_CASES}
    # odd x: int16 rows start off 4-byte alignment on the rows route
    assert by_label["(7, 9, 101) int16 odd x axis 2"].volume.shape[2] % 2
    stepped = [c for c in rays.ray_cases() if c.step != 1]
    assert len(stepped) == 3
    for case in stepped:   # rays and columns strided: the columns route
        slab = rays.case_slab(case, "cpu")
        g = rays.ray_geometry(slab.shape, slab.stride(), case.axis)
        assert g[1] != 1 and g[5] != 1
        assert rays.ray_route(g[1], g[5]) == rays.ROUTE_COLUMNS
    cap = rays.TABLE_CAP[torch.int16]
    for label, fits in (("at", True), ("one past", False)):
        v = by_label[f"int16 range {label} the table's capacity axis 0"].volume
        assert rays.table_fits(float(v.min()), float(v.max()), torch.int16) is fits
        assert int(v.max()) - int(v.min()) + 1 == cap + (not fits)


# --------------------------------------------------------------------------
# the wrappers' choices
# --------------------------------------------------------------------------

STORE_VALUES = np.concatenate([
    CAST_VALUES, np.random.default_rng(7).uniform(-7e4, 7e4, 2000).astype(np.float32),
    np.array([32767.0, 32767.5, -32768.0, -32768.5, 254.99, 255.0, 0.0, -0.0,
              -0.99], np.float32)])


@pytest.mark.parametrize("dtype", [torch.int16, torch.uint8, torch.float32])
def test_store_cast_is_cast_like_jax(dtype):
    x = torch.from_numpy(STORE_VALUES)
    got, want = rays.store_cast(x, dtype), cast_like_jax(x, dtype)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want) or torch.equal(got.isnan(), want.isnan())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("dtype,stored", [
    (torch.int16, torch.int16), (torch.uint8, torch.uint8), (torch.float32, torch.float32),
    (torch.int32, torch.float32), (torch.int8, torch.float32),
    (torch.float64, torch.float32), (torch.float16, torch.float32)])
def test_store_dtype(dtype, stored):
    assert rays.store_dtype(dtype) == stored


def _plan(view, axis):
    g = rays.ray_geometry(view.shape, view.stride(), axis)
    return g, rays.ray_route(g[1], g[5])


@pytest.mark.parametrize("axis,route", [(0, rays.ROUTE_COLUMNS), (1, rays.ROUTE_COLUMNS),
                                        (2, rays.ROUTE_ROWS)])
def test_route_by_axis_of_a_volume_and_its_narrowed_slabs(axis, route):
    v = torch.zeros((8, 9, 10), dtype=torch.int16)
    for view in (v, v.narrow(axis, 2, 5), v.narrow((axis + 1) % 3, 1, 3),
                 torch.flip(v.narrow(axis, 1, 4), dims=(axis,))):
        g, r = _plan(view, axis)
        assert r == route
        assert g[0] == view.shape[axis] and g[2] * g[3] * g[0] == view.numel()


def test_route_of_other_layouts():
    v = torch.zeros((8, 9, 10), dtype=torch.int16)
    # a permuted view: axis 0's rays are contiguous rows (the rows route);
    # axis 2's rays are 90 apart and its columns 10 (the columns route)
    assert _plan(v.permute(2, 1, 0), 0)[1] == rays.ROUTE_ROWS
    assert _plan(v.permute(2, 1, 0), 2)[1] == rays.ROUTE_COLUMNS
    # rays of length 1 along x: both strides 1, the columns route
    assert _plan(torch.zeros((4, 6, 1)), 2)[1] == rays.ROUTE_COLUMNS
    assert _plan(torch.zeros((4, 6, 2)), 2)[1] == rays.ROUTE_ROWS
    # a step-sliced x: rays 2 apart, the columns route
    assert _plan(v[:, :, ::2], 2)[1] == rays.ROUTE_COLUMNS
    assert _plan(v[:, :, ::2], 0)[1] == rays.ROUTE_COLUMNS


@pytest.mark.parametrize("view", ["whole", "narrow0", "narrow1", "narrow2", "permuted",
                                  "stepped", "expanded", "offset"])
def test_flat_view_covers_the_slab(view):
    base = torch.arange(8 * 9 * 10, dtype=torch.float32).reshape(8, 9, 10)
    t = {"whole": base, "narrow0": base.narrow(0, 2, 3), "narrow1": base.narrow(1, 2, 3),
         "narrow2": base.narrow(2, 2, 3), "permuted": base.permute(2, 0, 1),
         "stepped": base[:, ::2, 1::3], "expanded": base[:1, :1].expand(4, 9, 10),
         "offset": base.reshape(-1)[1:1 + 7 * 9 * 10].view(7, 9, 10)}[view]
    d0, d1, n, s0, s1, s2 = rays.flat_view(t.shape, t.stride())
    flat = torch.as_strided(base, (d0, d1, n), (s0, s1, s2), t.storage_offset())
    assert torch.equal(flat.reshape(-1).sort().values, t.reshape(-1).sort().values)
    if view in ("whole", "narrow0", "permuted", "offset"):
        assert (d0, d1, s2) == (1, 1, 1)       # one contiguous run
    if view in ("narrow1", "narrow2"):
        assert (d0, s2) == (1, 1)              # rows of one contiguous run


@pytest.mark.parametrize("dtype,vmin,vmax,fits", [
    (torch.int16, -1024.0, 3071.0, True), (torch.int16, -1024.0, 3072.0, False),
    (torch.int16, -1020.0, 1219.0, True), (torch.int16, 77.0, 77.0, True),
    (torch.uint8, 0.0, 255.0, True), (torch.float32, 0.0, 1.0, False),
    (torch.int32, 0.0, 1.0, False)])
def test_table_fits(dtype, vmin, vmax, fits):
    assert rays.table_fits(vmin, vmax, dtype) is fits


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
def test_slab_minmax_on_the_cpu_is_aminmax(dtype):
    v = torch.from_numpy(_vol((9, 13, 150), dtype, seed=70))
    for axis in AXES:
        slab = v.narrow(axis, 2, 5)
        want = torch.tensor([float(slab.min()), float(slab.max())], dtype=torch.float32)
        assert torch.equal(rays.slab_minmax(slab), want)
    if dtype == np.float32:
        w = v.clone()
        w[3, 4, 5] = float("nan")
        assert torch.isnan(rays.slab_minmax(w)).all()

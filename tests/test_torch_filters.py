"""The port's image filters, ``Slice.apply_image_filter`` (3D and 2D along
each axis) and ``Slice.calc_mask_area`` against the JAX package's, on the
CPU, from the same seeded numpy inputs.

Tolerances:
- float32 filter outputs: within 1e-5 of the input image's range;
- integer-typed filter outputs: within 1 grey level, and equal on at least
  99.9% of voxels (XLA on the CPU contracts ``acc + w * x`` into a fused
  multiply-add; the port rounds the product and the sum each on its own,
  see ``ops/filters.py``);
- median, the kernel, the padding and the area's voxel terms: exact;
  ``calc_mask_area``: within a relative 1e-5 (the JAX package sums in
  float32), and against an exposed-face count in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu import events as events_jax
from invesalius3_tpu.core.slice import Slice as SliceJax
from invesalius3_tpu.core.volume import Volume as VolumeJax
from invesalius3_tpu.ops import filters as filters_jax
from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch import convert, events
from invesalius3_tpu_torch.ops import filters

torch.set_num_threads(1)

SHAPE = (14, 18, 16)
DTYPES = [np.int16, np.uint8, np.float32]
ORIENTATIONS = [const.AXIAL, const.CORONAL, const.SAGITTAL]


def _vol(dtype, seed=0, shape=SHAPE):
    r = np.random.default_rng(seed)
    if dtype == np.uint8:
        return r.integers(0, 256, shape).astype(np.uint8)
    if dtype == np.int16:
        v = np.full(shape, -1000, np.int16)
        zz, yy, xx = np.indices(shape)
        v[(zz - 7) ** 2 + (yy - 9) ** 2 + (xx - 8) ** 2 < 40] = 1200
        return v + r.integers(-60, 60, shape).astype(np.int16)
    return (r.standard_normal(shape) * 300.0).astype(np.float32)


def _close(got, want, image):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if np.issubdtype(want.dtype, np.floating):
        span = float(np.ptp(np.asarray(image, np.float64)))
        assert d.max() <= 1e-5 * span, d.max()
    else:
        assert d.max() <= 1, d.max()
        assert (d == 0).mean() >= 0.999, (d == 0).mean()


# name -> (port call, JAX call)
CALLS = {
    "gaussian": (lambda v, **k: filters.gaussian(v, 1.0, **k), lambda v: filters_jax.gaussian(v, 1.0)),
    "gaussian_s2": (lambda v, **k: filters.gaussian(v, 2.0, **k),
                    lambda v: filters_jax.gaussian(v, 2.0)),
    "mean3": (lambda v, **k: filters.mean(v, 3, **k), lambda v: filters_jax.mean(v, 3)),
    "mean5": (lambda v, **k: filters.mean(v, 5, **k), lambda v: filters_jax.mean(v, 5)),
    "median3": (lambda v, **k: filters.median(v, 3, **k), lambda v: filters_jax.median(v, 3)),
    "median5": (lambda v, **k: filters.median(v, 5, **k), lambda v: filters_jax.median(v, 5)),
    "unsharp": (lambda v, **k: filters.unsharp(v, 1.0, 1.5, **k),
                lambda v: filters_jax.unsharp(v, 1.0, 1.5)),
    "sharpen": (lambda v, **k: filters.sharpen(v, 1.3, **k), lambda v: filters_jax.sharpen(v, 1.3)),
    "despeckle": (lambda v, **k: filters.despeckle(v, 1.5, **k),
                  lambda v: filters_jax.despeckle(v, 1.5)),
    "border": (lambda v, **k: filters.border_detection(v, 1.0, **k),
               lambda v: filters_jax.border_detection(v, 1.0)),
}
EXACT = {"median3", "median5"}


@pytest.mark.parametrize("name", sorted(CALLS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_filter_3d(name, dtype):
    v = _vol(dtype)
    port, ref = CALLS[name]
    got, want = port(torch.from_numpy(v)), np.asarray(ref(jnp.asarray(v)))
    if name in EXACT:
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got, want, v)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_filter_batch_axis_is_vmap(name):
    """``batch_dims=1``: every slice filtered on its own, as ``jax.vmap`` of
    the JAX filter over the first axis does (per-slice min/max too)."""
    v = _vol(np.int16, seed=1)
    port, ref = CALLS[name]
    got = port(torch.from_numpy(v), batch_dims=1)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(v)))
    if name in EXACT:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got, want, v)


def test_filters_on_2d_images():
    v = _vol(np.float32, seed=2)[5]
    for name, (port, ref) in CALLS.items():
        _close(port(torch.from_numpy(v)), ref(jnp.asarray(v)), v)


def test_filters_table():
    assert sorted(filters.FILTERS) == sorted(filters_jax.FILTERS)


@pytest.mark.parametrize("sigma", [1.0, 0.7, 2.5])
def test_gauss_kernel1d(sigma):
    got = filters._gauss_kernel1d(sigma)
    want = filters_jax._gauss_kernel1d(sigma)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(1, 1), (4, 4), (2, 0), (9, 13)])
def test_sym_pad_is_numpy_symmetric(lo, hi):
    x = np.arange(5 * 7).reshape(5, 7)
    got = filters._sym_pad(torch.from_numpy(x), 1, lo, hi).numpy()
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (lo, hi)), mode="symmetric"))


def test_median_chunks_and_nan(monkeypatch):
    v = _vol(np.float32, seed=3)
    whole = filters.median(torch.from_numpy(v), 3)
    monkeypatch.setattr(filters, "_MEDIAN_CHUNK_BYTES", 1)
    assert torch.equal(filters.median(torch.from_numpy(v), 3), whole)
    assert torch.equal(filters.median(torch.from_numpy(v), 5, batch_dims=1),
                       torch.from_numpy(np.asarray(jax.vmap(
                           lambda s: filters_jax.median(s, 5))(jnp.asarray(v)))))
    v[3, 4, 5] = np.nan
    got = filters.median(torch.from_numpy(v), 3).numpy()
    want = np.asarray(filters_jax.median(jnp.asarray(v), 3))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


@pytest.mark.parametrize("cval", [0.0, 1.0, -2.5])
def test_convolve_non_zero(cval):
    r = np.random.default_rng(4)
    v = np.where(r.random(SHAPE) < 0.6, r.standard_normal(SHAPE), 0.0).astype(np.float32)
    k = r.standard_normal((3, 3, 3)).astype(np.float32)
    got = filters.convolve_non_zero(torch.from_numpy(v), k, cval)
    want = np.asarray(filters_jax.convolve_non_zero(jnp.asarray(v), jnp.asarray(k), cval))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got.numpy()[v == 0] == 0).all()
    # an even-sized kernel pads one more on the low side, as in JAX
    k2 = r.standard_normal((2, 3, 4)).astype(np.float32)
    got = filters.convolve_non_zero(torch.from_numpy(v), torch.from_numpy(k2), cval)
    want = np.asarray(filters_jax.convolve_non_zero(jnp.asarray(v), jnp.asarray(k2), cval))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# Slice.apply_image_filter and Slice.calc_mask_area
# --------------------------------------------------------------------------

def _record(bus, module):
    log = []

    @module.wants_topic
    def listener(topic, **kw):
        log.append((topic, kw))

    bus.subscribe(listener, module.ALL_TOPICS)
    return log


def _pair(spacing=(0.8, 0.9, 1.25)):
    sj = SliceJax(VolumeJax.from_numpy(_vol(np.int16, seed=5), spacing=spacing),
                  bus=events_jax.Publisher())
    sj.create_new_mask(threshold_range=(300, 3071))
    sp = convert.slice_from_jax(sj, device="cpu", bus=events.Publisher())
    return sj, sp


FILTER_CASES = [(f, "3D", const.AXIAL) for f in sorted(const.FILTER_NAMES)] + [
    (f, "2D", o) for f in (const.FILTER_GAUSSIAN, const.FILTER_MEDIAN, const.FILTER_SHARPEN,
                           const.FILTER_BORDER) for o in ORIENTATIONS]


@pytest.mark.parametrize("filter_type,dimension,orientation", FILTER_CASES)
def test_apply_image_filter(filter_type, dimension, orientation):
    sj, sp = _pair()
    log_j, log_p = _record(sj.bus, events_jax), _record(sp.bus, events)
    value = 1.0 if filter_type != const.FILTER_MEDIAN else 2.0  # median 5
    lj = sj.apply_image_filter(filter_type, value, dimension, orientation)
    lp = sp.apply_image_filter(filter_type, value, dimension, orientation)
    assert lp == lj == "Filtered 1" and sp.current_image_label == lj
    want = np.asarray(sj.matrix)
    if filter_type == const.FILTER_MEDIAN:
        np.testing.assert_array_equal(sp.matrix.numpy(), want)
    else:
        _close(sp.matrix, want, _vol(np.int16, seed=5))
    assert sp.matrix.is_contiguous()
    assert [t for t, _ in log_p] == [t for t, _ in log_j]
    assert log_p[-1] == log_j[-1]
    # the thresholded mask follows the new version (it was not edited)
    np.testing.assert_array_equal(sp.current_mask.data.numpy(), np.asarray(sj.current_mask.data))
    assert [lbl for lbl, _ in sp.image_versions] == ["original", "Filtered 1"]


def test_apply_image_filter_keeps_versions():
    sj, sp = _pair()
    for s in (sj, sp):
        s.apply_image_filter(const.FILTER_GAUSSIAN, 1.0)
        s.select_image_version("original")
        s.apply_image_filter(const.FILTER_MEAN, 1.0, "2D", const.SAGITTAL)
    assert [lbl for lbl, _ in sp.image_versions] == ["original", "Filtered 1", "Filtered 2"]
    np.testing.assert_array_equal(sp.image_versions[0][1].numpy(), _vol(np.int16, seed=5))
    _close(sp.matrix, np.asarray(sj.matrix), _vol(np.int16, seed=5))


def _exposed_faces(vis, spacing):
    """Exposed-face area in float64: a face per mask voxel and 6-neighbour
    outside the mask; the volume's border counts as inside."""
    sx, sy, sz = spacing
    area = 0.0
    for axis, face in ((0, sx * sy), (1, sx * sz), (2, sy * sz)):
        pad = [(1, 1) if a == axis else (0, 0) for a in range(3)]
        p = np.pad(vis, pad, constant_values=True)
        n = vis.shape[axis]
        for sl in (slice(0, n), slice(2, n + 2)):
            idx = [slice(None)] * 3
            idx[axis] = sl
            area += face * int((vis & ~p[tuple(idx)]).sum())
    return area


@pytest.mark.parametrize("spacing", [(0.8, 0.9, 1.25), (0.5, 0.5, 0.5), (0.33, 0.41, 2.0)])
def test_calc_mask_area(spacing):
    sj, sp = _pair(spacing)
    vis = sp.current_mask.visible_array().numpy()
    assert vis.any() and not vis.all()
    got, want = sp.calc_mask_area(), sj.calc_mask_area()
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(_exposed_faces(vis, spacing), rel=1e-5)

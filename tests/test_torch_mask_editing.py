"""The slice viewer's mask-editing tools of the port against the JAX
package's, on the CPU, from the same seeded numpy inputs: structuring
elements, binary morphology, brushes (paint, erase and the four threshold
ops), the floodfill family, connected components, automatic hole filling
through ``Mask`` with undo/redo, and the whole editing sequence on a small
``make_ct`` (the sequence ``chip_smoke.py`` phase [10] drives at 512^3).

Tolerance: none.  Masks, labels, counts, brush and fill results are
bit-exact (equal arrays of equal dtype); the fixpoint check counts equal
the JAX loop's, which follow from the BFS depth.
"""

import importlib
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from invesalius3_tpu import constants as const_jax
from invesalius3_tpu import events as events_jax
from invesalius3_tpu.core.mask import Mask as MaskJax
from invesalius3_tpu.core.slice import Slice as SliceJax
from invesalius3_tpu.core.volume import Volume as VolumeJax
from invesalius3_tpu.ops import connected as conn_jax
from invesalius3_tpu.ops import floodfill as ff_jax
from invesalius3_tpu.ops import morphology as morph_jax
from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch import convert, events, pipeline
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.ops import connected, floodfill, morphology

torch.set_num_threads(1)

SHAPE = (20, 24, 22)
CONNS = [6, 18, 26]
THRESH_OPS = ["thresh", "thresh_erase", "thresh_add", "thresh_erase_only"]
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    """Bit-exact: equal dtype, shape and values."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _rand_mask(p, seed=0, shape=SHAPE):
    return np.random.default_rng(seed).random(shape) < p


def _ct(shape=SHAPE, seed=0):
    """A small head-like int16 CT: air, soft tissue (40 HU), a bone shell
    and an inner bone island, with noise."""
    r = np.random.default_rng(seed)
    zz, yy, xx = np.indices(shape).astype(np.float32)
    c = [(s - 1) / 2.0 for s in shape]
    rad = np.sqrt(sum(((g - ci) / (s / 2.2)) ** 2 for g, ci, s in zip((zz, yy, xx), c, shape)))
    ct = np.full(shape, -1000.0, np.float32)
    ct[rad < 1.0] = 40
    ct[(rad >= 0.75) & (rad < 1.0)] = 1200
    ct[rad < 0.3] = 900
    ct += r.integers(-20, 20, shape)
    return ct.astype(np.int16)


# --------------------------------------------------------------------------
# structuring elements and binary morphology
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [1, 2, 3])
@pytest.mark.parametrize("connectivity", [1, 2, 3])
def test_generate_binary_structure(rank, connectivity):
    got = morphology.generate_binary_structure(rank, connectivity)
    _eq(got, morph_jax.generate_binary_structure(rank, connectivity))
    _eq(got, ndi.generate_binary_structure(rank, connectivity))


def test_structures_and_offsets():
    for conn in (4, 8):
        _eq(morphology.structure_2d(conn), morph_jax.structure_2d(conn))
    for conn in CONNS:
        s = morphology.structure_3d(conn)
        _eq(s, morph_jax.structure_3d(conn))
        assert morphology._offsets(s) == morph_jax._offsets(s)
        assert len(morphology._offsets(s)) == conn + 1
    odd = np.zeros((5, 1, 3), bool)
    odd[0, 0, 2] = odd[4, 0, 0] = odd[2, 0, 1] = True
    assert morphology._offsets(odd) == morph_jax._offsets(odd) == (
        (-2, 0, 1), (0, 0, 0), (2, 0, -1))


BINARY_OPS = ["binary_dilation", "binary_erosion", "binary_opening", "binary_closing"]


@pytest.mark.parametrize("op", BINARY_OPS)
@pytest.mark.parametrize("conn", CONNS)
def test_binary_morphology(op, conn):
    m = _rand_mask(0.45, seed=conn)
    s = morphology.structure_3d(conn)
    want = getattr(morph_jax, op)(jnp.asarray(m), s)
    _eq(getattr(morphology, op)(_t(m), s), want)
    # a uint8 mask is read as mask != 0
    _eq(getattr(morphology, op)(_t(m.astype(np.uint8) * 7), s), want)


@pytest.mark.parametrize("op", BINARY_OPS)
def test_binary_morphology_2d_and_wide_elements(op):
    m2 = _rand_mask(0.5, seed=3, shape=(17, 23))
    for conn in (4, 8):
        s = morphology.structure_2d(conn)
        _eq(getattr(morphology, op)(_t(m2), s), getattr(morph_jax, op)(jnp.asarray(m2), s))
    # an element wider than the volume along one axis (shifts that leave
    # nothing) and an asymmetric one
    m3 = _rand_mask(0.6, seed=4, shape=(2, 9, 11))
    wide = np.ones((5, 3, 1), bool)
    odd = np.zeros((3, 3, 3), bool)
    odd[1, 1, 1] = odd[0, 2, 1] = odd[1, 1, 0] = True
    for s in (wide, odd):
        _eq(getattr(morphology, op)(_t(m3), s), getattr(morph_jax, op)(jnp.asarray(m3), s))


def test_shift_slices_match_shift_nd():
    x = torch.arange(4 * 5 * 6, dtype=torch.int32).reshape(4, 5, 6) + 1
    for off in [(1, 0, -2), (-3, 4, 0), (0, -1, 5), (4, 0, 0), (0, 0, -6), (2, -2, 1)]:
        want = morphology.shift_nd(x, off, fill=0)
        got = torch.zeros_like(x)
        sl = morphology.shift_slices(x.shape, off)
        if sl is not None:
            got[sl[0]] = x[sl[1]]
        assert torch.equal(got, want), off


# --------------------------------------------------------------------------
# brushes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [const.BRUSH_CIRCLE, const.BRUSH_SQUARE])
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("radius,spacing", [(2.0, (1.0, 0.8, 1.2)), (1.1, (0.5, 0.5, 0.5)),
                                            (0.2, (0.5, 0.5, 0.5))])
def test_brush_element(shape, dims, radius, spacing):
    got = morphology.brush_element(radius, spacing, shape, dims)
    _eq(got, morph_jax.brush_element(radius, spacing, shape, dims))
    assert got.ndim == dims


def _centers(shape):
    """Interior, overlapping, border and out-of-volume stamp centres."""
    Z, Y, X = shape
    return np.array([(Z // 2, Y // 2, X // 2), (Z // 2 + 1, Y // 2, X // 2 + 1),
                     (0, 0, 0), (Z - 1, Y - 1, X - 1), (1, Y - 2, 0), (Z - 1, 0, X // 2),
                     (-3, Y + 4, 5), (5, 5, X - 1)], np.int32)


def _oracle_stroke(mask, image, brush, centers, op, value=254, tmin=0, tmax=0):
    """Stamp by stamp in numpy, each stamp clamped as lax.dynamic_slice
    clamps it (the JAX scan's behaviour; tests/test_segmentation_ops.py)."""
    out = mask.copy()
    for c in centers:
        start = [min(max(int(ci) - s // 2, 0), m - s)
                 for ci, s, m in zip(c, brush.shape, mask.shape)]
        sl = tuple(slice(st, st + s) for st, s in zip(start, brush.shape))
        roi = out[sl]
        inside = (image[sl] >= tmin) & (image[sl] <= tmax) if image is not None else None
        if op == "paint":
            roi[brush] = value
        elif op == "thresh":
            roi[brush] = np.where(inside, 254, 1)[brush]
        elif op == "thresh_erase":
            roi[brush] = np.where(inside, 1, 254)[brush]
        elif op == "thresh_add":
            roi[brush & inside] = 254
        else:
            roi[brush & ~inside] = 1
    return out


@pytest.mark.parametrize("shape", [const.BRUSH_CIRCLE, const.BRUSH_SQUARE])
@pytest.mark.parametrize("dims", [2, 3])
def test_paint_brush_clips(shape, dims):
    mask0 = (_rand_mask(0.3, seed=5)).astype(np.uint8) * 255
    brush = morphology.brush_element(2.0, (1.0, 0.8, 1.2), shape, dims)
    m = mask0 if dims == 3 else mask0[7]
    for c in _centers(SHAPE).tolist() + [[30, 1, 1], [-9, 2, 2]]:
        c = c if dims == 3 else c[1:]
        for value in (254, 1):
            want = morph_jax.paint_brush(jnp.asarray(m), brush, c, value)
            _eq(morphology.paint_brush(_t(m), brush, c, value), want)


@pytest.mark.parametrize("shape", [const.BRUSH_CIRCLE, const.BRUSH_SQUARE])
@pytest.mark.parametrize("value", [254, 1])
@pytest.mark.parametrize("dims", [2, 3])
def test_paint_brush_trajectory(shape, value, dims):
    """Overlapping, border and out-of-volume stamps: the port's one union
    of the footprints equals the JAX scan and the stamp-by-stamp oracle.
    A 2D brush strokes one slice as a (1, H, W) brush."""
    mask0 = (_rand_mask(0.3, seed=6)).astype(np.uint8) * 255
    brush = morphology.brush_element(2.0, (1.0, 0.8, 1.2), shape, dims)
    if dims == 2:
        brush = brush[None]
    centers = _centers(SHAPE)
    want = morph_jax.paint_brush_trajectory(
        jnp.asarray(mask0), jnp.asarray(brush), jnp.asarray(centers), value,
        tuple(brush.shape))
    got = morphology.paint_brush_trajectory(_t(mask0), brush, centers, value,
                                            tuple(brush.shape))
    _eq(got, want)
    _eq(got, _oracle_stroke(mask0, None, brush, centers, "paint", value))
    assert (got.numpy() != mask0).any()


@pytest.mark.parametrize("op", THRESH_OPS)
@pytest.mark.parametrize("shape", [const.BRUSH_CIRCLE, const.BRUSH_SQUARE])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("dims", [2, 3])
def test_threshold_brush(op, shape, dtype, dims):
    """Every threshold op with border stamps, a 3D brush and a 2D one as a
    (1, H, W) brush; the bounds are cast to the image's dtype first (an
    int16 image truncates 650.7 and -150.2)."""
    rng = np.random.default_rng(7)
    image = rng.integers(-500, 1500, SHAPE).astype(dtype)
    mask0 = (rng.random(SHAPE) < 0.3).astype(np.uint8) * 255
    brush = morphology.brush_element(2.0, (1.0, 0.8, 1.2), shape, dims)
    brush = brush if dims == 3 else brush[None]
    centers = _centers(SHAPE)
    tmin, tmax = -150.2, 650.7
    want = morph_jax.paint_brush_trajectory_threshold(
        jnp.asarray(mask0), jnp.asarray(image), jnp.asarray(brush),
        jnp.asarray(centers), tmin, tmax, tuple(brush.shape), op)
    got = morphology.paint_brush_trajectory_threshold(
        _t(mask0), _t(image), brush, centers, tmin, tmax, tuple(brush.shape), op)
    _eq(got, want)
    lo, hi = (np.array([tmin, tmax]).astype(dtype) if dtype != np.float32
              else np.float32([tmin, tmax]))
    _eq(got, _oracle_stroke(mask0, image, brush, centers, op, tmin=lo, tmax=hi))
    assert (got.numpy() != mask0).any()


@pytest.mark.parametrize("op", ["paint", "erase"] + THRESH_OPS)
def test_stroke_as_one_union_equals_stamp_by_stamp(op, monkeypatch):
    """The whole stroke at once, in chunks of one stamp, and one stamp a
    call in sequence give equal arrays."""
    rng = np.random.default_rng(8)
    image = _t(rng.integers(-500, 1500, SHAPE).astype(np.int16))
    mask0 = _t((rng.random(SHAPE) < 0.4).astype(np.uint8) * 255)
    brush = morphology.brush_element(3.0, (1.0, 1.0, 1.0), const.BRUSH_CIRCLE)
    centers = _centers(SHAPE)

    def stroke(m, cs):
        if op in ("paint", "erase"):
            return morphology.paint_brush_trajectory(m, brush, cs, 254 if op == "paint" else 1,
                                                     brush.shape)
        return morphology.paint_brush_trajectory_threshold(m, image, brush, cs, 0, 700,
                                                           brush.shape, op)

    whole = stroke(mask0, centers)
    seq = mask0
    for c in centers:
        seq = stroke(seq, c[None])
    assert torch.equal(whole, seq)
    monkeypatch.setattr(morphology, "_STROKE_CHUNK", 1)
    assert torch.equal(stroke(mask0, centers), whole)
    assert torch.equal(stroke(mask0, centers[::-1].copy()), whole)


def test_stroke_edge_cases():
    mask0 = torch.zeros(SHAPE, dtype=torch.uint8)
    brush = morphology.brush_element(2.0, (1.0, 1.0, 1.0))
    empty = morphology.paint_brush_trajectory(mask0, brush, np.zeros((0, 3), np.int32),
                                              254, brush.shape)
    assert torch.equal(empty, mask0) and empty is not mask0
    big = np.ones((21, 3, 3), bool)  # taller than the volume: an error, as in JAX
    with pytest.raises(ValueError, match="larger than the volume"):
        morphology.paint_brush_trajectory(mask0, big, [(1, 1, 1)], 254, big.shape)
    with pytest.raises(Exception):
        morph_jax.paint_brush_trajectory(jnp.zeros(SHAPE, jnp.uint8), jnp.asarray(big),
                                         jnp.asarray([(1, 1, 1)]), 254, big.shape)
    with pytest.raises(ValueError, match="unknown threshold-brush op"):
        morphology.paint_brush_trajectory_threshold(mask0, mask0, brush, [(1, 1, 1)], 0, 1,
                                                    brush.shape, "nope")
    # the input mask is never written
    out = morphology.paint_brush_trajectory(mask0, brush, [(5, 5, 5)], 254, brush.shape)
    assert int(mask0.sum()) == 0 and int((out == 254).sum()) == int(brush.sum())


# --------------------------------------------------------------------------
# the floodfill family
# --------------------------------------------------------------------------

def _bfs_checks(seeds, allowed, strct):
    """The JAX loop's checks from the BFS depth s: ceil(s / 8) + 1."""
    r = seeds & allowed
    steps = 0
    while True:
        nxt = r | (ndi.binary_dilation(r, strct) & allowed)
        if np.array_equal(nxt, r):
            break
        r, steps = nxt, steps + 1
    return math.ceil(steps / floodfill._STEPS_PER_CHECK) + 1, r


def test_seeds_to_mask():
    seeds = [(1, 2, 3), (19, 23, 21), (0, 0, 0)]
    _eq(floodfill.seeds_to_mask(SHAPE, seeds, device="cpu"), ff_jax.seeds_to_mask(SHAPE, seeds))


@pytest.mark.parametrize("conn", CONNS)
def test_floodfill_threshold(conn):
    ct = _ct()
    seeds = ff_jax.seeds_to_mask(SHAPE, [(10, 12, 2), (10, 2, 11)])  # shell, twice
    s = morphology.structure_3d(conn)
    want = ff_jax.floodfill_threshold(jnp.asarray(ct), seeds, 226, 3071, s)
    checks = []
    got = floodfill.floodfill_threshold(_t(ct), _t(np.asarray(seeds)), 226, 3071, s,
                                        checks=checks)
    _eq(got, want)
    n_checks, reach = _bfs_checks(np.asarray(seeds), (ct >= 226) & (ct <= 3071), s)
    _eq(got, reach)
    assert checks == [n_checks] and n_checks > 2
    # float bounds against an int16 image compare in float32, as in JAX
    want = ff_jax.floodfill_threshold(jnp.asarray(ct), seeds, 25.5, 1210.5, s)
    _eq(floodfill.floodfill_threshold(_t(ct), _t(np.asarray(seeds)), 25.5, 1210.5, s), want)


@pytest.mark.parametrize("conn", CONNS)
def test_floodfill_value(conn):
    labels = np.random.default_rng(9).integers(0, 3, SHAPE).astype(np.int16)
    seeds = np.zeros(SHAPE, bool)
    seeds[4, 5, 6] = seeds[15, 3, 20] = True
    s = morphology.structure_3d(conn)
    for value in (0, 1):
        want = ff_jax.floodfill_value(jnp.asarray(labels), jnp.asarray(seeds), value, s)
        _eq(floodfill.floodfill_value(_t(labels), _t(seeds), value, s), want)


@pytest.mark.parametrize("dtype", [np.int16, np.uint8])
@pytest.mark.parametrize("p", [0.15, 0.4])
def test_floodfill_auto_threshold(dtype, p):
    rng = np.random.default_rng(10)
    data = rng.integers(40, 220, SHAPE).astype(dtype)
    data[:, :, 11:] = rng.integers(150, 160, (SHAPE[0], SHAPE[1], 11)).astype(dtype)
    seeds = np.zeros(SHAPE, bool)
    seeds[10, 12, 16] = seeds[3, 4, 5] = True
    want = ff_jax.floodfill_auto_threshold(jnp.asarray(data), jnp.asarray(seeds), p)
    checks = []
    got = floodfill.floodfill_auto_threshold(_t(data), _t(seeds), p, checks=checks)
    _eq(got, want)
    assert got.sum() > 50 and checks[0] >= 2


@pytest.mark.parametrize("use_ww_wl", [False, True])
@pytest.mark.parametrize("dev", [60.0, 25])
@pytest.mark.parametrize("conn", CONNS)
def test_region_grow_dynamic(use_ww_wl, dev, conn):
    """An int deviation keeps an int16 seed value int16, as in JAX."""
    ct = _ct()
    seed = (10, 12, 5)  # soft tissue
    s = morphology.structure_3d(conn)
    want = ff_jax.region_grow_dynamic(jnp.asarray(ct), seed, dev, dev, use_ww_wl, 400.0, 40.0,
                                      s)
    got = floodfill.region_grow_dynamic(_t(ct), seed, dev, dev, use_ww_wl, 400.0, 40.0, s)
    _eq(got, want)
    assert got[seed] and got.sum() > 100


def _confidence_windows(img, seed, mult, iters, strct):
    """float64 windows of the confidence loop, grown with scipy."""
    region = np.zeros(img.shape, bool)
    z, y, x = seed
    region[max(z - 1, 0):z + 2, max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = True
    out = np.zeros(img.shape, bool)
    seeds = np.zeros(img.shape, bool)
    seeds[seed] = True
    wins = []
    for _ in range(iters):
        v = img[region].astype(np.float64)
        mean, std = v.mean(), v.std()
        t0, t1 = mean - mult * std, mean + mult * std
        wins.append((t0, t1))
        allowed = (img >= t0) & (img <= t1)
        out |= _bfs_checks(seeds, allowed, strct)[1]
        region |= out
    return wins


@pytest.mark.parametrize("use_ww_wl", [False, True])
@pytest.mark.parametrize("mult", [1.0, 2.5])
def test_region_grow_confidence(use_ww_wl, mult):
    """Exact where no voxel lies within 1e-3 of a window's ends (the sums
    run in another order than XLA's): the margin is asserted."""
    ct = _ct()
    seed = (10, 12, 5)
    img = ct.astype(np.float32)
    if use_ww_wl:
        img = np.asarray(ff_jax.get_lut_value_255(jnp.asarray(ct), 400.0, 40.0))
    vals = np.unique(img).astype(np.float64)
    for t in np.ravel(_confidence_windows(img, seed, mult, 3, morphology.structure_3d(6))):
        assert np.abs(vals - t).min() > 1e-3, t
    want = ff_jax.region_grow_confidence(jnp.asarray(ct), seed, mult, 3, use_ww_wl, 400.0, 40.0)
    checks = []
    got = floodfill.region_grow_confidence(_t(ct), seed, mult, 3, use_ww_wl, 400.0, 40.0,
                                           checks=checks)
    _eq(got, want)
    assert got[seed] and len(checks) == 3


def test_apply_fill():
    mask = (_rand_mask(0.5, seed=11)).astype(np.uint8) * 255
    reached = _rand_mask(0.2, seed=12)
    for fill in (254, 1, 0):
        _eq(floodfill.apply_fill(_t(mask), _t(reached), fill),
            ff_jax.apply_fill(jnp.asarray(mask), jnp.asarray(reached), fill))


# --------------------------------------------------------------------------
# connected components
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.3, 0.55, 0.85])
@pytest.mark.parametrize("conn", CONNS)
def test_label(p, conn):
    m = _rand_mask(p, seed=int(p * 100) + conn)
    rounds = []
    got = connected.label(_t(m), conn, rounds=rounds)
    _eq(got, conn_jax.label(jnp.asarray(m), conn))
    assert got.dtype == torch.int32 and len(rounds) == 1 and rounds[0] >= 2


def test_label_long_snake():
    """A one-voxel-wide path that turns at every step of a plane: the
    largest index lies at the far end, many hops from most voxels."""
    m = np.zeros((3, 16, 16), bool)
    for y in range(0, 16, 2):
        m[1, y, :] = True
        m[1, y + 1, 15 if (y // 2) % 2 == 0 else 0] = y + 1 < 16
    m[1, 15, :] = False
    m[0, 0, 0] = m[2, 15, 15] = True
    for conn in CONNS:
        _eq(connected.label(_t(m), conn), conn_jax.label(jnp.asarray(m), conn))


def test_relabel_sequential():
    lab = np.random.default_rng(13).choice([0, 3, 7, 8, 40, 41], size=SHAPE).astype(np.int32)
    got, n = connected.relabel_sequential(_t(lab))
    want, n_want = conn_jax.relabel_sequential(jnp.asarray(lab))
    _eq(got, want)
    assert n == n_want == 5
    got, n = connected.relabel_sequential(_t(lab + 1))  # no background
    want, n_want = conn_jax.relabel_sequential(jnp.asarray(lab + 1))
    _eq(got, want)
    assert n == n_want == 6


@pytest.mark.parametrize("conn", CONNS)
def test_count_regions_and_sizes(conn):
    m = _rand_mask(0.3, seed=14 + conn)
    got, n = connected.count_regions(_t(m), conn)
    want, n_want = conn_jax.count_regions(jnp.asarray(m), conn)
    _eq(got, want)
    ref, n_ref = ndi.label(m, morphology.structure_3d(conn))
    assert n == n_want == n_ref
    # the same partition as scipy's (scipy numbers in scan order)
    pairs = np.unique(np.stack([got.ravel(), ref.ravel()]), axis=1)
    assert pairs.shape[1] == n + 1
    lab = connected.label(_t(m), conn)
    _eq(connected.component_sizes(lab), conn_jax.component_sizes(jnp.asarray(lab.numpy())))


@pytest.mark.parametrize("conn", CONNS)
def test_largest_component(conn):
    m = _rand_mask(0.3, seed=20 + conn)
    _eq(connected.largest_component(_t(m), conn), conn_jax.largest_component(jnp.asarray(m), conn))


def test_largest_component_ties_and_empty():
    m = np.zeros(SHAPE, bool)
    m[2:4, 2:4, 2:4] = True          # 8 voxels, the lower label
    m[10:12, 10:12, 10:12] = True    # 8 voxels, a higher label
    m[15, 15, 15] = True
    got = connected.largest_component(_t(m))
    _eq(got, conn_jax.largest_component(jnp.asarray(m)))
    assert got[2, 2, 2] and not got[10, 10, 10]  # argmax: the lowest label of a tie
    empty = np.zeros(SHAPE, bool)
    _eq(connected.largest_component(_t(empty)), conn_jax.largest_component(jnp.asarray(empty)))


@pytest.mark.parametrize("conn", CONNS)
@pytest.mark.parametrize("max_size", [1, 6, 1000])
def test_fill_holes_automatically(conn, max_size):
    mask = ((_rand_mask(0.75, seed=30 + conn)).astype(np.uint8) * 255)
    mask[_rand_mask(0.05, seed=31)] = 1       # erased codes are holes too
    mask[_rand_mask(0.05, seed=32)] = 254
    rounds = []
    got = connected.fill_holes_automatically(_t(mask), max_size, conn, rounds=rounds)
    _eq(got, conn_jax.fill_holes_automatically(jnp.asarray(mask), max_size, conn))
    assert rounds and (got.numpy() != mask).any()


@pytest.mark.parametrize("conn", CONNS)
def test_select_part(conn):
    mask = ((_rand_mask(0.5, seed=40 + conn)).astype(np.uint8) * 255)
    mask[_rand_mask(0.1, seed=41)] = 253
    seed = tuple(int(c) for c in np.argwhere(mask > 0)[len(np.argwhere(mask > 0)) // 2])
    checks = []
    got = connected.select_part(_t(mask), seed, conn, checks=checks)
    _eq(got, conn_jax.select_part(jnp.asarray(mask), seed, conn))
    assert got[seed] and checks


# --------------------------------------------------------------------------
# Mask.fill_holes_auto with undo / redo
# --------------------------------------------------------------------------

@pytest.mark.parametrize("conn", CONNS)
def test_mask_fill_holes_auto_undo_redo(conn):
    data = (_rand_mask(0.8, seed=50 + conn)).astype(np.uint8) * 255
    mj = MaskJax(shape=SHAPE)
    mj.data = jnp.asarray(data)
    mp = convert.mask_from_jax(mj, device="cpu")
    mj.fill_holes_auto(4, conn)
    mp.fill_holes_auto(4, conn)
    filled = np.asarray(mj.data)
    _eq(mp.data, filled)
    assert mp.was_edited and (filled != data).any()
    assert mp.undo() and mj.undo()
    _eq(mp.data, data)
    _eq(mp.data, mj.data)
    assert mp.redo() and mj.redo()
    _eq(mp.data, filled)
    assert not mp.redo()


# --------------------------------------------------------------------------
# the editing sequence of chip_smoke.py phase [10], JAX against the port
# --------------------------------------------------------------------------

def _edit_sequence(slc, pkg, asarray, host):
    """The server endpoints' calls, in phase [10]'s order, on a Slice of
    ``make_ct(n)``; ``pkg`` holds either package's ops.  Returns every
    intermediate result on the host, by name."""
    morph, ff, conn = pkg
    n = slc.matrix.shape[0]
    c = n // 2
    shell_x = c + round(0.39 * n)  # the shell's middle: 0.36n to 0.42n
    out = {}
    mask = slc.create_new_mask(threshold_range=const.THRESHOLD_PRESETS_CT["Bone"])
    out["threshold"] = host(mask.data)
    out["regions"] = conn.count_regions(mask.visible_array())
    out["largest"] = host(conn.largest_component(mask.visible_array()))
    spacing = slc.spacing
    dot = morph.brush_element(0.2, spacing, "circle")
    pockets = asarray(np.array([(c, c, shell_x), (c, shell_x, c), (shell_x, c, c)],
                               np.int32))
    mask.apply(morph.paint_brush_trajectory(mask.data, asarray(dot), pockets, 1, dot.shape))
    out["erased"] = host(mask.data)
    mask.fill_holes_auto(1000, 6)
    out["filled"] = host(mask.data)
    mask.undo()
    out["undone"] = host(mask.data)
    mask.redo()
    out["redone"] = host(mask.data)
    ball = morph.brush_element(1.0, spacing, "circle")
    stroke = asarray(np.array([(c, c, c + int(0.2 * n) + k) for k in range(4)], np.int32))
    mask.apply(morph.paint_brush_trajectory(mask.data, asarray(ball), stroke, 254, ball.shape))
    out["painted"] = host(mask.data)
    across = asarray(np.array([(c - 2, c, shell_x - 4 + 2 * k) for k in range(5)], np.int32))
    for op in THRESH_OPS:
        mask.apply(morph.paint_brush_trajectory_threshold(
            mask.data, slc.matrix, asarray(ball), across, 226, 3071, ball.shape, op))
        out[op] = host(mask.data)
    edge = asarray(np.array([(0, 0, 0), (n - 1, n - 1, n - 1), (0, n - 1, c), (n - 1, 0, c),
                             (c, 0, n - 1), (c, n - 1, 0)], np.int32))
    mask.apply(morph.paint_brush_trajectory(mask.data, asarray(ball), edge, 254, ball.shape))
    out["edges"] = host(mask.data)
    out["regions_after"] = conn.count_regions(mask.visible_array())
    out["largest_after"] = host(conn.largest_component(mask.visible_array()))
    seeds = np.zeros(slc.matrix.shape, bool)
    seeds[c, c, shell_x] = True
    out["flood_shell"] = host(ff.floodfill_threshold(slc.matrix, asarray(seeds), 226, 3071))
    part = conn.select_part(mask.data, (c, c, c))
    out["island"] = host(part)
    out["removed"] = host(ff.apply_fill(mask.data, part, const.MASK_ERASED))
    soft = (c, c, c + int(0.25 * n))
    out["dynamic"] = host(ff.region_grow_dynamic(slc.matrix, soft, 30.0, 30.0))
    out["confidence"] = host(ff.region_grow_confidence(slc.matrix, soft, 2.5, 3))
    out["area"] = slc.calc_mask_area(mask)
    return out


def test_editing_sequence_on_make_ct():
    n = 48
    ct = pipeline.make_ct(n)
    Mask.general_index = MaskJax.general_index = -1
    sj = SliceJax(VolumeJax.from_numpy(ct, spacing=pipeline.SPACING), bus=events_jax.Publisher())
    sp = convert.slice_from_jax(sj, device="cpu", bus=events.Publisher())
    want = _edit_sequence(sj, (morph_jax, ff_jax, conn_jax), jnp.asarray, np.asarray)
    got = _edit_sequence(sp, (morphology, floodfill, connected), _t,
                         lambda t: t.cpu().numpy())
    assert got.keys() == want.keys()
    for k in got:
        if k.startswith("regions"):
            _eq(got[k][0], want[k][0])
            assert got[k][1] == want[k][1], k
        elif k == "area":
            assert got[k] == pytest.approx(want[k], rel=1e-5)
        else:
            assert np.array_equal(got[k], want[k]), (k, np.argwhere(got[k] != want[k])[:4])
            _eq(got[k], want[k])
    # what phase [10] asserts on the card holds here too
    assert want["regions"][1] == 2 and got["regions_after"][1] > 2
    carved = got["erased"] != got["threshold"]
    assert carved.sum() == 3
    np.testing.assert_array_equal(got["filled"], np.where(carved, 254, got["threshold"]))
    _eq(got["undone"], got["erased"])
    _eq(got["redone"], got["filled"])
    assert got["flood_shell"].sum() > 0 and got["dynamic"].sum() > 0
    assert got["confidence"].sum() > 0


def test_chip_smoke_phase_10_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase [10] at 48^3 on the CPU, with its own host
    oracles (scipy label and iterated dilation, the stamp-by-stamp strokes,
    the exposed-face area) and the 24^3 device-against-CPU comparison run
    CPU against CPU."""
    root = str(Path(__file__).resolve().parent.parent)
    monkeypatch.syspath_prepend(root)
    chip_smoke = importlib.import_module("chip_smoke")
    Mask.general_index = -1
    stats = chip_smoke.mask_editing(CPU, n=48, small=24)
    assert {"count_regions", "floodfill_threshold", "label (bone)", "median 3D"} <= set(stats)
    assert all(v["ms"] >= 0 for v in stats.values())
    sys.modules.pop("chip_smoke", None)

"""The slice viewer's frame path of the port against the JAX package's, on
the CPU: a seeded 24x20x22 int16 CT in a JAX ``Slice`` with a threshold
mask, an edited mask (editor codes) and a colour overlay, carried over by
``convert.slice_from_jax``.

Tolerances (those of the JAX package's tests/test_projections.py):
- images: exact for Normal, MaxIP, MinIP, MeanIP and LMIP; atol 1 for
  MIDA; atol 2 for the contour types;
- RGB frames: byte-equal.  For the types that are not exact, the JAX
  image is fed through the port's RGB path (``Slice.render_image``) and
  that is compared byte for byte;
- masks, overlays, crop, flip, swap, image versions, undo/redo and the bus
  messages: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu import constants as const_jax
from invesalius3_tpu import events as events_jax
from invesalius3_tpu.core import mask as mask_jax
from invesalius3_tpu.core.geometry import Box as BoxJax
from invesalius3_tpu.core.measures import MeasurementManager
from invesalius3_tpu.core.slice import Slice as SliceJax
from invesalius3_tpu.core.volume import Volume as VolumeJax
from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch import convert, events
from invesalius3_tpu_torch.core import mask as mask_port
from invesalius3_tpu_torch.core.geometry import Box

torch.set_num_threads(1)

SHAPE = (24, 20, 22)
SPACING = (0.8, 0.9, 1.25)
ORIENTATIONS = [const.AXIAL, const.CORONAL, const.SAGITTAL]
PROJECTIONS = sorted(const.PROJECTION_NAMES)
EXACT = {const.PROJECTION_NORMAL, const.PROJECTION_MaxIP, const.PROJECTION_MinIP,
         const.PROJECTION_MeanIP, const.PROJECTION_LMIP}
ATOL = {const.PROJECTION_MIDA: 1, const.PROJECTION_CONTOUR_MIP: 2,
        const.PROJECTION_CONTOUR_LMIP: 2, const.PROJECTION_CONTOUR_MIDA: 2}
START = 3


def _ct() -> np.ndarray:
    """A small head-like CT: air, soft tissue (40 HU), a bone shell and an
    inner bone island, with noise (seed 0)."""
    r = np.random.default_rng(0)
    zz, yy, xx = np.indices(SHAPE).astype(np.float32)
    c = [(s - 1) / 2.0 for s in SHAPE]
    rad = np.sqrt(((zz - c[0]) / 11) ** 2 + ((yy - c[1]) / 9) ** 2 + ((xx - c[2]) / 10) ** 2)
    ct = np.full(SHAPE, -1000.0, np.float32)
    ct[rad < 1.0] = 40
    ct[(rad >= 0.8) & (rad < 1.0)] = 1200
    ct[rad < 0.25] = 900
    ct += r.integers(-20, 20, SHAPE)
    return ct.astype(np.int16)


def _measures():
    mgr = MeasurementManager(bus=events_jax.Publisher())
    mgr.add_linear((2.0, 3.0, START * SPACING[2]), (12.0, 14.0, START * SPACING[2]),
                   location="AXIAL", slice_number=START)
    mgr.add_angular((1.0, 0.0, 5.0), (8.0, START * SPACING[1], 10.0), (15.0, 0.0, 4.0),
                    location="CORONAL", slice_number=START)
    mgr.add_annotation((0.0, 6.0, 9.0), "ROI", location="SAGITTAL", slice_number=0)
    return mgr


def _record(bus):
    log = []

    @events_jax.wants_topic
    def listener(topic, **kw):
        log.append((topic, kw))

    bus.subscribe(listener, events_jax.ALL_TOPICS)
    return log


@pytest.fixture
def pair():
    """(JAX Slice, port Slice, JAX bus log, port bus log)."""
    ct = _ct()
    slc = SliceJax(VolumeJax.from_numpy(ct, spacing=SPACING, window_width=400.0,
                                        window_level=40.0),
                   bus=events_jax.Publisher())
    bone = slc.create_new_mask(threshold_range=const_jax.THRESHOLD_PRESETS_CT["Bone"])
    edited = slc.create_new_mask(name="edited", threshold_range=(-700, 225), show=False)
    data = np.asarray(edited.data).copy()
    r = np.random.default_rng(1)
    idx = r.random(SHAPE) < 0.05
    data[idx] = r.choice(np.array([1, 2, 253, 254], np.uint8), int(idx.sum()))
    edited.apply(jnp.asarray(data))
    slc.set_mask_threshold(-100, 300, mask=edited)
    slc.set_color_overlay(np.where(ct > 800, ct, 0).astype(np.float32), alpha=0.5)
    slc.create_crop_box().set_limits(2, 20, 3, 15, 4, 18)
    slc.n_slabs = 4
    assert slc.current_mask is bone
    port = convert.slice_from_jax(slc, device="cpu", bus=events.Publisher())
    # the mask counter is process-wide in both packages; align it so new
    # masks get equal indices and colours
    mask_port.Mask.general_index = mask_jax.Mask.general_index
    return slc, port, _record(slc.bus), _record(port.bus)


def _assert_masks_equal(slc, port):
    assert sorted(slc.masks) == sorted(port.masks)
    for i, m in slc.masks.items():
        p = port.masks[i]
        np.testing.assert_array_equal(p.data.numpy(), np.asarray(m.data))
        for attr in ("index", "name", "colour", "opacity", "threshold_range",
                     "edition_threshold_range", "is_shown", "was_edited",
                     "derived_from", "spacing"):
            assert tuple(np.ravel(getattr(p, attr))) == tuple(np.ravel(getattr(m, attr))), attr
    assert (slc.current_mask is None) == (port.current_mask is None)
    if slc.current_mask is not None:
        assert port.current_mask is port.masks[slc.current_mask.index]


def _frames_equal(slc, port, orientation, index, **kw):
    want = slc.get_rendered_slice(orientation, index, **kw)
    got = port.get_rendered_slice(orientation, index, **kw)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the frame
# --------------------------------------------------------------------------


@pytest.mark.parametrize("inverted", [False, True])
@pytest.mark.parametrize("orientation", ORIENTATIONS)
@pytest.mark.parametrize("projection", PROJECTIONS)
def test_frames_match(pair, projection, orientation, inverted):
    slc, port, _, _ = pair
    axis = const.ORIENTATION_AXIS[orientation]
    measures = _measures()
    for slabs in (1, 4, SHAPE[axis]):   # the last runs to the volume's end
        kw = dict(projection=projection, inverted=inverted)
        want = slc.get_image_slice(orientation, START, slabs, **kw)
        got = port.get_image_slice(orientation, START, slabs, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype
        if projection in EXACT:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got.astype(np.int64), want.astype(np.int64),
                                       atol=ATOL[projection])
        frame = dict(projection=projection, slabs=slabs, inverted=inverted,
                     measures=measures, crop_box=slc.crop_box, cross=(7.0, 5.0),
                     ruler=True, orientation_labels=True)
        rgb_want = slc.get_rendered_slice(orientation, START, **frame)
        if projection in EXACT:
            rgb_got = port.get_rendered_slice(orientation, START, **frame)
        else:
            del frame["projection"], frame["slabs"], frame["inverted"]
            rgb_got = port.render_image(torch.from_numpy(want.copy()), orientation, START,
                                        port.window_width, port.window_level, **frame)
        assert rgb_got.dtype == np.uint8
        np.testing.assert_array_equal(rgb_got, rgb_want)


@pytest.mark.parametrize("orientation", ORIENTATIONS)
def test_frame_overrides_and_defaults(pair, orientation):
    """Request-local ww/wl, the slice's own projection type and slab count,
    a hidden mask, no colour overlay."""
    slc, port, _, _ = pair
    for s in (slc, port):
        s.projection_type = const.PROJECTION_MaxIP
    _frames_equal(slc, port, orientation, 0)
    _frames_equal(slc, port, orientation, 5, ww=1500.0, wl=300.0)
    for s in (slc, port):
        s.current_mask.is_shown = False
        s.clear_color_overlay()
    _frames_equal(slc, port, orientation, 7, projection=const.PROJECTION_NORMAL)


# --------------------------------------------------------------------------
# the state carried across, and the Slice's operations
# --------------------------------------------------------------------------


def test_state_carried_across(pair):
    slc, port, _, _ = pair
    v, p = slc.volume, port.volume
    np.testing.assert_array_equal(p.to_numpy(), np.asarray(v.data))
    assert p.shape == v.shape and p.spacing == v.spacing and p.modality == v.modality
    assert (p.window_width, p.window_level) == (v.window_width, v.window_level)
    np.testing.assert_array_equal(p.affine, v.affine)
    pts = np.array([[1.0, 2.0, 3.0], [23.0, 19.0, 21.0]])
    np.testing.assert_array_equal(p.voxel_to_world(pts), v.voxel_to_world(pts))
    np.testing.assert_array_equal(p.world_to_voxel(pts), v.world_to_voxel(pts))
    assert p.min_max() == v.min_max()
    _assert_masks_equal(slc, port)
    np.testing.assert_array_equal(port._overlay_u8, slc._overlay_u8)
    np.testing.assert_array_equal(port._overlay_lut, slc._overlay_lut)
    assert port.crop_box.limits == slc.crop_box.limits
    assert port.crop_box.make_matrix() == slc.crop_box.make_matrix()
    assert (port.n_slabs, port.projection_type) == (slc.n_slabs, slc.projection_type)
    assert [lbl for lbl, _ in port.image_versions] == [lbl for lbl, _ in slc.image_versions]


def test_mask_serialization_matches(pair):
    slc, port, _, _ = pair
    for i, m in slc.masks.items():
        p = port.masks[i]
        assert p.save_plist("mask.dat") == m.save_plist("mask.dat")
        mat = m.to_bordered_matrix()
        np.testing.assert_array_equal(p.to_bordered_matrix(), mat)
        back = mask_port.Mask.load_plist(p.save_plist("mask.dat"), mat.tobytes(),
                                          device="cpu")
        np.testing.assert_array_equal(back.data.numpy(), np.asarray(m.data))
        assert (back.index, back.name, back.colour) == (m.index, m.name, tuple(m.colour))


def test_mask_ops_and_undo_redo(pair):
    slc, port, log_j, log_p = pair
    for s in (slc, port):
        s.set_mask_threshold(500, 1500)
        m = s.create_new_mask(name="soft", threshold_range=(-700, 225))
        s.set_mask_threshold(-50, 100, mask=m)
        s.select_mask(min(s.masks))
        s.apply_crop()                                    # the fixture's box
        s.apply_crop(Box(SHAPE, SPACING) if s is port else BoxJax(SHAPE, SPACING))
    _assert_masks_equal(slc, port)
    # undo / redo, whole volume and one plane
    for s in (slc, port):
        cm = s.current_mask
        plane = np.zeros(SHAPE[1:], np.uint8)
        new = np.array(cm.data if s is slc else cm.data.numpy())
        new[5] = plane
        cm.apply(jnp.asarray(new) if s is slc else torch.from_numpy(new),
                 orientation="AXIAL", index=5)
    _assert_masks_equal(slc, port)
    for step in ("undo", "undo", "undo", "redo", "undo", "redo", "redo", "redo", "undo"):
        results = [getattr(s.current_mask, step)() for s in (slc, port)]
        assert results[0] == results[1]
        _assert_masks_equal(slc, port)
    for s in (slc, port):
        s.remove_mask(s.current_mask.index)
    _assert_masks_equal(slc, port)
    assert log_p == log_j


@pytest.mark.parametrize("op", [const.BOOLEAN_UNION, const.BOOLEAN_DIFF,
                                const.BOOLEAN_AND, const.BOOLEAN_XOR])
def test_boolean_ops_match(pair, op):
    slc, port, log_j, log_p = pair
    i1, i2 = sorted(slc.masks)
    for s in (slc, port):
        s.do_boolean_op(op, i1, i2)
        s.do_boolean_op(op, i1, i2)     # a second one: the name gets "copy"
    _assert_masks_equal(slc, port)
    assert log_p == log_j


def test_duplicate_mask(pair):
    slc, port, _, _ = pair
    names = [m.name for m in slc.masks.values()]
    dj = slc.current_mask.duplicate(names)
    dp = port.current_mask.duplicate(names)
    assert (dp.index, dp.name, dp.colour) == (dj.index, dj.name, dj.colour)
    np.testing.assert_array_equal(dp.data.numpy(), np.asarray(dj.data))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_flip_volume_matches(pair, axis):
    slc, port, log_j, log_p = pair
    for s in (slc, port):
        s.flip_volume(axis)
    np.testing.assert_array_equal(port.matrix.numpy(), np.asarray(slc.matrix))
    _assert_masks_equal(slc, port)
    for o in ORIENTATIONS:
        _frames_equal(slc, port, o, 2, projection=const.PROJECTION_LMIP, slabs=6)
    assert log_p == log_j


@pytest.mark.parametrize("axes", [(0, 1), (0, 2), (2, 1)])
def test_swap_volume_axes_matches(pair, axes):
    slc, port, log_j, log_p = pair
    for s in (slc, port):
        s.clear_color_overlay()   # its shape no longer fits a swapped volume
        s.swap_volume_axes(*axes)
    np.testing.assert_array_equal(port.matrix.numpy(), np.asarray(slc.matrix))
    assert port.spacing == slc.spacing
    _assert_masks_equal(slc, port)
    for o in ORIENTATIONS:
        _frames_equal(slc, port, o, 1, projection=const.PROJECTION_MeanIP, slabs=5,
                      ruler=True)
    assert log_p == log_j


def test_image_versions_match(pair):
    slc, port, log_j, log_p = pair
    smoothed = (_ct() // 2).astype(np.int16)
    slc.image_versions.append(("Filtered 1", smoothed))
    port.image_versions.append(("Filtered 1", torch.from_numpy(smoothed)))
    for label in ("Filtered 1", "original"):
        for s in (slc, port):
            s.current_mask.was_edited = False
            s.select_image_version(label)
        np.testing.assert_array_equal(port.matrix.numpy(), np.asarray(slc.matrix))
        _assert_masks_equal(slc, port)
        _frames_equal(slc, port, const.CORONAL, 4, projection=const.PROJECTION_MaxIP,
                      slabs=8)
    with pytest.raises(KeyError):
        port.select_image_version("missing")
    assert log_p == log_j


def test_load_new_volume_and_window(pair):
    slc, port, log_j, log_p = pair
    ct = _ct()[::-1].copy()
    slc.load_new_volume(VolumeJax.from_numpy(ct, spacing=(1.0, 1.0, 2.0)))
    port.load_new_volume(convert.volume_from_jax(slc.volume, device="cpu"))
    for s in (slc, port):
        s.set_window(800.0, 200.0)
        s.create_new_mask()
    _assert_masks_equal(slc, port)
    for o in ORIENTATIONS:
        _frames_equal(slc, port, o, 0, projection=const.PROJECTION_MinIP, slabs=3)
    assert log_p == log_j
    assert [t for t, _ in log_p][:3] == ["slice.volume_set", "slice.overlay_cleared",
                                         "slice.study_replaced"]

"""The 3D viewer's render path of the port against the JAX package's, on the
CPU: raycasting presets and their plists, the gather raycaster, the
shear-warp renderer and its permuted-volume cache, the mask preview, the
surface splat renderer and scene glyphs, visibility culling, and the 3D
mask cut (the JAX tests/test_reslice_raycast.py :109-183 and :262-530,
tests/test_canvas.py :167-360 and tests/test_editor_ops.py :20-58, case for
case, through both packages), on seeded volumes of 32^3 to 64^3 and frames
of 32 to 96 px.  The last test rehearses chip_smoke.py's phase [11].

Tolerances:
- presets, knots, camera rays, plist bytes, ``polygon2mask``, the pooled
  volumes, the cache's keys: equal;
- uint8 frames (gather raycaster, shear-warp, mask preview): mean |diff| at
  most 0.1 level and at most 2 levels on 99.9% of pixels;
- splat images: at most 0.5% of pixels differ; ``remove_non_visible_faces``'
  kept set: at most 0.1% of faces;
- ``mask_cut``: equal, or at most 0.01% of voxels, all on the polygon's edge;
- the colour map in relu form: within 1e-5 (float32 sums).
"""

import dataclasses
import importlib
import plistlib
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu import events as events_jax
from invesalius3_tpu.core.slice import Slice as SliceJax
from invesalius3_tpu.core.volume import Volume as VolumeJax
from invesalius3_tpu.ops import rasterize as ras_jax
from invesalius3_tpu.ops import raycast as rc_jax
from invesalius3_tpu.ops import render_mesh as rm_jax
from invesalius3_tpu_torch import convert, events, pipeline
from invesalius3_tpu_torch.ops import rasterize, raycast, render_mesh

torch.set_num_threads(1)
CPU = torch.device("cpu")
BG = np.array([17, 19, 24])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _frames_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.mean() <= 0.1, d.mean()
    assert (d > 2).mean() <= 1e-3, (d > 2).mean()


def _splats_close(got, want):
    assert got.shape == want.shape
    assert (got != want).any(-1).mean() <= 5e-3, (got != want).any(-1).mean()


def _shell_ct(n=48):
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float32)
    c = (n - 1) / 2
    r = np.sqrt((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2)
    ct = np.full((n, n, n), -1000, np.int16)
    ct[(r >= 14 * n / 48) & (r < 18 * n / 48)] = 1200
    return ct


def _smooth_sphere(n=64):
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float32)
    r = np.sqrt((zz - n / 2) ** 2 + (yy - n / 2) ** 2 + (xx - n / 2) ** 2)
    return np.clip(1500 - 60 * np.maximum(r - n / 3.5, 0), -1000, 1500).astype(np.float32)


def _both_presets(name, **changes):
    pj = dataclasses.replace(rc_jax.builtin_preset(name), **changes)
    return pj, convert.preset_from_jax(pj)


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", rc_jax.BUILTIN_PRESETS)
def test_builtin_presets_equal(name):
    p, pj = raycast.builtin_preset(name), rc_jax.builtin_preset(name)
    for f in dataclasses.fields(pj):
        np.testing.assert_array_equal(np.asarray(getattr(p, f.name)),
                                      np.asarray(getattr(pj, f.name)))
    assert p.rgba.dtype == np.float32 and np.isfinite(p.rgba).all() and p.rgba[:, 3].max() > 0
    assert raycast.preset_nodes(name) == rc_jax.preset_nodes(name)
    assert raycast.nodes_from_preset(p, 24) == rc_jax.nodes_from_preset(pj, 24)
    assert raycast.preset_to_plist(p) == rc_jax.preset_to_plist(pj)
    for k, a in zip(("xs", "y0", "dm"), raycast._preset_knots(p)):
        np.testing.assert_array_equal(a, np.asarray(rc_jax._preset_knots(pj)[
            ("xs", "y0", "dm").index(k)]))
    with pytest.raises(KeyError):
        raycast.builtin_preset("nope")


def test_catalog_and_preset_nodes_roundtrip():
    assert raycast.BUILTIN_PRESETS == rc_jax.BUILTIN_PRESETS
    assert len(raycast.BUILTIN_PRESETS) >= 30
    n = raycast.preset_nodes("Bone")
    p = raycast.preset_from_nodes(n["name"], n["lo"], n["hi"], n["alpha_nodes"],
                                  n["color_nodes"], shading=n["shading"], mode=n["mode"])
    ref = raycast.builtin_preset("Bone")
    np.testing.assert_allclose(p.rgba, ref.rgba, atol=1e-6)
    n2 = raycast.nodes_from_preset(ref, n_nodes=64)
    p2 = raycast.preset_from_nodes("rt", n2["lo"], n2["hi"], n2["alpha_nodes"],
                                   n2["color_nodes"])
    p2j = rc_jax.preset_from_nodes("rt", n2["lo"], n2["hi"], n2["alpha_nodes"],
                                   n2["color_nodes"])
    np.testing.assert_array_equal(p2.rgba, p2j.rgba)
    assert np.abs(p2.rgba - ref.rgba).mean() < 0.02


def test_from_plist_advanced_and_basic(tmp_path):
    adv = {"name": "Test", "advancedCLUT": True,
           "16bitClutCurves": [[{"x": 100.0, "y": 0.0}, {"x": 500.0, "y": 0.8}],
                               [{"x": 600.0, "y": 0.1}, {"x": 900.0, "y": 0.9}]],
           "16bitClutColors": [[{"red": 1.0, "green": 0.5, "blue": 0.2},
                                {"red": 1.0, "green": 1.0, "blue": 0.9}],
                               [{"red": 0.2, "green": 0.3, "blue": 0.4},
                                {"red": 0.9, "green": 0.8, "blue": 0.7}]],
           "useShading": True, "projection": 1, "wl": 300.0, "ww": 400.0}
    basic = {"name": "Basic", "alpha": [{"x": -100, "y": 0.0}, {"x": 800, "y": 1.0}],
             "red": [{"x": -100, "y": 0.2}, {"x": 800, "y": 0.9}], "projection": "MIP",
             "backgroundColorBlueComponent": 0.4}
    for d in (adv, basic):
        p = tmp_path / "t.plist"
        p.write_bytes(plistlib.dumps(d))
        for src in (p, p.read_bytes()):
            got, want = raycast.RaycastPreset.from_plist(src), rc_jax.RaycastPreset.from_plist(src)
            for f in dataclasses.fields(want):
                np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                              np.asarray(getattr(want, f.name)))
    rp = raycast.RaycastPreset.from_plist(plistlib.dumps(adv))
    assert rp.name == "Test" and rp.use_shading
    assert rp.lut_min == 100.0 and rp.lut_max == 900.0
    assert rp.rgba[-1, 3] > 0.7 and rp.rgba[0, 3] < 0.05


def test_user_preset_save_load_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setattr("invesalius3_tpu_torch.utils.paths.user_dir", lambda: tmp_path / "p")
    monkeypatch.setattr("invesalius3_tpu.utils.paths.user_dir", lambda: tmp_path / "j")
    src, srcj = raycast.builtin_preset("Bone"), rc_jax.builtin_preset("Bone")
    src = dataclasses.replace(src, background=(0.1, 0.2, 0.3))
    srcj = dataclasses.replace(srcj, background=(0.1, 0.2, 0.3))
    p = raycast.save_user_preset(src, "My Bone")
    pj = rc_jax.save_user_preset(srcj, "My Bone")
    assert p.exists() and p.read_bytes() == pj.read_bytes()
    assert str(p).startswith(str(tmp_path / "p" / "presets" / "raycasting"))
    assert raycast.available_presets() == rc_jax.available_presets()
    assert "My Bone" in raycast.available_presets()
    back = raycast.load_preset("My Bone")
    assert back.name == "My Bone" and back.use_shading == src.use_shading
    np.testing.assert_array_equal(back.rgba, rc_jax.load_preset("My Bone").rgba)
    assert raycast.nodes_from_preset(back) == raycast.preset_nodes("My Bone")
    assert np.allclose(back.background, src.background)
    with pytest.raises(KeyError):
        raycast.load_preset("nope")


@pytest.mark.parametrize("az,el", [(0, 0), (30, 20), (75, -35), (120, 55), (0, 89),
                                   (-90, 0)])
def test_camera_rays_and_axis_permutation_equal(az, el):
    shape, spacing = (20, 24, 28), (0.5, 0.7, 0.9)
    got = raycast.camera_rays(shape, spacing, az, el, 40)
    want = rc_jax.camera_rays(shape, spacing, az, el, 40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    perm, flip, dp = raycast._axis_permutation(got[1])
    pj = rc_jax._axis_permutation(want[1])
    assert (perm, flip) == pj[:2]
    np.testing.assert_array_equal(dp, pj[2])


@pytest.mark.parametrize("shape", [(8, 10, 12), (7, 9, 11), (1, 3, 2)])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("mode", ["mip", "composite"])
def test_pool2_equal(mode, dtype, shape):
    v = np.random.default_rng(1).integers(-1000, 2000, shape).astype(dtype)
    got = raycast._pool2(_t(v), mode).numpy()
    want = np.asarray(rc_jax._pool2(jnp.asarray(v), mode))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_pwl_eval_multi_against_jax():
    p, pj = raycast.builtin_preset("Bone + Skin"), rc_jax.builtin_preset("Bone + Skin")
    v = np.random.default_rng(2).uniform(-1200, 2500, (30, 40)).astype(np.float32)
    got = raycast._pwl_eval_multi(_t(v), *raycast._preset_knots(p), p.lut_min, p.lut_max,
                                  (0, 1, 2, 3))
    want = rc_jax._pwl_eval_multi(jnp.asarray(v), *rc_jax._preset_knots(pj),
                                  pj.lut_min, pj.lut_max, (0, 1, 2, 3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the gather raycaster
# ---------------------------------------------------------------------------


def test_raycast_composite_bone():
    img = raycast.render(_t(_shell_ct()), (1.0, 1.0, 1.0), raycast.builtin_preset("Bone"),
                         image_size=64, n_steps=96)
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert img[32, 32].max() > 60
    assert img[0, 0].max() < 10


def test_raycast_mip_mode_and_crop_plane():
    ct = _t(_shell_ct())
    img = raycast.render(ct, (1.0, 1.0, 1.0), raycast.builtin_preset("MIP"),
                         image_size=64, n_steps=96)
    assert img[32, 32, 0] > img[0, 0, 0]
    plane = np.array([1.0, 0.0, 0.0, -24], np.float32)
    full = raycast.render(ct, preset=raycast.builtin_preset("Bone"), image_size=48,
                          n_steps=64)
    cropped = raycast.render(ct, preset=raycast.builtin_preset("Bone"), image_size=48,
                             n_steps=64, crop_plane=plane)
    assert cropped.sum() < full.sum()


@pytest.mark.parametrize("name,az,el,crop", [
    ("Bone", 30, 20, False), ("Bone", 0, 0, True), ("MIP", 120, -40, False),
    ("Soft + Skin", -60, 10, False), ("Skin On Blue", 200, 35, True),
    ("No Shading", 45, 80, False)])
def test_raycast_against_jax(name, az, el, crop):
    ct = _shell_ct(32)
    pj, p = _both_presets(name)
    plane = np.array([0.3, 1.0, -0.2, -16], np.float32) if crop else None
    got = raycast.render(_t(ct), (0.9, 1.0, 1.1), p, az, el, image_size=40, n_steps=48,
                         crop_plane=plane)
    want = rc_jax.render(ct, (0.9, 1.0, 1.1), pj, az, el, image_size=40, n_steps=48,
                         crop_plane=plane)
    _frames_close(got, want)


@pytest.mark.parametrize("name", ["Bone", "MIP", "No Shading"])
def test_raycast_step_count_off_the_batch_against_jax(name):
    """A step count that is no multiple of the steps sampled at once: the
    last batch is shorter, and the frame is still the JAX one."""
    ct = _shell_ct(32)
    pj, p = _both_presets(name)
    got = raycast.render(_t(ct), (1.0, 1.0, 1.0), p, 30, 20, image_size=40, n_steps=37)
    want = rc_jax.render(ct, (1.0, 1.0, 1.0), pj, 30, 20, image_size=40, n_steps=37)
    _frames_close(got, want)


def test_raycast_stops_once_every_ray_is_opaque():
    """The early exit changes no pixel: a volume opaque everywhere renders
    the same with and without it."""
    vol = _t(np.full((24, 24, 24), 1500, np.int16))
    p = raycast.builtin_preset("Bone")
    o, d, diag, _ = raycast.camera_rays((24, 24, 24), (1, 1, 1), 0, 0, 16)
    o = o * 0 + 11.0  # every ray starts inside the volume
    got = raycast.raycast(vol, o, d, diag, p.rgba, p.lut_min, p.lut_max, n_steps=96)
    want = rc_jax.raycast(jnp.asarray(vol.numpy()), jnp.asarray(o), jnp.asarray(d), diag,
                          jnp.asarray(p.rgba), p.lut_min, p.lut_max, n_steps=96)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# shear-warp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("az,el", [(0, 0), (30, 20), (75, -35), (120, 55)])
def test_shear_warp_matches_gather_raycast(az, el):
    vol = _t(_smooth_sphere())
    preset = dataclasses.replace(raycast.builtin_preset("Bone"), use_shading=False)
    sw = raycast.shear_warp_render(vol, (1., 1., 1.), preset, az, el,
                                   image_size=96).astype(np.float32)
    gt = raycast.render(vol, (1., 1., 1.), preset, az, el, image_size=96,
                        n_steps=256).astype(np.float32)
    d = np.abs(sw - gt) / 255.0
    assert d.mean() < 0.03, d.mean()
    assert np.percentile(d, 99) < 0.3


def test_shear_warp_mip_matches():
    vol = _t(_smooth_sphere())
    pm = dataclasses.replace(raycast.builtin_preset("Bone"), projection_mode="mip",
                             use_shading=False)
    sw = raycast.shear_warp_render(vol, (1., 1., 1.), pm, 30, 20,
                                   image_size=96).astype(np.float32)
    gt = raycast.render(vol, (1., 1., 1.), pm, 30, 20, image_size=96,
                        n_steps=256).astype(np.float32)
    assert (np.abs(sw - gt) / 255.0).mean() < 0.08


def test_shear_warp_shading_modulates():
    vol = _t(_smooth_sphere())
    p0 = dataclasses.replace(raycast.builtin_preset("Bone"), use_shading=False)
    p1 = dataclasses.replace(raycast.builtin_preset("Bone"), use_shading=True)
    a = raycast.shear_warp_render(vol, (1., 1., 1.), p0, 30, 20, image_size=64)
    b = raycast.shear_warp_render(vol, (1., 1., 1.), p1, 30, 20, image_size=64)
    on = a.sum(axis=-1) > 10
    assert ((b.sum(axis=-1) > 10) == on).mean() > 0.97
    assert b[on].mean() < a[on].mean()


VIEWS = [(0, 0), (180, 0), (90, 0), (-90, 0), (0, 89), (0, -89), (30, 20), (75, -35),
         (120, 55)]


@pytest.mark.parametrize("name", ["Bone", "Soft + Skin", "MIP"])
@pytest.mark.parametrize("az,el", VIEWS)
def test_shear_warp_against_jax(az, el, name):
    vol = _smooth_sphere(40).astype(np.int16)
    pj, p = _both_presets(name)
    got = raycast.shear_warp_render(_t(vol), (0.8, 0.9, 1.0), p, az, el, image_size=48)
    want = rc_jax.shear_warp_render(vol, (0.8, 0.9, 1.0), pj, az, el, image_size=48)
    _frames_close(got, want)


@pytest.mark.parametrize("name", ["Bone", "MIP"])
def test_shear_warp_downsample_against_jax(name):
    vol = _shell_ct(33)  # odd: the pooling pads
    pj, p = _both_presets(name)
    raycast._VOLP_CACHE.clear()
    got = raycast.shear_warp_render(_t(vol), (1, 1, 1), p, 30, 15, image_size=48,
                                    downsample=2)
    want = rc_jax.shear_warp_render(vol, (1, 1, 1), pj, 30, 15, image_size=48,
                                    downsample=2)
    _frames_close(got, want)
    raycast._VOLP_CACHE.clear()
    rc_jax._VOLP_CACHE.clear()


def test_shear_warp_downsample_matches_fullres_roughly():
    n = 64
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float32)
    r = np.sqrt((zz - 32) ** 2 + (yy - 32) ** 2 + (xx - 32) ** 2)
    vol = _t(np.where(r < 20, 1200, -1000).astype(np.int16))
    p = raycast.builtin_preset("Bone")
    full = raycast.shear_warp_render(vol, (1, 1, 1), p, azimuth=30, elevation=15,
                                     image_size=96)
    half = raycast.shear_warp_render(vol, (1, 1, 1), p, azimuth=30, elevation=15,
                                     image_size=96, downsample=2)
    assert full.shape == half.shape
    cov_f = (full.astype(int).sum(-1) > 40).mean()
    cov_h = (half.astype(int).sum(-1) > 40).mean()
    assert abs(cov_f - cov_h) < 0.06
    again = raycast.shear_warp_render(vol, (1, 1, 1), p, azimuth=32, elevation=15,
                                      image_size=96, downsample=2, fetch=False)
    assert isinstance(again, torch.Tensor) and again.shape == (96, 96, 3)
    raycast._VOLP_CACHE.clear()


def test_render_mask_preview_against_jax():
    m = (_shell_ct(40) > 200).astype(np.uint8) * 255
    got = raycast.render_mask_preview(_t(m), (1.0, 1.0, 1.0), azimuth=20, elevation=10,
                                      image_size=48)
    want = rc_jax.render_mask_preview(m, (1.0, 1.0, 1.0), azimuth=20, elevation=10,
                                      image_size=48)
    _frames_close(got, want)
    assert (got[24, 24] > 0).any()
    raycast._VOLP_CACHE.clear()


# ---------------------------------------------------------------------------
# the permuted-volume cache
# ---------------------------------------------------------------------------


def test_shear_cache_warm_and_evict():
    a = _t(np.random.default_rng(0).integers(-1000, 1000, (32, 32, 32)).astype(np.int16))
    b = a.clone()
    raycast._VOLP_CACHE.clear()
    raycast.warm_shear_cache(a, "composite")
    keys_a = [k for k, v in raycast._VOLP_CACHE.items() if v[0] is a]
    assert len(keys_a) == 6
    assert all(k[3] == 2 for k in keys_a)
    raycast.warm_shear_cache(b, "composite")
    raycast.drop_shear_cache(a)
    assert not any(v[0] is a for v in raycast._VOLP_CACHE.values())
    assert sum(v[0] is b for v in raycast._VOLP_CACHE.values()) == 6
    raycast._VOLP_CACHE.clear()


def test_permuted_volume_inflight_dedup(monkeypatch):
    vol = _t(np.random.default_rng(1).integers(-1000, 1000, (16, 16, 16)).astype(np.int16))
    raycast._VOLP_CACHE.clear()
    builds = []
    real_pool2 = raycast._pool2

    def slow_pool2(v, mode):
        builds.append(1)
        time.sleep(0.2)
        return real_pool2(v, mode)

    monkeypatch.setattr(raycast, "_pool2", slow_pool2)
    out = [None, None]

    def get(i):
        out[i] = raycast._permuted_volume(vol, (0, 1, 2), False, 2, "composite")

    ts = [threading.Thread(target=get, args=(i,)) for i in range(2)]
    [t.start() for t in ts]
    [t.join(30) for t in ts]
    assert len(builds) == 1
    assert out[0] is not None and out[0] is out[1]
    assert not raycast._VOLP_INFLIGHT
    raycast._VOLP_CACHE.clear()


def test_fullres_permute_lru_cap():
    vol = _t(np.random.default_rng(2).integers(-1000, 1000, (16, 16, 16)).astype(np.int16))
    raycast._VOLP_CACHE.clear()
    for perm in [(0, 1, 2), (1, 0, 2), (2, 0, 1)]:
        for flip in (False, True):
            raycast._permuted_volume(vol, perm, flip, 1, "composite")
    full = [k for k in raycast._VOLP_CACHE if k[3] == 1]
    assert len(full) == raycast._FULLRES_KEEP == rc_jax._FULLRES_KEEP
    assert full[-1] == (id(vol), (2, 0, 1), True, 1, "composite")
    raycast._VOLP_CACHE.clear()


def test_predictive_fullres_warm_on_pooled_render():
    n = 128
    zz = np.arange(n, dtype=np.float32)[:, None, None]
    vol = _t(np.broadcast_to(np.where(zz > n // 2, 1200, -1000), (n, n, n)).astype(np.int16))
    raycast._VOLP_CACHE.clear()
    p = raycast.builtin_preset("Bone")
    raycast.shear_warp_render(vol, (1, 1, 1), p, azimuth=30, elevation=15,
                              image_size=32, downsample=2)
    deadline = time.time() + 60
    while time.time() < deadline:
        with raycast._VOLP_LOCK:
            full = [k for k, v in raycast._VOLP_CACHE.items() if v[0] is vol and k[3] == 1]
        if full:
            break
        time.sleep(0.1)
    assert full
    pooled = [k for k in raycast._VOLP_CACHE if k[3] == 2][0]
    assert full[0][1:3] == pooled[1:3]
    raycast._VOLP_CACHE.clear()


def test_chunked_permute_matches_monolithic():
    vol = np.random.default_rng(3).integers(-1000, 1000, (6, 8, 256)).astype(np.int16)
    tv = _t(vol)
    for perm in [(2, 0, 1), (2, 1, 0)]:
        for flip in (False, True):
            raycast._VOLP_CACHE.clear()
            plain = raycast._permuted_volume(tv, perm, flip, 1, "composite")
            raycast._VOLP_CACHE.clear()
            chunked = raycast._permuted_volume(tv, perm, flip, 1, "composite", chunked=True)
            assert torch.equal(plain, chunked)
            rc_jax._VOLP_CACHE.clear()
            want = np.asarray(rc_jax._permuted_volume(vol, perm, flip, 1, "composite"))
            np.testing.assert_array_equal(plain.numpy(), want)
    raycast._VOLP_CACHE.clear()
    rc_jax._VOLP_CACHE.clear()


def test_host_volume_is_keyed_by_its_own_id():
    vol = np.random.default_rng(4).integers(-1000, 1000, (16, 16, 16)).astype(np.int16)
    raycast._VOLP_CACHE.clear()
    a = raycast._permuted_volume(vol, (1, 0, 2), True, 1, "composite", device="cpu")
    assert raycast._permuted_volume(vol, (1, 0, 2), True, 1, "composite", device="cpu") is a
    np.testing.assert_array_equal(a.numpy(), np.transpose(vol, (1, 0, 2))[::-1])
    raycast._VOLP_CACHE.clear()


# ---------------------------------------------------------------------------
# the surface splat renderer
# ---------------------------------------------------------------------------


def _both_surfaces(meshes, *a, **kw):
    got = render_mesh.render_surfaces(meshes, *a, device="cpu", **kw)
    want = rm_jax.render_surfaces(meshes, *a, **kw)
    _splats_close(got, want)
    return got


def test_glyphs_and_view_matrix_equal():
    for az, el in [(0, 0), (30, 20), (-120, 75)]:
        np.testing.assert_array_equal(render_mesh.view_matrix(az, el),
                                      rm_jax.view_matrix(az, el))
    pairs = [(render_mesh._icosphere((1, 2, 3), 4.0), rm_jax._icosphere((1, 2, 3), 4.0)),
             (render_mesh._arrow((0, 0, 30), (10, 20, 30)), rm_jax._arrow((0, 0, 30),
                                                                            (10, 20, 30))),
             (render_mesh._coil_glyph((1, 0, 0), (0, 45, 0)),
              rm_jax._coil_glyph((1, 0, 0), (0, 45, 0)))]
    t = np.linspace(0, 4 * np.pi, 30)
    tract = np.stack([10 * np.cos(t), 10 * np.sin(t), t * 2], 1).astype(np.float32)
    pairs.append((render_mesh._ribbon(tract), rm_jax._ribbon(tract)))
    pairs.append((render_mesh._ribbon(tract[:0]), rm_jax._ribbon(tract[:0])))
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    v, f = render_mesh._ribbon(tract[:1])  # one point: an empty ribbon
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_render_surfaces_zbuffer():
    v1, f1 = render_mesh._icosphere((0.0, 0.0, 0.0), radius=10.0)
    v2, f2 = render_mesh._icosphere((30.0, 0.0, 0.0), radius=5.0)
    v3, f3 = render_mesh._icosphere((0.0, -30.0, 0.0), radius=5.0)
    img = _both_surfaces([(v1, f1, (1.0, 0.0, 0.0)), (v2, f2, (0.0, 0.0, 1.0)),
                          (v3, f3, (0.0, 1.0, 0.0))], azimuth=0.0, elevation=0.0, size=96)
    assert img.shape == (96, 96, 3)
    assert (img[2, 2] == BG).all()
    red = (img[:, :, 0].astype(int) - img[:, :, 2]) > 30
    blue = (img[:, :, 2].astype(int) - img[:, :, 0]) > 30
    green = (img[:, :, 1].astype(int) - img[:, :, 0]) > 30
    assert red.sum() > blue.sum() > 0
    assert np.nonzero(red)[1].mean() < np.nonzero(blue)[1].mean()
    assert green.sum() <= red.sum() * 0.01
    assert (render_mesh.render_surfaces([], size=32, device="cpu") == BG).all()


def test_render_surfaces_ssao_no_edge_wrap():
    vA, fA = render_mesh._icosphere((-25.0, 20.0, 0.0), radius=8.0)
    vB, fB = render_mesh._icosphere((25.0, -20.0, 0.0), radius=8.0)
    meshes = [(vA, fA, (0.8, 0.8, 0.8)), (vB, fB, (0.8, 0.8, 0.8))]
    plain = _both_surfaces(meshes, 0.0, 0.0, size=96)
    ao = _both_surfaces(meshes, 0.0, 0.0, size=96, ssao=True)
    assert (plain != ao).any()
    hit = ~np.all(plain == BG, axis=-1)
    ratio = np.where(hit, ao[:, :, 0].astype(float) / np.maximum(plain[:, :, 0], 1), np.nan)
    cols = np.nonzero(hit.any(0))[0]
    left = np.nanmean(ratio[:, cols.min():cols.min() + 6])
    right = np.nanmean(ratio[:, cols.max() - 5:cols.max() + 1])
    assert abs(left - right) < 0.05, (left, right)


class _S:
    def __init__(self, v, f, colour, transparency=0.0):
        self.vertices, self.faces, self.colour = v, f, colour
        self.is_shown = True
        self.transparency = transparency


def _both_scenes(surfaces, **kw):
    got = render_mesh.render_scene(surfaces, device="cpu", **kw)
    want = rm_jax.render_scene(surfaces, **kw)
    _splats_close(got, want)
    return got


def test_render_scene_glyphs():
    s = _S(*render_mesh._icosphere((0, 0, 0), 8.0), (0.9, 0.8, 0.7))

    class M:
        position = (20.0, 0.0, 0.0)
        colour = (1.0, 0.0, 0.0)

    img = _both_scenes([s], markers=[M()], probe_pose=(0, 0, 30, 0, 0, 0), size=96)
    assert img.shape == (96, 96, 3)
    assert (img != BG).any(axis=-1).sum() > 200


def test_render_scene_streamlines():
    t = np.linspace(0, 4 * np.pi, 60)
    tract = np.stack([10 * np.cos(t), 10 * np.sin(t), t * 2], axis=1)
    img = _both_scenes([], streamlines=[(tract, (1.0, 0.9, 0.1))], size=96)
    assert (img != BG).any(axis=-1).sum() > 100


def test_render_scene_coil_glyph_and_force_bar():
    img = _both_scenes([], coil_poses=[(0, 0, 0, 0, 0, 0)], size=96)
    lit = (img != BG).any(axis=-1)
    assert lit.sum() > 300
    img2 = _both_scenes([], coil_poses=[(0, 0, 0, 90, 0, 0)], size=96, azimuth=0.0,
                        elevation=90.0, robot_force=4.0)
    assert (img2 != BG).any(axis=-1).sum() < lit.sum() + 2000
    assert (img2[:, 4:11] == (230, 200, 60)).all(axis=-1).any()


def test_render_scene_vertex_colours_and_transparency():
    v, f = render_mesh._icosphere((0, 0, 0), 10.0)
    vc = np.zeros((len(v), 3), np.float32)
    vc[:, 0] = 1.0
    img = _both_scenes([_S(v, f, vc)], size=96)
    lit = (img != BG).any(axis=-1)
    assert lit.sum() > 100
    assert (img[..., 0][lit].astype(int) > img[..., 1][lit].astype(int)).mean() > 0.9
    _both_scenes([_S(v, f, (1.0, 0.0, 0.0), transparency=0.5),
                  _S(*render_mesh._icosphere((0.0, -14.0, 0.0), 5.0), (0.0, 1.0, 0.0))],
                 size=96, azimuth=0.0, elevation=0.0)


def test_robot_force_bar():
    base = np.full((96, 96, 3), (17, 19, 24), np.uint8)
    for force in (1.0, 4.0, 6.0):
        np.testing.assert_array_equal(render_mesh.draw_force_bar(base, force),
                                      rm_jax.draw_force_bar(base, force))
    low = render_mesh.draw_force_bar(base, 1.0)
    hot = render_mesh.draw_force_bar(base, 6.0)
    assert (low[:, 4:11] == (60, 200, 90)).all(axis=-1).any()
    assert (hot[:, 4:11] == (230, 70, 60)).all(axis=-1).any()


def test_render_surfaces_screen_door_transparency():
    big, fb = render_mesh._icosphere((0.0, 0.0, 0.0), radius=12.0)
    small, fs = render_mesh._icosphere((0.0, -14.0, 0.0), radius=5.0)

    def green_pixels(alpha):
        img = _both_surfaces([(big, fb, (1.0, 0.0, 0.0), alpha),
                              (small, fs, (0.0, 1.0, 0.0))],
                             azimuth=0.0, elevation=0.0, size=96)
        return int(((img[:, :, 1].astype(int) - img[:, :, 0]) > 30).sum())

    opaque, half, faint = green_pixels(1.0), green_pixels(0.5), green_pixels(0.15)
    assert opaque <= 5
    assert half > 40
    assert faint > half


def _uv_sphere(r, n_lat, n_lon, centre=(0.0, 0.0, 0.0)):
    th = np.linspace(0, np.pi, n_lat)[1:-1]
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], -1).reshape(-1, 3)
    v = np.concatenate([v, [[0, 0, 1], [0, 0, -1]]]) * r + np.asarray(centre)
    idx = np.arange(len(th) * n_lon).reshape(len(th), n_lon)
    a, b = idx[:-1], np.roll(idx[:-1], -1, 1)
    c, d = np.roll(idx[1:], -1, 1), idx[1:]
    f = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                        np.stack([a, c, d], -1).reshape(-1, 3),
                        np.stack([np.full(n_lon, len(v) - 2), idx[0, 1:].tolist()
                                  + [idx[0, 0]], idx[0]], -1),
                        np.stack([np.full(n_lon, len(v) - 1), idx[-1],
                                  np.roll(idx[-1], -1)], -1)])
    return v.astype(np.float32), f.astype(np.int32)


def test_render_surfaces_decimates_above_max_triangles():
    """A surface above ``max_triangles`` goes through the port's QEM
    decimator (the JAX package's is another implementation, so the frames
    are held to the same footprint, not to each other's pixels)."""
    v, f = _uv_sphere(20.0, 40, 60)
    assert len(f) > 4000
    full = render_mesh.render_surfaces([(v, f, (0.9, 0.9, 0.8))], size=64, device="cpu")
    dec = render_mesh.render_surfaces([(v, f, (0.9, 0.9, 0.8))], size=64,
                                      max_triangles=1000, device="cpu")
    want = rm_jax.render_surfaces([(v, f, (0.9, 0.9, 0.8))], size=64, max_triangles=1000)
    cover = [(im != BG).any(-1).mean() for im in (full, dec, want)]
    assert abs(cover[1] - cover[0]) < 0.02 and abs(cover[1] - cover[2]) < 0.02, cover


def test_remove_non_visible_faces():
    outer, fo = render_mesh._icosphere((0.0, 0.0, 0.0), radius=20.0)
    inner, fi = render_mesh._icosphere((0.0, 0.0, 0.0), radius=5.0)
    verts = np.concatenate([outer, inner])
    faces = np.concatenate([fo, fi + len(outer)])
    v2, f2, ratio = render_mesh.remove_non_visible_faces(verts, faces, device="cpu")
    assert len(f2) == len(fo)
    assert abs(ratio - len(fo) / len(faces)) < 1e-6
    assert (np.linalg.norm(v2, axis=1) > 15).all()
    v3, f3, ratio3 = render_mesh.remove_non_visible_faces(outer, fo, device="cpu")
    assert len(f3) == len(fo) and ratio3 == 1.0
    v4, f4, _ = render_mesh.remove_non_visible_faces(verts, faces, remove_visible=True,
                                                      device="cpu")
    assert len(f4) == len(fi)
    assert (np.linalg.norm(v4, axis=1) < 6).all()


def test_remove_non_visible_faces_against_jax():
    a, fa = _uv_sphere(20.0, 16, 20)
    b, fb = _uv_sphere(6.0, 8, 10, centre=(3.0, -2.0, 1.0))
    c, fc = _uv_sphere(8.0, 10, 12, centre=(22.0, 0.0, 0.0))  # partly outside
    verts = np.concatenate([a, b, c])
    faces = np.concatenate([fa, fb + len(a), fc + len(a) + len(b)])
    for size in (96,):
        got = render_mesh.remove_non_visible_faces(verts, faces, size=size, device="cpu")
        want = rm_jax.remove_non_visible_faces(verts, faces, size=size)
        assert abs(got[2] - want[2]) <= 1e-3
        assert abs(len(got[1]) - len(want[1])) <= 1e-3 * len(faces)
        assert 0 < got[2] < 1


def test_slice_plane_mesh_against_jax():
    ct = pipeline.make_ct(24)
    sj = SliceJax(VolumeJax.from_numpy(ct, spacing=(0.5, 0.6, 0.7)),
                  bus=events_jax.Publisher())
    sj.set_window(400, 40)
    sp = convert.slice_from_jax(sj, device="cpu", bus=events.Publisher())
    for orient, idx in (("AXIAL", 5), ("CORONAL", 12), ("SAGITTAL", 20)):
        got = render_mesh.slice_plane_mesh(sp, orient, idx, step=3)
        want = rm_jax.slice_plane_mesh(sj, orient, idx, step=3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    img = _both_scenes([], slice_plane=got, size=64)
    assert (img != BG).any(-1).sum() > 100


# ---------------------------------------------------------------------------
# rasterize and the 3D mask cut
# ---------------------------------------------------------------------------


def test_polygon2mask_matches_reference_rule():
    pts = [[2.0, 2.0], [2.0, 7.0], [7.0, 7.0], [7.0, 2.0]]
    mask = rasterize.polygon2mask((10, 10), pts, device="cpu").numpy()
    assert mask[4, 4] and not mask[0, 0] and not mask[9, 9]
    m2 = rasterize.polygon2mask((4, 4), [[0.0, 0.0]] * 3, device="cpu").numpy()
    assert not m2.any()


@pytest.mark.parametrize("seed", range(4))
def test_polygon2mask_against_jax(seed):
    r = np.random.default_rng(seed)
    pts = r.uniform(-5, 45, (3 + seed * 3, 2)).astype(np.float32)
    pts[0] = np.round(pts[0])  # a vertex on the pixel grid
    got = rasterize.polygon2mask((40, 36), _t(pts)).numpy()
    want = np.asarray(ras_jax.polygon2mask((40, 36), jnp.asarray(pts)))
    np.testing.assert_array_equal(got, want)
    px, py = (r.uniform(-2, 42, 200).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        rasterize.point_in_polygon(_t(px), _t(py), _t(pts)).numpy(),
        np.asarray(ras_jax.point_in_polygon(jnp.asarray(px), jnp.asarray(py),
                                            jnp.asarray(pts))))


def test_mask_cut_depth_and_polygon():
    mask_vol = np.full((8, 8, 8), 255, np.uint8)
    m = np.array([[0.25, 0, 0, -1.0], [0, 0.25, 0, -1.0], [0, 0, 0.1, 0], [0, 0, 0, 1.0]])
    poly_mask = np.zeros((16, 16), bool)
    poly_mask[:, :8] = True
    out = rasterize.mask_cut(_t(mask_vol), (1.0, 1.0, 1.0), 1000.0, _t(poly_mask), m,
                             np.eye(4), edit_mode=1).numpy()
    assert (out[:, :, :3] == 0).all()
    assert (out[:, :, 5:] == 255).all()
    mv_far = np.eye(4)
    mv_far[:3, 3] = [100.0, 100.0, 100.0]
    out2 = rasterize.mask_cut(_t(mask_vol), (1.0, 1.0, 1.0), 0.5, _t(poly_mask), m,
                              mv_far, edit_mode=1).numpy()
    assert (out2 == 255).all()


def scene_matrices(shape, spacing, az, el, size):
    """(projection, model-view) of the 3D scene framing the volume's bounds,
    as the viewer server's /api/mask/cut3d builds them."""
    Zs, Ys, Xs = shape
    pts = np.array([[0, 0, 0], [Xs * spacing[0], Ys * spacing[1], Zs * spacing[2]]],
                   np.float32)
    center = (pts.min(0) + pts.max(0)) / 2.0
    vm = render_mesh.view_matrix(az, el)
    proj = (pts - center) @ vm.T
    extent = float(np.abs(proj[:, :2]).max()) * 2.1 + 1e-3
    scale = size / extent
    a = 2.0 * scale / (size - 1)
    b = size / (size - 1.0) - 1.0
    mproj = np.zeros((4, 4), np.float32)
    mproj[0, :3] = a * vm[0]
    mproj[0, 3] = -a * float(vm[0] @ center) + b
    mproj[1, :3] = -a * vm[1]
    mproj[1, 3] = a * float(vm[1] @ center) + b
    mproj[3, 3] = 1.0
    eye = center - vm[2] * extent
    mv = np.eye(4, dtype=np.float32)
    mv[:3, :3] = vm
    mv[:3, 3] = -(vm @ eye)
    return mproj, mv


@pytest.mark.parametrize("az,el", [(30, 20), (0, 0), (-70, 45), (180, -60)])
@pytest.mark.parametrize("edit_mode", [0, 1])
def test_mask_cut_against_jax(az, el, edit_mode):
    ct = pipeline.make_ct(40)
    mask = (ct >= 226).astype(np.uint8) * 255
    mask[::7, ::5, ::3] = 254
    spacing, size = (0.5, 0.6, 0.7), 64
    mproj, mv = scene_matrices(ct.shape, spacing, az, el, size)
    poly = np.array([(10, 10), (70, 14), (40, 55), (-4, 40)], np.float32)
    pm = rasterize.polygon2mask((size, size), poly, device="cpu").T
    pmj = np.asarray(ras_jax.polygon2mask((size, size), jnp.asarray(poly))).T
    np.testing.assert_array_equal(pm.numpy(), pmj)
    for depth in (1e9, 22.0):
        got = rasterize.mask_cut(_t(mask), spacing, depth, pm, mproj, mv, edit_mode).numpy()
        want = np.asarray(ras_jax.mask_cut(jnp.asarray(mask), spacing, depth,
                                           jnp.asarray(pmj), jnp.asarray(mproj),
                                           jnp.asarray(mv), edit_mode=edit_mode))
        np.testing.assert_array_equal(got, want)
        cut = got != mask
        assert cut.any() and (mask[cut] > 127).all() and (got[cut] == 0).all()


def test_mask_cut_in_slabs(monkeypatch):
    ct = pipeline.make_ct(24)
    mask = _t((ct >= 226).astype(np.uint8) * 255)
    mproj, mv = scene_matrices(ct.shape, (1, 1, 1), 30, 20, 32)
    pm = rasterize.polygon2mask((32, 32), [(4, 4), (28, 6), (16, 30)], device="cpu").T
    one = rasterize.mask_cut(mask, (1, 1, 1), 1e9, pm, mproj, mv, 0)
    monkeypatch.setattr("invesalius3_tpu_torch.ops.reslice._SLAB_VOXELS", 3 * 24 * 24)
    assert torch.equal(rasterize.mask_cut(mask, (1, 1, 1), 1e9, pm, mproj, mv, 0), one)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase [11] on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_phase_11_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's phase [11] at a small size on the CPU, with its own
    checks (the numpy oracles, the identity interior, the re-threshold,
    the shear-warp frame against the gather raycaster, the mask cut's
    oracle slab) and the card-against-CPU comparison run CPU against CPU."""
    root = str(Path(__file__).resolve().parent.parent)
    monkeypatch.syspath_prepend(root)
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    chip_smoke = importlib.import_module("chip_smoke")
    stats = chip_smoke.viewer_3d(CPU, n=32, small=24, surf_n=24)
    assert {"apply_view_matrix_transform[tricubic]", "apply_reorientation",
            "mask_cut[include]", "render_surfaces"} <= set(stats)
    assert all(v["ms"] >= 0 for v in stats.values())
    raycast._VOLP_CACHE.clear()
    sys.modules.pop("chip_smoke", None)

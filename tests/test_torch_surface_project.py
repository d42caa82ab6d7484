"""The port's surfaces, Slice surface and mask methods, NIfTI and projects
against the JAX package.

``Slice.create_surface_from_mask`` runs on a JAX ``Slice`` carried over by
``convert.slice_from_jax``, for every quality preset and algorithm, with
and without keep-largest; the JAX surface is compared through
``convert.surface_from_jax`` (its padding orphan dropped).  Tolerances:
marching and decimation are exact, so 'Default' and 'Binary' surfaces are
equal array for array; a context-aware smoothed surface has the same faces
and vertices within one float16 step (the smoothing agrees within 1e-4 mm
before the float16 rounding, which can round the other way); volume and
area agree within a relative 1e-5 (float32 sums in another order), and
within 1e-4 where decimation started from vertices a float16 step apart
and so took other collapses (then the triangle count is compared, not the
faces).  ``calc_image_density`` agrees within a relative 1e-5 (float32
sums in another order).  NIfTI, the .inv3
members and the exports are byte for byte (compressed members compared
after decompression; main.plist's date and version excepted).
"""

import gzip
import plistlib
import struct
import tarfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu import constants as const_jax
from invesalius3_tpu.core import surface as surface_jax
from invesalius3_tpu.core.mask import Mask as MaskJax
from invesalius3_tpu.core.project import Project as ProjectJax
from invesalius3_tpu.core.slice import Slice as SliceJax
from invesalius3_tpu.core.volume import Volume as VolumeJax
from invesalius3_tpu.io import mesh_io as mesh_io_jax
from invesalius3_tpu.io import nifti as nifti_jax
from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch import convert
from invesalius3_tpu_torch.core import surface
from invesalius3_tpu_torch.core.project import Project
from invesalius3_tpu_torch.io import nifti

torch.set_num_threads(1)
FIXTURES = Path(__file__).parent / "fixtures"
SPACING = (0.5, 0.6, 0.7)


def _ct(n=24):
    """Skull-like int16 CT: a bone shell, soft tissue, a bone island and
    noise, from seed 0 (two bone components for keep-largest)."""
    zz, yy, xx = np.mgrid[:n, :n, :n].astype(np.float32)
    c = (n - 1) / 2.0
    r = np.sqrt((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2)
    ct = np.full((n, n, n), -1000, np.int16)
    ct[r < 0.42 * n] = 40
    ct[(r >= 0.32 * n) & (r < 0.42 * n)] = 1200
    ct[r < 0.12 * n] = 900
    return ct + np.random.default_rng(0).integers(-20, 20, ct.shape, dtype=np.int16)


@pytest.fixture(scope="module")
def slices():
    vol = VolumeJax.from_numpy(_ct(), spacing=SPACING)
    js = SliceJax(vol)
    js.create_new_mask(threshold_range=const_jax.THRESHOLD_PRESETS_CT["Bone"])
    return js, convert.slice_from_jax(js, device="cpu")


def _fp16_step(v):
    return np.spacing(np.abs(v).astype(np.float16)).astype(np.float32)


ALGORITHMS = {"Default": {}, "Binary": {"algorithm": "Binary"},
              "ca_grid": {"algorithm": "ca_smoothing"},
              "ca_mesh": {"algorithm": "ca_smoothing", "ca_options": {"propagate": "mesh"}}}


@pytest.mark.parametrize("keep_largest", [False, True])
@pytest.mark.parametrize("algorithm", sorted(ALGORITHMS))
@pytest.mark.parametrize("quality", sorted(const.SURFACE_QUALITY))
def test_create_surface_from_mask(slices, quality, algorithm, keep_largest):
    js, ps = slices
    opts = dict(ALGORITHMS[algorithm], quality=quality, keep_largest=keep_largest)
    want = convert.surface_from_jax(js.create_surface_from_mask(**opts))
    got = ps.create_surface_from_mask(**opts)
    assert got.vertices.dtype == np.float32 and got.faces.dtype == np.int32
    assert len(got.faces) == len(want.faces) > 100
    decimated = const.SURFACE_QUALITY[quality][3] > 0
    smoothed = algorithm.startswith("ca")
    if smoothed and decimated and not (
            got.vertices.shape == want.vertices.shape
            and np.array_equal(got.vertices, want.vertices)):
        rtol = 1e-4  # other collapses from inputs a float16 step apart
    else:
        rtol = 1e-5
        np.testing.assert_array_equal(got.faces, want.faces)
        atol = _fp16_step(want.vertices) if smoothed else 0
        np.testing.assert_array_less(np.abs(got.vertices - want.vertices), atol + 1e-12)
    np.testing.assert_allclose([got.volume, got.area], [want.volume, want.area], rtol=rtol)
    if keep_largest:
        from invesalius3_tpu_torch.ops import mesh

        assert len(np.unique(mesh.mesh_components(got.faces, len(got.vertices)))) == 1


def test_surface_stage_times_and_device(slices):
    _, ps = slices
    times = {}
    s = ps.create_surface_from_mask(algorithm="ca_smoothing", quality="Low",
                                    keep_largest=True, times=times)
    assert list(times) == ["marching", "smoothing", "to_host", "decimate",
                           "keep_largest", "mass_properties"]
    assert all(t >= 0 for t in times.values()) and s.volume > 0


def _pair(ps, **opts):
    """The port's surface and a JAX Surface on the same host arrays."""
    got = ps.create_surface_from_mask(**opts)
    want = surface_jax.Surface(vertices=got.vertices.copy(), faces=got.faces.copy(),
                               name=got.name)
    want.compute_properties()
    return got, want


def _same_surface(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_array_equal(got.faces, np.asarray(want.faces))
    np.testing.assert_allclose(got.vertices, np.asarray(want.vertices), rtol=0, atol=atol)
    np.testing.assert_allclose([got.volume, got.area], [want.volume, want.area], rtol=rtol)
    assert got.name == want.name and tuple(got.colour) == tuple(want.colour)


def test_split_seed_smooth_merge(slices):
    _, ps = slices
    got, want = _pair(ps)
    parts, want_parts = (surface.split_surface(got, device="cpu"),
                         surface_jax.split_surface(want))
    assert len(parts) == len(want_parts) == 3  # shell outside, inside, island
    for a, b in zip(parts, want_parts):
        _same_surface(a, b)
    pts = got.vertices[[0, len(got.vertices) - 1]] + 0.01
    for seeds, as_points in ((pts, True), ([0], False), ([len(got.vertices) - 1], False)):
        _same_surface(surface.surface_from_seeds(got, seeds, as_points, device="cpu"),
                      surface_jax.surface_from_seeds(want, seeds, as_points))
    _same_surface(surface.smooth_surface(got, 9, 0.3, device="cpu"),
                  surface_jax.smooth_surface(want, 9, 0.3), atol=1e-4)
    merged = surface.merge_surfaces(parts, device="cpu")
    _same_surface(merged, surface_jax.merge_surfaces(want_parts))


@pytest.mark.parametrize("fmt", [".stl", ".ply", ".obj", ".vtp", ".bin"])
@pytest.mark.parametrize("hole_size", [const.FILL_HOLES_MAX_SIZE, 0.0])
def test_import_surface_file_fills_holes(slices, tmp_path, fmt, hole_size):
    _, ps = slices
    got, _ = _pair(ps, keep_largest=True)
    path = tmp_path / f"open{fmt}"
    drop = np.zeros(len(got.faces), bool)
    drop[[3, 4, len(got.faces) // 2]] = True
    mesh_io_jax.export_surface(path, got.vertices, got.faces[~drop])
    a = surface.import_surface_file(path, hole_size, device="cpu")
    b = surface_jax.import_surface_file(path, hole_size)
    assert a.filled_holes == b.filled_holes and (a.filled_holes > 0) == (hole_size > 0)
    assert a.name == b.name == "open"
    _same_surface(a, b)


def test_calc_image_density(slices):
    js, ps = slices
    got, want = ps.calc_image_density(), js.calc_image_density()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[0] >= 226 and got[1] <= 3071 and got[3] > 0
    empty_j = js.create_new_mask(threshold_range=(5000, 6000))
    empty_p = convert.mask_from_jax(empty_j, device="cpu")
    assert ps.calc_image_density(empty_p) == js.calc_image_density(empty_j) == (0, 0, 0, 0)
    js.remove_mask(empty_j.index)


@pytest.mark.parametrize("region", ["bone_and_nan", "nan_only"])
def test_calc_image_density_nan_background(region):
    """A float32 image with a NaN background (a float NIfTI) under a mask
    that covers NaN voxels: NaN is skipped as by ``jnp.nan*``."""
    ct = _ct().astype(np.float32)
    ct[ct < -500] = np.nan
    js = SliceJax(VolumeJax.from_numpy(ct, spacing=SPACING))
    m = js.create_new_mask(apply_threshold=False)
    cover = np.isnan(ct) if region == "nan_only" else (ct > 500) | np.isnan(ct)
    m.data = jnp.asarray(cover.astype(np.uint8) * 255)
    ps = convert.slice_from_jax(js, device="cpu")
    got, want = ps.calc_image_density(), js.calc_image_density()
    assert np.isnan(got).all() == np.isnan(want).all() == (region == "nan_only")
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_import_mask_from_nifti(tmp_path):
    js = SliceJax(VolumeJax.from_numpy(_ct(), spacing=SPACING))
    ps = convert.slice_from_jax(js, device="cpu")
    labels = (_ct() > 500).astype(np.uint8) * 3
    path = tmp_path / "labels.nii.gz"
    nifti_jax.write_nifti(path, labels, spacing=SPACING)
    got, want = ps.import_mask_from_nifti(path), js.import_mask_from_nifti(path)
    np.testing.assert_array_equal(convert.to_numpy(got.data), np.asarray(want.data))
    assert got.name == want.name == "labels" and got.threshold_range == (0, 255)
    assert got.was_edited and ps.current_mask is got and ps.masks[got.index] is got
    assert int(got.visible_array().sum()) == int((labels > 0).sum()) > 0
    nifti_jax.write_nifti(tmp_path / "small.nii", labels[:4])
    with pytest.raises(ValueError, match="does not match"):
        ps.import_mask_from_nifti(tmp_path / "small.nii")


# ---------------------------------------------------------------------------
# NIfTI
# ---------------------------------------------------------------------------


def _nifti2(path, data, affine):
    """A NIfTI-2 single file (540-byte header, 544-byte offset)."""
    hdr = bytearray(544)
    struct.pack_into("<i", hdr, 0, 540)
    hdr[4:12] = b"n+2\0\r\n\x1a\n"
    struct.pack_into("<hh", hdr, 12, 4, 16)
    struct.pack_into("<8q", hdr, 16, 3, *data.shape[::-1], 1, 1, 1, 1)
    struct.pack_into("<8d", hdr, 104, 1.0, 1.0, 1.0, 1.0, 0, 0, 0, 0)
    struct.pack_into("<q", hdr, 168, 544)
    struct.pack_into("<dd", hdr, 176, 2.0, -5.0)  # scl_slope, scl_inter
    struct.pack_into("<ii", hdr, 344, 0, 1)  # qform_code, sform_code
    for i in range(3):
        struct.pack_into("<4d", hdr, 400 + 32 * i, *affine[i])
    Path(path).write_bytes(bytes(hdr) + data.astype("<i2").tobytes())


def _analyze(tmp_path, data):
    """An Analyze 7.5 pair (.hdr/.img): no magic, pixdim affine."""
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape[::-1], 1, 1, 1, 1)
    struct.pack_into("<hh", hdr, 70, 4, 16)
    struct.pack_into("<8f", hdr, 76, 1.0, 0.9, 0.8, 1.5, 0, 0, 0, 0)
    (tmp_path / "a.hdr").write_bytes(bytes(hdr))
    (tmp_path / "a.img").write_bytes(data.astype("<i2").tobytes())
    return tmp_path / "a.hdr"


def _same_image(path, **kw):
    got, want = nifti.read_nifti(path, **kw), nifti_jax.read_nifti(path, **kw)
    assert got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.affine, want.affine)
    assert got.spacing == want.spacing
    return got


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_write_and_read(tmp_path, suffix, dtype):
    rng = np.random.default_rng(1)
    data = (rng.normal(0, 100, (5, 7, 6)) + 120).astype(dtype)
    aff = np.array([[-0.9, 0, 0, 10.0], [0, 0, 1.2, -3.0], [0, 0.8, 0, 2.0],
                    [0, 0, 0, 1]])  # flipped x and swapped y/z: canonicalised
    a, b = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    nifti.write_nifti(a, data, affine=aff)
    nifti_jax.write_nifti(b, data, affine=aff)
    read = (lambda p: gzip.decompress(p.read_bytes())) if suffix == ".nii.gz" else \
        (lambda p: p.read_bytes())
    assert read(a) == read(b)
    for p in (a, b):
        img = _same_image(p)
    assert (np.diag(img.affine)[:3] > 0).all() and img.data.shape != data.shape


def test_nifti2_analyze_and_4d(tmp_path):
    data = np.random.default_rng(2).integers(-50, 50, (4, 5, 6)).astype(np.int16)
    aff = np.array([[0.7, 0, 0, 1.0], [0, -0.7, 0, 2.0], [0, 0, 1.1, 3.0], [0, 0, 0, 1]])
    _nifti2(tmp_path / "v2.nii", data, aff)
    img = _same_image(tmp_path / "v2.nii")
    assert img.data.dtype == np.float32 and img.data.shape == data.shape
    _same_image(_analyze(tmp_path, data))
    vol4 = np.random.default_rng(3).random((3, 4, 5, 2)).astype(np.float32)
    nifti.write_nifti(tmp_path / "v4.nii", vol4)
    assert _same_image(tmp_path / "v4.nii", keep_4d=True).data.shape == vol4.shape


# ---------------------------------------------------------------------------
# Projects
# ---------------------------------------------------------------------------


def _jax_project(slices):
    """A JAX project: the CT, its bone mask, an edited mask, two surfaces
    (no padding orphan), an image version and a measurement."""
    js, ps = slices
    p = ProjectJax.from_matrix("proj", _ct(), spacing=SPACING)
    p.window, p.level = 400.0, 40.0
    m = js.current_mask
    p.add_mask(m)
    edited = MaskJax(index=7, name="edited")
    edited.data = jnp.asarray(np.asarray(m.data) // 255 * 253)
    edited.was_edited = True
    p.add_mask(edited)
    for keep in (False, True):
        s = ps.create_surface_from_mask(keep_largest=keep)
        js_s = surface_jax.Surface(vertices=s.vertices, faces=s.faces, name=f"s{keep}")
        js_s.compute_properties()
        p.add_surface(js_s)
    p.image_versions = [("original", p.volume.data),
                        ("smoothed", p.volume.data // 2)]
    p.measurement_dict = {0: {"type": 6, "value": 5.0, "points": [[1.0, 2.0, 3.0]]}}
    return p


def _members(path):
    with tarfile.open(path, "r:*") as tar:
        return {Path(m.name).name: tar.extractfile(m).read()
                for m in tar.getmembers() if m.isfile()}


def _same_project(got, want):
    for attr in ("name", "modality", "original_orientation", "window", "level",
                 "compress"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert tuple(got.threshold_range) == tuple(want.threshold_range)
    np.testing.assert_array_equal(got.image_fiducials, np.asarray(want.image_fiducials))
    np.testing.assert_array_equal(convert.to_numpy(got.volume.data), np.asarray(want.volume.data))
    assert tuple(got.spacing) == tuple(want.spacing)
    assert (got.affine is None) == (want.affine is None)
    if got.affine is not None:
        np.testing.assert_array_equal(got.affine, np.asarray(want.affine))
    assert sorted(got.mask_dict) == sorted(want.mask_dict)
    for i, m in got.mask_dict.items():
        w = want.mask_dict[i]
        np.testing.assert_array_equal(convert.to_numpy(m.data), np.asarray(w.data))
        for attr in ("name", "colour", "opacity", "threshold_range",
                     "edition_threshold_range", "is_shown", "was_edited", "spacing"):
            assert tuple(np.atleast_1d(getattr(m, attr))) == tuple(
                np.atleast_1d(getattr(w, attr))), attr
    assert sorted(got.surface_dict) == sorted(want.surface_dict)
    for i, s in got.surface_dict.items():
        w = want.surface_dict[i]
        np.testing.assert_array_equal(s.vertices, np.asarray(w.vertices))
        np.testing.assert_array_equal(s.faces, np.asarray(w.faces))
        for attr in ("index", "name", "colour", "transparency", "volume", "area",
                     "is_shown", "category"):
            assert np.all(getattr(s, attr) == getattr(w, attr)), attr
    assert [lbl for lbl, _ in got.image_versions] == [lbl for lbl, _ in want.image_versions]
    for (_, a), (_, b) in zip(got.image_versions, want.image_versions):
        np.testing.assert_array_equal(convert.to_numpy(a), np.asarray(b))
    assert got.measurement_dict == want.measurement_dict


@pytest.mark.parametrize("compress", [False, True])
def test_project_save_and_open_both_ways(slices, tmp_path, compress):
    jp = _jax_project(slices)
    pp = convert.project_from_jax(jp, device="cpu")
    _same_project(pp, jp)
    a, b = tmp_path / "port.inv3", tmp_path / "jax.inv3"
    pp.save(a, compress=compress)
    jp.save(b, compress=compress)
    ma, mb = _members(a), _members(b)
    assert sorted(ma) == sorted(mb)
    for name in ma:
        if name != "main.plist":
            assert ma[name] == mb[name], name
    pa, pb = plistlib.loads(ma["main.plist"]), plistlib.loads(mb["main.plist"])
    for key in ("date", "invesalius_version"):
        pa.pop(key), pb.pop(key)
    np.testing.assert_array_equal(pa.pop("image_fiducials"), pb.pop("image_fiducials"))
    assert pa == pb and pa["compress"] is compress
    with open(a, "rb") as f:
        assert (f.read(2) == b"\x1f\x8b") is compress
    _same_project(Project.open(b, device="cpu"), ProjectJax.open(b))
    _same_project(Project.open(a, device="cpu"), ProjectJax.open(a))


@pytest.mark.parametrize("fixture", ["reference_layout.inv3", "repo_written.inv3"])
def test_fixtures_open(fixture):
    _same_project(Project.open(FIXTURES / fixture, device="cpu"),
                  ProjectJax.open(FIXTURES / fixture))


def test_project_from_matrix_and_slice():
    ct = _ct(12)
    got = Project.from_matrix("m", ct.astype(np.int32), spacing=SPACING, device="cpu")
    want = ProjectJax.from_matrix("m", ct.astype(np.int32), spacing=SPACING)
    assert (got.window, got.level) == (want.window, want.level)
    np.testing.assert_array_equal(convert.to_numpy(got.volume.data), np.asarray(want.volume.data))
    slc = got.make_slice()
    assert (slc.window_width, slc.window_level) == (got.window, got.level)
    with pytest.raises(ValueError, match="int16"):
        Project.from_matrix("m", ct.astype(np.float32), device="cpu")


def test_exports(slices, tmp_path):
    import h5py

    jp = _jax_project(slices)
    pp = convert.project_from_jax(jp, device="cpu")
    for index in (None, 7):
        a, b = tmp_path / f"p{index}.nii", tmp_path / f"j{index}.nii"
        pp.export_to_nifti(a, mask_index=index)
        jp.export_to_nifti(b, mask_index=index)
        assert a.read_bytes() == b.read_bytes()
    pp.export_to_hdf5(tmp_path / "p.h5")
    jp.export_to_hdf5(tmp_path / "j.h5")
    with h5py.File(tmp_path / "p.h5") as fa, h5py.File(tmp_path / "j.h5") as fb:
        names = []
        fa.visit(names.append)
        want = []
        fb.visit(want.append)
        assert names == want
        for n in names:
            if isinstance(fa[n], h5py.Dataset):
                np.testing.assert_array_equal(fa[n][()], fb[n][()])
            assert dict(fa[n].attrs).keys() == dict(fb[n].attrs).keys()


# ---------------------------------------------------------------------------
# convert: surfaces and projects carried over
# ---------------------------------------------------------------------------


def test_surface_from_jax_orphan_and_not(slices):
    js, ps = slices
    js_s = js.create_surface_from_mask()  # a padded marching mesh: orphan at 0
    counter = surface.Surface._counter[0]
    got = convert.surface_from_jax(js_s)
    assert surface.Surface._counter[0] == counter
    assert not (np.asarray(js_s.faces) == 0).any()
    assert len(got.vertices) == len(js_s.vertices) - 1
    np.testing.assert_array_equal(got.faces, np.asarray(js_s.faces) - 1)
    np.testing.assert_array_equal(got.vertices, np.asarray(js_s.vertices)[1:])
    assert (got.index, got.name, got.volume) == (js_s.index, js_s.name, js_s.volume)
    kept = js.create_surface_from_mask(keep_largest=True)  # keep-largest drops it
    same = convert.surface_from_jax(kept)
    np.testing.assert_array_equal(same.vertices, np.asarray(kept.vertices))
    np.testing.assert_array_equal(same.faces, np.asarray(kept.faces))
    port = ps.create_surface_from_mask()
    np.testing.assert_array_equal(port.faces, got.faces)
    np.testing.assert_array_equal(port.vertices, got.vertices)


def test_project_from_jax_shares_the_volume(slices):
    pp = convert.project_from_jax(_jax_project(slices), device="cpu")
    assert pp.image_versions[0][1] is pp.volume.data
    assert len(pp.image_versions) == 2 and isinstance(pp.image_versions[1][1], torch.Tensor)

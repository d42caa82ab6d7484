"""The port's CUDA kernels on the card, held against their plain versions.

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they run where the card is:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch import pipeline
from invesalius3_tpu_torch.core.slice import Slice
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.ops import kernels, marching, watershed
from invesalius3_tpu_torch.ops import projection_kernels as rays

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", kernels.SWEEP_CHECK_SHAPES)
@pytest.mark.parametrize("lab_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_kernel_bit_exact(cuda, axis, lab_dtype, shape):
    case = kernels.sweep_case(shape, lab_dtype, seed=axis)
    want = kernels.watershed_sweep_ref(
        *(torch.from_numpy(a.copy()).to(cuda) for a in case), axis)
    before = kernels.LAUNCHES[axis]
    got = kernels.watershed_sweep(
        *(torch.from_numpy(a.copy()).to(cuda) for a in case), axis)
    torch.cuda.synchronize()
    # an axis shorter than 2 has nothing to relax: no kernel is launched
    assert kernels.LAUNCHES[axis] == before + (shape[axis] >= 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sweep_kernel_unaligned_int16_labels(cuda):
    """int16 labels at an odd element offset cannot go as 4-byte pairs:
    the kernel stages them (x even, so only the pointer decides)."""
    rank, lab, f = kernels.sweep_case((6, 7, 130), np.int16, seed=4)
    want = kernels.watershed_sweep_ref(*(torch.from_numpy(a.copy()).to(cuda)
                                         for a in (rank, lab, f)), 2)
    buf = torch.zeros(lab.size + 1, dtype=torch.int16, device=cuda)
    lab_d = buf[1:].view(lab.shape)
    lab_d.copy_(torch.from_numpy(lab))
    assert lab_d.data_ptr() % 4 == 2 and lab_d.is_contiguous()
    got = kernels.watershed_sweep(torch.from_numpy(rank).to(cuda), lab_d,
                                  torch.from_numpy(f).to(cuda), 2)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sweep_kernel_rejects_non_contiguous(cuda):
    rank, lab, f = (torch.from_numpy(a).to(cuda) for a in
                    kernels.sweep_case((8, 9, 10), np.int32, seed=0))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.watershed_sweep(rank.transpose(0, 2), lab.transpose(0, 2),
                                f.transpose(0, 2), 0)


@pytest.mark.parametrize("marker_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("levels", [0, 2])
def test_small_slice_kernel_equals_plain(cuda, levels, marker_dtype, tmp_path):
    n = 48
    ct, markers = pipeline.make_ct(n), pipeline.bench_markers(n).astype(marker_dtype)
    ct_d, m_d = torch.from_numpy(ct).to(cuda), torch.from_numpy(markers).to(cuda)
    rounds_k, rounds_p = [], []
    got = watershed.watershed(ct_d, m_d, multigrid_levels=levels, rounds=rounds_k)
    want = watershed.watershed(ct_d, m_d, multigrid_levels=levels,
                               sweep=kernels.watershed_sweep_ref, rounds=rounds_p)
    assert torch.equal(got, want) and rounds_k == rounds_p
    mask = torch.where(got == 1, 255, 0).to(torch.uint8)
    dm = marching.mask_to_surface_device(mask, spacing=pipeline.SPACING)
    assert dm.n_tris > 0 and bool(torch.isfinite(dm.verts3v).all())


RAY_CASES = rays.ray_cases()


def _same(got, want):
    """Bit for bit, NaN where the other is NaN."""
    return (got.dtype == want.dtype and got.shape == want.shape
            and bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all()))


@pytest.mark.parametrize("case", range(len(RAY_CASES)),
                         ids=[c.label for c in RAY_CASES])
def test_ray_kernels_against_plain(cuda, case):
    """LMIP bit-exact; MIDA within atol 1 after the cast to an integer dtype
    (float32 is expected bit-exact too: the library is built without FMA
    contraction; the bound here is the JAX package's own); one launch
    counted per call."""
    case = RAY_CASES[case]
    axis = case.axis
    slab = rays.case_slab(case, cuda)
    for tmin, tmax in rays.LMIP_PARAMS:
        before = rays.LAUNCHES["lmip"][axis]
        got = rays.lmip_rays(slab, axis, tmin, tmax)
        torch.cuda.synchronize()
        assert rays.LAUNCHES["lmip"][axis] == before + 1
        assert _same(got, rays.lmip_ref(slab, axis, tmin, tmax))
    for wl, ww in rays.MIDA_PARAMS:
        before = rays.LAUNCHES["mida"][axis]
        got = rays.mida_rays(slab, axis, wl, ww)
        torch.cuda.synchronize()
        assert rays.LAUNCHES["mida"][axis] == before + 1
        want = rays.mida_ref(slab, axis, wl, ww)
        assert got.dtype == want.dtype
        diff = (got.double() - want.double()).abs()
        both_nan = torch.isnan(got) & torch.isnan(want)
        assert bool((both_nan | (diff <= 1)).all())


@pytest.mark.parametrize("case", range(len(RAY_CASES)),
                         ids=[c.label for c in RAY_CASES])
def test_minmax_pass_is_aminmax(cuda, case):
    slab = rays.case_slab(RAY_CASES[case], cuda)
    before = rays.LAUNCHES["minmax"][0]
    got = rays.slab_minmax(slab)
    torch.cuda.synchronize()
    assert rays.LAUNCHES["minmax"][0] == before + 1
    assert _same(got, torch.stack(torch.aminmax(slab)).to(torch.float32))


def dtype_np(dtype):
    return {torch.int16: np.int16, torch.uint8: np.uint8, torch.float32: np.float32}[dtype]


@pytest.mark.parametrize("dtype", [torch.int16, torch.uint8, torch.float32])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_mida_runs_only_its_kernels(cuda, monkeypatch, axis, dtype):
    """For the kernels' own dtypes the wrapper launches the min/max pass and
    the walk and nothing else: no torch.aminmax, no cast_like_jax."""
    slab = torch.from_numpy(rays.ray_case((20, 24, 70), dtype_np(dtype), 3)).to(cuda)
    want = rays.mida_ref(slab, axis, 40.0, 400.0)

    def refuse(*a, **k):
        raise AssertionError("called on the kernel path")
    monkeypatch.setattr(torch, "aminmax", refuse)
    monkeypatch.setattr(rays, "cast_like_jax", refuse)
    got = rays.mida_rays(slab, axis, 40.0, 400.0)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert bool(((got.double() - want.double()).abs() <= 1).all())


def test_widened_dtype_takes_the_cast(cuda):
    """int32 is walked as float32 and cast like JAX."""
    slab = torch.from_numpy(rays.ray_case((9, 13, 40), np.int16, 2).astype(np.int32)).to(cuda)
    for axis in (0, 1, 2):
        got = rays.mida_rays(slab, axis, 40.0, 400.0)
        want = rays.mida_ref(slab, axis, 40.0, 400.0)
        assert got.dtype == torch.int32
        assert bool(((got.double() - want.double()).abs() <= 1).all())
        assert torch.equal(rays.lmip_rays(slab, axis, 30.0, 500.0),
                           rays.lmip_ref(slab, axis, 30.0, 500.0))


@pytest.mark.parametrize("via_copy", [False, True])
def test_ray_kernels_axis2_both_routes(cuda, via_copy):
    """Axis 2 walked as the strided view (the rows route), and as a
    contiguous (X, Z, Y) copy along axis 0 (the columns route)."""
    slab = torch.from_numpy(rays.ray_case((40, 33, 70), np.int16, 7)).to(cuda)
    work, axis = (slab.movedim(2, 0).contiguous(), 0) if via_copy else (slab, 2)
    assert torch.equal(rays.lmip_rays(work, axis, 30.0, 500.0),
                       rays.lmip_ref(slab, 2, 30.0, 500.0))
    assert torch.equal(rays.mida_rays(work, axis, 40.0, 400.0),
                       rays.mida_ref(slab, 2, 40.0, 400.0))


@pytest.mark.parametrize("orientation", [const.AXIAL, const.CORONAL, const.SAGITTAL])
def test_slab_frames_kernel_equals_plain(cuda, orientation):
    ct = pipeline.make_ct(48)
    slc = Slice(Volume.from_numpy(ct, device=cuda, window_width=400.0,
                                  window_level=40.0))
    slc.create_new_mask(threshold_range=const.THRESHOLD_PRESETS_CT["Bone"])
    rays.reset_launches()
    for proj in (const.PROJECTION_LMIP, const.PROJECTION_MIDA,
                 const.PROJECTION_CONTOUR_LMIP, const.PROJECTION_CONTOUR_MIDA):
        for start, slabs in ((10, 16), (0, 48)):
            got = slc.get_rendered_slice(orientation, start, projection=proj,
                                         slabs=slabs)
            want = slc.get_rendered_slice(orientation, start, projection=proj,
                                          slabs=slabs, plain=True)
            assert got.shape == (48, 48, 3)
            assert np.array_equal(got, want)
    axis = const.ORIENTATION_AXIS[orientation]
    assert rays.LAUNCHES["lmip"][axis] == 4 and rays.LAUNCHES["mida"][axis] == 4


def test_decimate_library_builds_from_the_ports_source():
    """The QEM decimator is a host library (g++): it builds and runs with or
    without a card, and its build failing would raise, not fall back."""
    from invesalius3_tpu_torch import _build, native

    lib = _build.decimate_lib()
    assert hasattr(lib, "decimate_qem")
    v = np.array([[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], np.float32)
    f = np.array([[0, 2, 1], [1, 2, 3], [4, 5, 6], [5, 7, 6], [0, 1, 4], [1, 5, 4],
                  [2, 6, 3], [3, 6, 7], [0, 4, 2], [2, 4, 6], [1, 3, 5], [3, 7, 5]],
                 np.int32)
    dv, df = native.decimate_qem(v, f, 0.5)
    assert len(df) <= 6 and df.max() < len(dv)


def _bone_slice(dev, n=64):
    vol = Volume.from_numpy(pipeline.make_ct(n), spacing=pipeline.SPACING, device=dev)
    slc = Slice(vol)
    slc.create_new_mask(threshold_range=const.THRESHOLD_PRESETS_CT["Bone"])
    return slc


@pytest.mark.parametrize("case", ["Default", "Default-Low", "ca_grid", "ca_mesh",
                                  "ca_grid-keep_largest"])
def test_surface_flow_card_equals_cpu(cuda, case):
    """create_surface_from_mask at 64^3 on the card against the CPU: the
    same faces; Default vertices equal, smoothed vertices within one
    float16 step (reductions run in another order on the card); volume and
    area within a relative 1e-5."""
    name, _, extra = case.partition("-")
    opts = {"ca_grid": {"algorithm": "ca_smoothing"},
            "ca_mesh": {"algorithm": "ca_smoothing",
                        "ca_options": {"propagate": "mesh"}}}.get(name, {})
    if extra == "Low":
        opts["quality"] = "Low"
    if extra == "keep_largest":
        opts["keep_largest"] = True
    got = _bone_slice(cuda).create_surface_from_mask(**opts)
    want = _bone_slice(torch.device("cpu")).create_surface_from_mask(**opts)
    np.testing.assert_array_equal(got.faces, want.faces)
    step = np.spacing(np.abs(want.vertices).astype(np.float16)).astype(np.float32)
    assert (np.abs(got.vertices - want.vertices) <= (step if name != "Default" else 0)).all()
    np.testing.assert_allclose([got.volume, got.area], [want.volume, want.area], rtol=1e-5)


def test_app_on_the_card_equals_cpu(cuda, tmp_path, monkeypatch):
    from invesalius3_tpu_torch import app
    from invesalius3_tpu_torch.core.project import Project
    from invesalius3_tpu_torch.io import nifti

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    nifti.write_nifti(tmp_path / "ct.nii", pipeline.make_ct(48), spacing=pipeline.SPACING)
    for side, dev in (("card", cuda), ("cpu", "cpu")):
        assert app.main(["--import-file", str(tmp_path / "ct.nii"), "-t", "Bone",
                         "-e", str(tmp_path / f"{side}.stl"),
                         "-s", str(tmp_path / f"{side}.inv3")], device=dev) == 0
    assert (tmp_path / "card.stl").read_bytes() == (tmp_path / "cpu.stl").read_bytes()
    card, cpu = (Project.open(tmp_path / f"{s}.inv3", device=d)
                 for s, d in (("card", cuda), ("cpu", "cpu")))
    assert card.volume.data.device.type == "cuda"
    assert torch.equal(card.mask_dict[next(iter(card.mask_dict))].data.cpu(),
                       cpu.mask_dict[next(iter(cpu.mask_dict))].data)


@pytest.mark.parametrize("tilt", [-20.0, 7.5, 15.0])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_gantry_tilt_card_equals_cpu(cuda, dtype, tilt):
    """fix_gantry_tilt on the card against the CPU: every step rounds to
    float32 alike on both (0-d float32 tensors keep the divisions IEEE), so
    the stated tolerance, equality on at least 99.9% of voxels and one grey
    level everywhere, holds with room; float volumes are compared as
    floats."""
    from invesalius3_tpu_torch.io import dicom

    vol = pipeline.make_ct(64).astype(dtype)
    got = dicom.fix_gantry_tilt(vol, (0.5, 0.5, 0.625), tilt, device=cuda)
    want = dicom.fix_gantry_tilt(vol, (0.5, 0.5, 0.625), tilt, device="cpu")
    assert got.device.type == "cuda" and got.dtype == want.dtype
    diff = (got.cpu().double() - want.double()).abs()
    if dtype == np.int16:
        assert float(diff.max()) <= 1 and float((diff == 0).double().mean()) >= 0.999
    else:
        assert float(diff.max()) <= 1e-3 * float(want.abs().max())


def test_dicom_import_card_equals_cpu(cuda, tmp_path, monkeypatch):
    """A tilted DICOM series through group_to_volume and app -i on the card
    and on the CPU: the same volume within the tilt's tolerance, the same
    STL where the volumes are equal."""
    from invesalius3_tpu_torch import app
    from invesalius3_tpu_torch.io import dicom

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    ct = pipeline.make_ct(48)
    for z, sl in enumerate(ct):
        dicom.write_dicom(tmp_path / f"s{z:03d}.dcm", sl, {
            "SeriesInstanceUID": "1.2.3", "Modality": "CT",
            "ImagePositionPatient": [0.0, 0.0, 0.5 * z], "PixelSpacing": [0.5, 0.5],
            "ImageOrientationPatient": [1, 0, 0, 0, 1, 0], "GantryDetectorTilt": 15.0})
    group = dicom.load_dicom_dir(tmp_path)[0]
    got, sp, aff = dicom.group_to_volume(group, device=cuda)
    want, sp_cpu, aff_cpu = dicom.group_to_volume(group, device="cpu")
    assert got.device.type == "cuda" and sp == sp_cpu and np.array_equal(aff, aff_cpu)
    diff = (got.cpu().int() - want.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).double().mean()) >= 0.999
    for side, dev in (("card", cuda), ("cpu", "cpu")):
        assert app.main(["-i", str(tmp_path), "-t", "Bone",
                         "-e", str(tmp_path / f"{side}.stl")], device=dev) == 0
    if torch.equal(got.cpu(), want):
        assert (tmp_path / "card.stl").read_bytes() == (tmp_path / "cpu.stl").read_bytes()


# the mask-editing tools on the card against the same calls on the CPU:
# masks, labels and integer images equal; float images within 1e-5 of the
# input's range (the filters round each product and sum alike on both)


def _edit_inputs(n=40):
    from invesalius3_tpu_torch.ops import threshold

    ct = torch.from_numpy(pipeline.make_ct(n))
    return ct, threshold.threshold_new_mask(ct, 226, 3071)


def _edit_ops():
    from invesalius3_tpu_torch.ops import connected, filters, floodfill, morphology

    brush = morphology.brush_element(1.5, pipeline.SPACING)
    c = 20
    return {
        "binary_closing": lambda ct, m: morphology.binary_closing(m, morphology.structure_3d(18)),
        "paint_brush_trajectory": lambda ct, m: morphology.paint_brush_trajectory(
            m, brush, [(0, 0, 0), (c, c, 36), (39, 39, 39)], 1, brush.shape),
        "thresh_erase": lambda ct, m: morphology.paint_brush_trajectory_threshold(
            m, ct, brush, [(c, c, 34), (c, c, 36)], 226, 3071, brush.shape, "thresh_erase"),
        "floodfill_threshold": lambda ct, m: floodfill.floodfill_threshold(
            ct, floodfill.seeds_to_mask(ct.shape, [(c, c, 36)], device=ct.device), 226, 3071),
        "floodfill_auto_threshold": lambda ct, m: floodfill.floodfill_auto_threshold(
            ct, floodfill.seeds_to_mask(ct.shape, [(c, c, 28)], device=ct.device), 0.8),
        "region_grow_dynamic": lambda ct, m: floodfill.region_grow_dynamic(
            ct, (c, c, 30), 30.0, 30.0, True, 400.0, 40.0),
        "region_grow_confidence": lambda ct, m: floodfill.region_grow_confidence(ct, (c, c, 30)),
        "label": lambda ct, m: connected.label(m, 26),
        "largest_component": lambda ct, m: connected.largest_component(m > 0),
        "fill_holes_automatically": lambda ct, m: connected.fill_holes_automatically(m, 500),
        "select_part": lambda ct, m: connected.select_part(m, (c, c, c)),
        "gaussian": lambda ct, m: filters.gaussian(ct.float(), 1.0),
        "median": lambda ct, m: filters.median(ct, 3, batch_dims=1),
        "mean": lambda ct, m: filters.mean(ct, 5),
        "sharpen": lambda ct, m: filters.sharpen(ct, 1.0),
        "border_detection": lambda ct, m: filters.border_detection(ct.float(), 1.0,
                                                                   batch_dims=1),
        "convolve_non_zero": lambda ct, m: filters.convolve_non_zero(
            (m > 0).float(), np.arange(27, dtype=np.float32).reshape(3, 3, 3), 1.0),
    }


@pytest.mark.parametrize("name", sorted(_edit_ops()))
def test_mask_editing_card_equals_cpu(cuda, name):
    fn = _edit_ops()[name]
    ct, m = _edit_inputs()
    want = fn(ct, m)
    got = fn(ct.to(cuda), m.to(cuda))
    assert got.device.type == "cuda" and got.dtype == want.dtype
    got = got.cpu()
    if want.dtype.is_floating_point:
        span = float(want.max() - want.min())
        assert float((got - want).abs().max()) <= 1e-5 * max(span, 1.0)
    else:
        assert torch.equal(got, want)


def test_count_regions_card_equals_cpu(cuda):
    from invesalius3_tpu_torch.ops import connected

    ct, m = _edit_inputs()
    got, n = connected.count_regions(m.to(cuda) > 0, 6)
    want, n_want = connected.count_regions(m > 0, 6)
    assert n == n_want == 2 and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the 3D viewer's path: card against CPU (plain PyTorch on both)
# ---------------------------------------------------------------------------


def _frames_close(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.mean() <= 0.1 and (d > 2).mean() <= 1e-3, (d.mean(), (d > 2).mean())


def _ints_close(got, want):
    d = (got.long() - want.long()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-2


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_reslice_card_equals_cpu(cuda, method):
    from invesalius3_tpu_torch.ops import reslice, transforms

    ct = torch.from_numpy(pipeline.make_ct(48))
    c = np.array([12.0, 12.0, 12.0])
    m = (transforms.translation_matrix(c) @ transforms.euler_matrix(0.3, -0.2, 0.35).T
         @ transforms.translation_matrix(-c)).astype(np.float32)
    args = ((0.5, 0.5, 0.5), m, 4, "CORONAL", method, -1000.0, (40, 48, 48))
    want = reslice.apply_view_matrix_transform(ct, *args)
    got = reslice.apply_view_matrix_transform(ct.to(cuda), *args)
    assert got.device.type == "cuda" and got.dtype == want.dtype
    if method == 0:
        assert torch.equal(got.cpu(), want)
    else:
        _ints_close(got.cpu(), want)


def test_apply_reorientation_card_equals_cpu(cuda):
    ct = pipeline.make_ct(40)

    def run(dev):
        slc = Slice(Volume.from_numpy(ct, spacing=(0.5, 0.6, 0.7), device=dev))
        m = slc.create_new_mask(threshold_range=(226, 3071))
        d = m.data.clone()
        d[10:20, 12:22, 14:24] = 254
        m.apply(d)
        soft = slc.create_new_mask(threshold_range=(-100, 200))
        slc.apply_reorientation(angles=(0.2, -0.1, 0.35))
        return slc.matrix.cpu(), m.data.cpu(), soft.data.cpu()

    got, want = run(cuda), run("cpu")
    _ints_close(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert float((got[2] != want[2]).float().mean()) <= 1e-2


@pytest.mark.parametrize("name,ds", [("Bone", 1), ("Soft + Skin", 1), ("MIP", 1), ("Bone", 2)])
def test_shear_warp_card_equals_cpu(cuda, name, ds):
    from invesalius3_tpu_torch.ops import raycast

    ct = torch.from_numpy(pipeline.make_ct(64))
    p = raycast.builtin_preset(name)
    for az, el in [(30, 20), (0, 89), (-90, 0)]:
        want = raycast.shear_warp_render(ct, (0.5, 0.5, 0.5), p, az, el, 64, downsample=ds)
        got = raycast.shear_warp_render(ct.to(cuda), (0.5, 0.5, 0.5), p, az, el, 64,
                                        downsample=ds)
        _frames_close(got, want)
    raycast._VOLP_CACHE.clear()


@pytest.mark.parametrize("name", ["Bone", "MIP"])
def test_gather_raycast_card_equals_cpu(cuda, name):
    from invesalius3_tpu_torch.ops import raycast

    ct = torch.from_numpy(pipeline.make_ct(32))
    p = raycast.builtin_preset(name)
    plane = np.array([1.0, 0.2, 0.0, -16.0], np.float32)
    want = raycast.render(ct, (0.5, 0.5, 0.5), p, 30, 20, 48, 64, crop_plane=plane)
    got = raycast.render(ct.to(cuda), (0.5, 0.5, 0.5), p, 30, 20, 48, 64, crop_plane=plane)
    _frames_close(got, want)


def test_splat_renderer_card_equals_cpu(cuda):
    from invesalius3_tpu_torch.ops import render_mesh

    slc = Slice(Volume.from_numpy(pipeline.make_ct(40), spacing=(0.5, 0.5, 0.5),
                                  device="cpu"))
    s = slc.create_surface_from_mask(slc.create_new_mask(threshold_range=(226, 3071)))
    meshes = [(s.vertices, s.faces, (0.9, 0.85, 0.75))]
    for kw in ({}, {"ssao": True}):
        want = render_mesh.render_surfaces(meshes, size=128, device="cpu", **kw)
        got = render_mesh.render_surfaces(meshes, size=128, device=cuda, **kw)
        assert (got != want).any(-1).mean() <= 5e-3
    meshes = [meshes[0] + (0.5,)]
    want = render_mesh.render_surfaces(meshes, size=128, device="cpu")
    got = render_mesh.render_surfaces(meshes, size=128, device=cuda)
    assert (got != want).any(-1).mean() <= 5e-3
    k_cpu = render_mesh.remove_non_visible_faces(s.vertices, s.faces, size=128, device="cpu")
    k_gpu = render_mesh.remove_non_visible_faces(s.vertices, s.faces, size=128, device=cuda)
    assert abs(len(k_gpu[1]) - len(k_cpu[1])) <= 1e-3 * len(s.faces)


@pytest.mark.parametrize("edit_mode", [0, 1])
def test_mask_cut_card_equals_cpu(cuda, edit_mode):
    import chip_smoke
    from invesalius3_tpu_torch.ops import rasterize

    ct = pipeline.make_ct(48)
    mask = torch.from_numpy((ct >= 226).astype(np.uint8) * 255)
    mproj, mv = chip_smoke._scene_matrices(ct.shape, (0.5, 0.5, 0.5), 30, 20, 96)
    poly = [(10, 12), (80, 20), (60, 90), (5, 60)]
    want_pm = rasterize.polygon2mask((96, 96), poly, device="cpu").t()
    got_pm = rasterize.polygon2mask((96, 96), poly, device=cuda).t()
    assert torch.equal(got_pm.cpu(), want_pm)
    for depth in (1e9, 12.0):
        want = rasterize.mask_cut(mask, (0.5, 0.5, 0.5), depth, want_pm, mproj, mv, edit_mode)
        got = rasterize.mask_cut(mask.to(cuda), (0.5, 0.5, 0.5), depth, got_pm, mproj, mv,
                                 edit_mode)
        assert float((got.cpu() != want).float().mean()) <= 1e-4

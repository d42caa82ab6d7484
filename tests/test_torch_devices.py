"""The port's entry points run on the card unless the caller passes
``device="cpu"``: each defaults to CUDA, raises without a card instead of
falling back, and puts its tensors on the CPU only when asked."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu.core.mask import Mask as MaskJax
from invesalius3_tpu.core.slice import Slice as SliceJax
from invesalius3_tpu.core.volume import Volume as VolumeJax
from invesalius3_tpu.ops import marching as marching_jax
from invesalius3_tpu.core.project import Project as ProjectJax
from invesalius3_tpu_torch import app, convert, device, pipeline
from invesalius3_tpu_torch.core import surface
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.core.project import Project
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.io import dicom
from invesalius3_tpu_torch.models import fastsurfer, layers, segment, unet2d, unet3d
from invesalius3_tpu_torch.ops import (connected, filters, floodfill, mesh, morphology,
                                       rasterize, raycast, render_mesh, reslice, resize)
from invesalius3_tpu_torch.parallel import distributed, mesh_utils

torch.set_num_threads(1)

ENTRY_POINTS = {
    "pipeline.run": pipeline.run,
    "Volume.from_numpy": Volume.from_numpy,
    "Mask.__init__": Mask.__init__,
    "Mask.load_plist": Mask.load_plist,
    "convert.to_device": convert.to_device,
    "convert.from_jax_mesh": convert.from_jax_mesh,
    "convert.volume_from_jax": convert.volume_from_jax,
    "convert.mask_from_jax": convert.mask_from_jax,
    "convert.slice_from_jax": convert.slice_from_jax,
    "convert.project_from_jax": convert.project_from_jax,
    "Project.from_matrix": Project.from_matrix,
    "Project.open": Project.open,
    "mesh.vertex_adjacency_fast": mesh.vertex_adjacency_fast,
    "floodfill.seeds_to_mask": floodfill.seeds_to_mask,
    "dicom.group_to_volume": dicom.group_to_volume,
    "dicom.fix_gantry_tilt": dicom.fix_gantry_tilt,
    # entry points whose results are host arrays or files
    "app.main": app.main,
    "app.main[-i]": app.main,
    "Surface.compute_properties": surface.Surface.compute_properties,
    "surface.import_surface_file": surface.import_surface_file,
    "surface.merge_surfaces": surface.merge_surfaces,
    "surface.split_surface": surface.split_surface,
    "surface.surface_from_seeds": surface.surface_from_seeds,
    "surface.smooth_surface": surface.smooth_surface,
    "mesh.find_staircase_artifacts": mesh.find_staircase_artifacts,
    "mesh.propagate_weights": mesh.propagate_weights,
    "mesh.laplacian_smooth": mesh.laplacian_smooth,
    "mesh.ca_smoothing": mesh.ca_smoothing,
    # the 3D viewer's entry points that take host arrays
    "rasterize.polygon2mask": rasterize.polygon2mask,
    "raycast.render": raycast.render,
    "raycast.shear_warp_render": raycast.shear_warp_render,
    "raycast.render_mask_preview": raycast.render_mask_preview,
    "raycast.warm_shear_cache": raycast.warm_shear_cache,
    "render_mesh.render_surfaces": render_mesh.render_surfaces,
    "render_mesh.render_scene": render_mesh.render_scene,
    "render_mesh.remove_non_visible_faces": render_mesh.remove_non_visible_faces,
    # the segmentation models' entry points (host arrays in and out)
    "segment.BrainSegmenter": segment.BrainSegmenter.__init__,
    "segment.ImplantSegmenter": segment.ImplantSegmenter.__init__,
    "segment.SubpartSegmenter": segment.SubpartSegmenter.__init__,
    "fastsurfer.FastSurferPipeline": fastsurfer.FastSurferPipeline.__init__,
    "fastsurfer.conform": fastsurfer.conform,
    "fastsurfer.run_quick_qc": fastsurfer.run_quick_qc,
    "app.run_cranioplasty": app.run_cranioplasty,
    # the shard list (parallel/)
    "mesh_utils.make_mesh": mesh_utils.make_mesh,
    "distributed.global_mesh": distributed.global_mesh,
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _ct():
    r = np.random.default_rng(0)
    return r.integers(-1000, 2000, (6, 7, 8)).astype(np.int16)


def _jax_mask():
    m = MaskJax(shape=(6, 7, 8))
    m.data = jnp.asarray(np.random.default_rng(1).integers(0, 256, (6, 7, 8)),
                         jnp.uint8)
    return m


def _plist():
    m = Mask(shape=(6, 7, 8), device="cpu")
    mat = m.to_bordered_matrix()
    return m.save_plist("mask.dat"), mat.tobytes()


def _jax_mesh():
    mask = np.zeros((10, 10, 10), np.uint8)
    mask[3:7, 3:7, 3:7] = 255
    return marching_jax.mask_to_surface_device(jnp.asarray(mask))


# entry point -> a call of it with the given device keyword (None: default)
CALLS = {
    "pipeline.run": lambda tmp, **kw: pipeline.run(
        pipeline.make_ct(24), pipeline.bench_markers(24), tmp / "out.stl", **kw).labels,
    "mesh_utils.make_mesh": lambda tmp, **kw: mesh_utils.shard_volume(
        _ct(), mesh_utils.make_mesh(2, **kw)).shards[1],
    "distributed.global_mesh": lambda tmp, **kw: mesh_utils.shard_volume(
        _ct(), distributed.global_mesh(**kw)).shards[0],
    "Volume.from_numpy": lambda tmp, **kw: Volume.from_numpy(_ct(), **kw).data,
    "Mask.__init__": lambda tmp, **kw: Mask(shape=(6, 7, 8), **kw).data,
    "Mask.load_plist": lambda tmp, **kw: Mask.load_plist(*_plist(), **kw).data,
    "convert.to_device": lambda tmp, **kw: convert.to_device(_ct(), **kw),
    "convert.from_jax_mesh": lambda tmp, **kw: convert.from_jax_mesh(
        _jax_mesh(), **kw).verts3v,
    "convert.volume_from_jax": lambda tmp, **kw: convert.volume_from_jax(
        VolumeJax.from_numpy(_ct()), **kw).data,
    "convert.mask_from_jax": lambda tmp, **kw: convert.mask_from_jax(
        _jax_mask(), **kw).data,
    "convert.slice_from_jax": lambda tmp, **kw: convert.slice_from_jax(
        SliceJax(VolumeJax.from_numpy(_ct())), **kw).volume.data,
    "convert.project_from_jax": lambda tmp, **kw: convert.project_from_jax(
        ProjectJax.from_matrix("p", _ct()), **kw).volume.data,
    "Project.from_matrix": lambda tmp, **kw: Project.from_matrix("p", _ct(), **kw).volume.data,
    "Project.open": lambda tmp, **kw: Project.open(_inv3(tmp), **kw).volume.data,
    "mesh.vertex_adjacency_fast": lambda tmp, **kw: mesh.vertex_adjacency_fast(
        _cube()[1], 8, **kw)[0],
    "floodfill.seeds_to_mask": lambda tmp, **kw: floodfill.seeds_to_mask(
        (6, 7, 8), [(1, 2, 3)], **kw),
    "rasterize.polygon2mask": lambda tmp, **kw: rasterize.polygon2mask(
        (6, 7), [(1, 1), (5, 1), (3, 6)], **kw),
    "dicom.group_to_volume": lambda tmp, **kw: dicom.group_to_volume(
        dicom.load_dicom_dir(_series(tmp))[0], **kw)[0],
    "dicom.fix_gantry_tilt": lambda tmp, **kw: dicom.fix_gantry_tilt(
        _ct(), (1.0, 1.0, 1.0), 15.0, **kw),
}


def _series(tmp, tilt=0.0):
    """_ct() as a DICOM series (gantry-tilted when ``tilt``)."""
    d = tmp / "series"
    d.mkdir(exist_ok=True)
    for z, sl in enumerate(_ct()):
        dicom.write_dicom(d / f"s{z}.dcm", sl, {
            "SeriesInstanceUID": "1.2.3", "ImagePositionPatient": [0.0, 0.0, float(z)],
            "ImageOrientationPatient": [1, 0, 0, 0, 1, 0], "GantryDetectorTilt": tilt})
    return d


def _cube():
    v = np.array([[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], np.float32)
    f = np.array([[0, 2, 1], [1, 2, 3], [4, 5, 6], [5, 7, 6], [0, 1, 4], [1, 5, 4],
                  [2, 6, 3], [3, 6, 7], [0, 4, 2], [2, 4, 6], [1, 3, 5], [3, 7, 5]],
                 np.int32)
    return v, f


def _surface():
    return surface.Surface(*_cube(), index=0)


def _inv3(tmp):
    ProjectJax.from_matrix("p", _ct()).save(tmp / "p.inv3")
    return tmp / "p.inv3"


def _stl(tmp):
    from invesalius3_tpu_torch.io import mesh_io

    mesh_io.write_stl(tmp / "c.stl", *_cube())
    return tmp / "c.stl"


def _app(tmp, **kw):
    from invesalius3_tpu.io import nifti

    nifti.write_nifti(tmp / "ct.nii", _ct())
    return app.main(["--import-file", str(tmp / "ct.nii"), "-t", "Bone",
                     "-e", str(tmp / "o.stl")], **kw)


def _gen():
    return torch.Generator().manual_seed(0)


def _cranioplasty(tmp, **kw):
    from invesalius3_tpu.io import nifti

    nifti.write_nifti(tmp / "ct.nii", _ct())
    d = tmp / "invesalius3_tpu_torch" / "ai" / "cranioplasty_jit_ct_binary"
    d.mkdir(parents=True, exist_ok=True)
    torch.save(layers.init_state(unet2d.Unet2D(), _gen()), d / "cranioplasty_jit_ct_binary.pt")
    return app.run_cranioplasty(tmp / "ct.nii", tmp / "implant.stl", **kw)


# entry points with host results: a call with the given device keyword
HOST_CALLS = {
    "segment.BrainSegmenter": lambda tmp, **kw: segment.BrainSegmenter(
        unet3d.init_params(_gen(), init_features=2), unet3d.Unet3D(init_features=2),
        patch_size=16, **kw).segment(_ct()),
    "segment.ImplantSegmenter": lambda tmp, **kw: segment.ImplantSegmenter(
        layers.init_state(unet2d.Unet2D(features=2), _gen()), unet2d.Unet2D(features=2), patch_size=8,
        **kw).segment(_ct()),
    "segment.SubpartSegmenter": lambda tmp, **kw: segment.SubpartSegmenter(
        {}, filters=2, conform_size=16, **kw).segment(_ct()),
    "fastsurfer.FastSurferPipeline": lambda tmp, **kw: fastsurfer.FastSurferPipeline(
        filters=2, **kw).run(_ct(), conform_size=16),
    "fastsurfer.conform": lambda tmp, **kw: fastsurfer.conform(_ct(), 6, **kw),
    "fastsurfer.run_quick_qc": lambda tmp, **kw: fastsurfer.run_quick_qc(
        np.where(_ct() > 0, 4, 0), 1.0, **kw),
    "app.run_cranioplasty": _cranioplasty,
    "app.main": _app,
    "app.main[-i]": lambda tmp, **kw: app.main(
        ["-i", str(_series(tmp, tilt=10.0)), "-t", "Bone", "-e", str(tmp / "o.stl")], **kw),
    "Surface.compute_properties": lambda tmp, **kw: _surface().compute_properties(**kw),
    "surface.import_surface_file": lambda tmp, **kw: surface.import_surface_file(
        _stl(tmp), **kw),
    "surface.merge_surfaces": lambda tmp, **kw: surface.merge_surfaces(
        [_surface(), _surface()], **kw),
    "surface.split_surface": lambda tmp, **kw: surface.split_surface(_surface(), **kw),
    "surface.surface_from_seeds": lambda tmp, **kw: surface.surface_from_seeds(
        _surface(), [0], False, **kw),
    "surface.smooth_surface": lambda tmp, **kw: surface.smooth_surface(_surface(), **kw),
    "mesh.find_staircase_artifacts": lambda tmp, **kw: mesh.find_staircase_artifacts(
        *_cube(), np.ones((12, 3), np.float32), **kw),
    "mesh.propagate_weights": lambda tmp, **kw: mesh.propagate_weights(
        _cube()[0], *mesh.vertex_adjacency(_cube()[1], 8), np.ones(8, bool), 3.0, 0.5,
        **kw),
    "mesh.laplacian_smooth": lambda tmp, **kw: mesh.laplacian_smooth(*_cube(), **kw),
    "mesh.ca_smoothing": lambda tmp, **kw: mesh.ca_smoothing(*_cube(), **kw),
    "raycast.render": lambda tmp, **kw: raycast.render(_ct(), image_size=8, n_steps=8, **kw),
    "raycast.shear_warp_render": lambda tmp, **kw: raycast.shear_warp_render(
        _ct(), image_size=8, **kw),
    "raycast.render_mask_preview": lambda tmp, **kw: raycast.render_mask_preview(
        (_ct() > 200).astype(np.uint8) * 255, image_size=8, **kw),
    "raycast.warm_shear_cache": lambda tmp, **kw: raycast.warm_shear_cache(_ct(), **kw),
    "render_mesh.render_surfaces": lambda tmp, **kw: render_mesh.render_surfaces(
        [(*_cube(), (1.0, 0.5, 0.2))], size=16, **kw),
    "render_mesh.render_scene": lambda tmp, **kw: render_mesh.render_scene(
        [_surface()], markers=[(0.5, 0.5, 0.5)], size=16, **kw),
    "render_mesh.remove_non_visible_faces": lambda tmp, **kw:
        render_mesh.remove_non_visible_faces(*_cube(), size=16, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    default = inspect.signature(ENTRY_POINTS[name]).parameters["device"].default
    assert default == device.DEFAULT_DEVICE == "cuda"


@pytest.mark.parametrize("name", sorted(CALLS))
def test_without_a_card_the_default_raises(name, no_card, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CALLS[name](tmp_path)


@pytest.mark.parametrize("name", sorted(CALLS))
def test_cpu_only_when_asked(name, no_card, tmp_path):
    out = CALLS[name](tmp_path, device="cpu")
    assert out.device.type == "cpu"


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device.resolve_device() == torch.device("cuda")
    assert device.resolve_device("cuda:0") == torch.device("cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device("cuda:0")


def test_mask_without_shape_makes_no_tensor(no_card):
    assert Mask().data is None  # no tensor, so no device to reach


@pytest.mark.parametrize("name", sorted(HOST_CALLS))
def test_host_entry_points_raise_without_a_card(name, no_card, tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HOST_CALLS[name](tmp_path)
    HOST_CALLS[name](tmp_path, device="cpu")


def test_every_entry_point_is_called():
    assert sorted(ENTRY_POINTS) == sorted([*CALLS, *HOST_CALLS])


# the mask-editing tools take their device from the tensors they are given;
# run under a "meta" default device, any tensor they made without naming
# the inputs' device would land there and fail the call
def _edit_inputs():
    ct = torch.from_numpy(_ct())
    m = torch.from_numpy((_ct() > 200).astype(np.uint8) * 255)
    return ct, m


BRUSH = morphology.brush_element(1.0, (1.0, 1.0, 1.0))
EDIT_OPS = {
    "binary_dilation": lambda ct, m: morphology.binary_dilation(m, morphology.structure_3d(6)),
    "binary_erosion": lambda ct, m: morphology.binary_erosion(m, morphology.structure_3d(18)),
    "paint_brush": lambda ct, m: morphology.paint_brush(m, BRUSH, (2, 3, 4), 254),
    "paint_brush_trajectory": lambda ct, m: morphology.paint_brush_trajectory(
        m, BRUSH, [(0, 0, 0), (5, 6, 7)], 254, BRUSH.shape),
    "paint_brush_trajectory_threshold": lambda ct, m: morphology.paint_brush_trajectory_threshold(
        m, ct, BRUSH, [(3, 3, 3)], 0, 900, BRUSH.shape, "thresh"),
    "floodfill_threshold": lambda ct, m: floodfill.floodfill_threshold(
        ct, m > 0, 200, 2000),
    "floodfill_auto_threshold": lambda ct, m: floodfill.floodfill_auto_threshold(
        ct, m > 0, 0.3),
    "region_grow_dynamic": lambda ct, m: floodfill.region_grow_dynamic(
        ct, (3, 3, 3), 500.0, 500.0, True),
    "region_grow_confidence": lambda ct, m: floodfill.region_grow_confidence(ct, (3, 3, 3)),
    "apply_fill": lambda ct, m: floodfill.apply_fill(m, m > 0, 254),
    "label": lambda ct, m: connected.label(m, 26),
    "component_sizes": lambda ct, m: connected.component_sizes(connected.label(m)),
    "largest_component": lambda ct, m: connected.largest_component(m),
    "fill_holes_automatically": lambda ct, m: connected.fill_holes_automatically(m, 5),
    "select_part": lambda ct, m: connected.select_part(m, (0, 0, 0)),
    "gaussian": lambda ct, m: filters.gaussian(ct, 1.0, batch_dims=1),
    "mean": lambda ct, m: filters.mean(ct, 3),
    "median": lambda ct, m: filters.median(ct, 3),
    "sharpen": lambda ct, m: filters.sharpen(ct, 1.0, batch_dims=1),
    "border_detection": lambda ct, m: filters.border_detection(ct),
    "convolve_non_zero": lambda ct, m: filters.convolve_non_zero(
        m.float(), np.ones((3, 3, 3), np.float32), 1.0),
}


_EYE = np.eye(4, dtype=np.float32)
_PTS = torch.tensor([0.5, 2.0, 4.2])
_POLY = torch.tensor([[1.0, 1.0], [5.0, 1.0], [3.0, 6.0]])
_SCREEN = torch.ones(9, 9, dtype=torch.bool)
_CORNERS = [torch.rand(3, 5, generator=torch.Generator().manual_seed(i)) * 8 for i in range(3)]
_COLOURS = torch.rand(4, 5, generator=torch.Generator().manual_seed(3))
EDIT_OPS.update({  # the 3D viewer's tensor ops
    **{f"apply_view_matrix_transform[{k}]":
       (lambda ct, m, k=k: reslice.apply_view_matrix_transform(
           ct, (1.0, 1.0, 1.0), _EYE, 1, "CORONAL", k, -5.0, (4, 5, 6))) for k in range(4)},
    "sample_volume": lambda ct, m: reslice.sample_volume(ct, _PTS, _PTS, _PTS, 2, 0.0),
    "trilinear": lambda ct, m: reslice.trilinear(ct, _PTS, _PTS, _PTS),
    "lanczos": lambda ct, m: reslice.lanczos(ct, _PTS, _PTS, _PTS),
    "resize_volume[0]": lambda ct, m: resize.resize_volume(ct, (3, 9, 4), 0),
    "resize_volume[1]": lambda ct, m: resize.resize_volume(ct, (3, 9, 4), 1),
    "resize_by_spacing_scale": lambda ct, m: resize.resize_by_spacing_scale(ct, 2),
    "raycast": lambda ct, m: raycast.raycast(
        ct, np.full((4, 4, 3), 2.0, np.float32), np.float32([0.5, 0.5, 0.1]), 4.0,
        raycast.builtin_preset("Bone").rgba, -200.0, 2000.0, n_steps=4, use_shading=True,
        crop_plane=[1.0, 0.0, 0.0, -1.0]),
    "shear_warp_render": lambda ct, m: raycast.shear_warp_render(
        ct, image_size=8, fetch=False),
    "shear_warp_render[mip, ds2]": lambda ct, m: raycast.shear_warp_render(
        ct, preset=raycast.builtin_preset("MIP"), image_size=8, downsample=2, fetch=False),
    "_pool2": lambda ct, m: raycast._pool2(ct, "mip"),
    "polygon2mask": lambda ct, m: rasterize.polygon2mask((6, 7), _POLY),
    "mask_cut": lambda ct, m: rasterize.mask_cut(
        m, (1.0, 1.0, 1.0), 100.0, _SCREEN, np.eye(4) * 0.1, np.eye(4), 0),
    "_splat": lambda ct, m: render_mesh._splat(*_CORNERS, _COLOURS[0], _COLOURS, 8,
                                               ssao=True),
})


_LOGITS = torch.rand(2, 3, 4, len(fastsurfer.get_labels_from_lut()[1]))
_ORIGINS = torch.tensor([[0, 1, 2], [2, 3, 4]])
EDIT_OPS.update({  # the segmentation models' tensor ops
    "image_normalize": lambda ct, m: segment.image_normalize(ct),
    "gather_patches": lambda ct, m: segment.gather_patches(ct, _ORIGINS, 4),
    "thick_slices": lambda ct, m: fastsurfer.thick_slices(ct, 1),
    "conform_tensor": lambda ct, m: fastsurfer.conform_tensor(ct, 5),
    "max_pool_with_indices": lambda ct, m: fastsurfer.max_pool_with_indices(
        ct[None, :, :6, :8].float())[1],
    "max_unpool": lambda ct, m: fastsurfer.max_unpool(
        *fastsurfer.max_pool_with_indices(ct[None, :, :6, :8].float())),
    "apply_sagittal_mapping": lambda ct, m: fastsurfer.apply_sagittal_mapping(_LOGITS),
})


@pytest.mark.parametrize("name", sorted(EDIT_OPS))
def test_mask_editing_ops_stay_on_the_inputs_device(name, no_card):
    ct, m = _edit_inputs()
    with torch.device("meta"):
        out = EDIT_OPS[name](ct, m)
    assert out.device.type == "cpu"


def test_mask_editing_host_results_come_from_the_inputs_device(no_card):
    ct, m = _edit_inputs()
    with torch.device("meta"):
        labels, n = connected.count_regions(m)
        slc = convert.slice_from_jax(SliceJax(VolumeJax.from_numpy(_ct())), device="cpu")
        mask = slc.create_new_mask()
        mask.fill_holes_auto(5)
        area = slc.calc_mask_area()
        slc.apply_image_filter(0, 1.0, "2D", "CORONAL")
    assert isinstance(labels, np.ndarray) and n > 0 and area > 0
    assert mask.data.device.type == slc.matrix.device.type == "cpu"

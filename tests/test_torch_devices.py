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
from invesalius3_tpu_torch.ops import mesh

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
    # entry points whose results are host arrays or files
    "app.main": app.main,
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
}


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


# entry points with host results: a call with the given device keyword
HOST_CALLS = {
    "app.main": _app,
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

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
from invesalius3_tpu_torch import convert, device, pipeline
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.core.volume import Volume

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

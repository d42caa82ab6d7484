"""The port's patch-grid segmenters (models/segment.py) and the app's
--cranioplasty against the JAX package's, on the CPU, with the Flax
variables carried across by ``convert.*_from_jax``: the patch grid, the
normalisation, the patch gather and the scatter's overwrite order, the pad
path, ``SegmentJob``, the weight resolution and its errors, every
segmenter at small patches and widths, ``structure_masks``.

No test touches the network: every models dir is a temporary one, and
``download_url_to_file`` raises ``OSError`` in both packages.

Tolerances:
- ``patch_grid``, ``image_normalize``, the gather, the scatter,
  ``structure_masks``, progress values, error texts: equal;
- bfloat16 segmenters: probabilities within atol 2e-2 (measured at most
  7.4e-3); masks equal except where either probability lies within 2e-2
  of the threshold;
- --cranioplasty: the implant network's weights
  (``chip_smoke.majority_implant_state``) make its mask a 3x3 majority vote
  of the bone mask, exact in bfloat16 on both sides, so the STL files are
  equal byte for byte.
"""

import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invesalius3_tpu import app as app_jax
from invesalius3_tpu.core.mask import Mask as MaskJax
from invesalius3_tpu.core import surface as surface_jax
from invesalius3_tpu.io import nifti as nifti_jax
from invesalius3_tpu.models import segment as seg_jax
from invesalius3_tpu.models import unet2d as u2_jax
from invesalius3_tpu.models import unet3d as u3_jax
from invesalius3_tpu.net import download as download_jax
from invesalius3_tpu_torch import app, convert
from invesalius3_tpu_torch.core import surface
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.models import segment, unet2d, unet3d
from invesalius3_tpu_torch.net import download
from chip_smoke import majority_implant_state
from tests.test_torch_unet import jax_variables

torch.set_num_threads(2)
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def offline(monkeypatch, tmp_path):
    """Temporary user dirs (models dirs included) and no download."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))

    def refuse(url, *a, **kw):
        raise OSError(f"no network in the tests ({url})")

    monkeypatch.setattr(download, "download_url_to_file", refuse)
    monkeypatch.setattr(download_jax, "download_url_to_file", refuse)


# ---------------------------------------------------------------------------
# the grid, the normalisation, the gather and the scatter
# ---------------------------------------------------------------------------

SHAPES = [(100, 100, 100), (48, 48, 48), (130, 70, 55), (20, 50, 47), (10, 10, 10)]
OVERLAPS = [0.5, 50, 0.25, 25, 0, 0.75]


@pytest.mark.parametrize("overlap", OVERLAPS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_patch_grid_matches_jax(shape, overlap):
    for p in (16, 48):
        assert segment.patch_grid(shape, p, overlap) == seg_jax.patch_grid(shape, p, overlap)


@pytest.mark.parametrize("kind", ["int16", "float32", "constant", "range"])
def test_image_normalize_matches_jax(kind):
    rng = np.random.default_rng(1)
    img = {"int16": rng.integers(-1000, 3000, (9, 10, 11)).astype(np.int16),
           "float32": rng.normal(3.0, 7.0, (9, 10, 11)).astype(np.float32),
           "constant": np.full((4, 5, 6), 7, np.int16),
           "range": rng.random((6, 7, 8)).astype(np.float32)}[kind]
    args = (-1.0, 3.5) if kind == "range" else ()
    got = segment.image_normalize(torch.from_numpy(img), *args).numpy()
    want = np.asarray(seg_jax.image_normalize(img, *args))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_gather_matches_jax():
    img = np.random.default_rng(2).random((30, 21, 26)).astype(np.float32)
    origins = seg_jax.patch_grid(img.shape, 16, 0.5)
    want = np.asarray(seg_jax._gather_patches(jnp.asarray(img), jnp.asarray(origins), 16))
    got = segment.gather_patches(torch.from_numpy(img), torch.tensor(origins), 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_keeps_the_jax_overwrite_order():
    """Every patch a different value: each voxel must end with the last
    patch in grid order that covers it, as the JAX scan leaves it."""
    shape, p = (30, 21, 26), 16
    origins = seg_jax.patch_grid(shape, p, 0.5)
    probs = np.random.default_rng(3).random((len(origins), p, p, p)).astype(np.float32)
    want = np.asarray(seg_jax._scatter_patches(jnp.asarray(probs), jnp.asarray(origins),
                                               p, shape))
    got = torch.zeros(shape)
    for i in range(0, len(origins), 5):  # batch by batch, as the segmenter writes
        segment.scatter_patches(got, torch.from_numpy(probs[i:i + 5]), origins[i:i + 5])
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the segmenters against the JAX package's
# ---------------------------------------------------------------------------

def _close(port_run, jax_run, atol=2e-2):
    """Probabilities within ``atol``; masks equal away from the threshold.
    The threshold is the median of the JAX probabilities (random weights put
    them anywhere), and the JAX mask at it is the JAX segmenter's own rule
    (``prob >= t``)."""
    pj, mj = jax_run(0.5)
    t = float(np.median(pj))
    mj = np.where(pj >= t, 255, 0).astype(np.uint8)
    p, m = port_run(t)
    assert p.dtype == pj.dtype == np.float32 and m.dtype == mj.dtype == np.uint8
    assert p.shape == pj.shape == m.shape == mj.shape
    np.testing.assert_allclose(p, pj, atol=atol, rtol=0)
    np.testing.assert_array_equal(m, np.where(p >= t, 255, 0))
    far = (np.abs(p - t) > atol) & (np.abs(pj - t) > atol)
    np.testing.assert_array_equal(m[far], mj[far])
    assert far.mean() > 0.5, far.mean()  # the masks are compared on most voxels


def _brain_pair(cls=segment.BrainSegmenter, cls_jax=seg_jax.BrainSegmenter, f=4,
                patch=16, seed=20, gain=4.0, **kw):
    variables, _ = jax_variables("unet3d", seed, gain, init_features=f)
    port = cls(variables=convert.unet3d_from_jax(variables), patch_size=patch,
               model=unet3d.Unet3D(init_features=f, dtype=torch.bfloat16), **kw, **CPU)
    ref = cls_jax(variables=variables, patch_size=patch,
                  model=u3_jax.Unet3D(init_features=f, dtype=jnp.bfloat16), **kw)
    return port, ref


def _mri(shape, seed=21):
    """A smooth int16 volume: a bright ellipsoid over noise."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, s) for s in shape), indexing="ij")
    body = (zz ** 2 + (yy / 0.8) ** 2 + (xx / 0.9) ** 2 < 0.6) * 600.0
    return (body + rng.normal(200, 60, shape)).astype(np.int16)


@pytest.mark.parametrize("shape", [(24, 20, 28), (10, 20, 12)], ids=["grid", "padded"])
def test_brain_segmenter_matches_jax(shape):
    """(10, 20, 12) is smaller than the 16^3 patch along z and x: padded,
    then cropped back."""
    port, ref = _brain_pair()
    img = _mri(shape)
    _close(lambda t: port.segment(img, t, batch_size=3),
           lambda t: ref.segment(img, t, batch_size=4))


def test_batch_size_does_not_change_the_result():
    port, _ = _brain_pair()
    img = _mri((24, 20, 28))
    a = port.segment(img, batch_size=1)
    b = port.segment(img, batch_size=12)
    np.testing.assert_array_equal(a[0], b[0])


def test_trachea_and_mandible_segmenters_match_jax():
    ct = np.random.default_rng(22).integers(-1000, 2000, (20, 24, 18)).astype(np.int16)
    ct[5:15, 8:16, 6:12] = -1000  # an air column, as a trachea
    # head gains that spread these networks' probabilities over (0, 1)
    port, ref = _brain_pair(segment.TracheaSegmenter, seg_jax.TracheaSegmenter, gain=16.0)
    assert port.use_ww_wl and (port.ww, port.wl) == (2000.0, -500.0)
    _close(lambda t: port.segment(ct, t, batch_size=4),
           lambda t: ref.segment(ct, t, batch_size=4))
    port, ref = _brain_pair(segment.MandibleSegmenter, seg_jax.MandibleSegmenter,
                            patch=32, seed=23, gain=8.0)
    _close(lambda t: port.segment(ct, t, batch_size=2),
           lambda t: ref.segment(ct, t, batch_size=2))


@pytest.mark.parametrize("method", ["binary", "gray"])
def test_implant_segmenter_matches_jax(method):
    variables, _ = jax_variables("unet2d", 24, features=4)
    port = segment.ImplantSegmenter(variables=convert.unet2d_from_jax(variables),
                                    model=unet2d.Unet2D(features=4), method=method,
                                    patch_size=32, **CPU)
    ref = seg_jax.ImplantSegmenter(variables=variables, model=u2_jax.Unet2D(features=4),
                                   method=method, patch_size=32)
    ct = np.random.default_rng(25).integers(-1000, 2000, (3, 40, 36)).astype(np.int16)
    ct[:, 10:30, 12:20] = 1500
    got_progress, want_progress = [], []
    _close(lambda t: port.segment(ct, t, batch_size=3, progress_cb=got_progress.append),
           lambda t: ref.segment(ct, t, progress_cb=want_progress.append))
    assert got_progress[-1] == want_progress[-1] == 1.0
    small = ct[:2, :20, :25]  # padded to the patch in y and x, cropped back
    _close(lambda t: port.segment(small, t), lambda t: ref.segment(small, t))


def test_progress_values_match_jax():
    port, ref = _brain_pair()
    img = _mri((24, 20, 28))
    got, want = [], []
    port.segment(img, batch_size=5, progress_cb=got.append)
    ref.segment(img, batch_size=5, progress_cb=want.append)
    assert got == want and got[-1] == 1.0


# ---------------------------------------------------------------------------
# SegmentJob, weights
# ---------------------------------------------------------------------------

def test_segment_job_progress_cancel_and_error():
    port, _ = _brain_pair()
    img = _mri((24, 20, 28))
    job = segment.SegmentJob(port, img, batch_size=4)
    job.start()
    job.join()
    assert job.exception is None and job.progress == 1.0
    np.testing.assert_array_equal(job.probability, port.segment(img, batch_size=4)[0])

    seen = []
    job = segment.SegmentJob(port, img, batch_size=4)
    orig = job._on_progress

    def stop_after_first(value):
        seen.append(value)
        job.stop()
        orig(value)

    job._on_progress = stop_after_first
    job.start()
    job.join()
    assert seen == [4 / 12] and job.probability is None and job.exception is None

    job = segment.SegmentJob(port, np.zeros((4, 4), np.int16))  # not a volume
    job.start()
    job.join()
    assert isinstance(job.exception, Exception) and job.probability is None
    assert isinstance(job, threading.Thread) and job.daemon


def _same_message(e_port, e_jax):
    norm = [str(e).replace("invesalius3_tpu_torch", "PKG").replace("invesalius3_tpu", "PKG")
            for e in (e_port, e_jax)]
    assert norm[0] == norm[1]


def test_missing_weights_raise_or_warn_as_in_jax():
    for cls, cls_jax in ((segment.BrainSegmenter, seg_jax.BrainSegmenter),
                         (segment.ImplantSegmenter, seg_jax.ImplantSegmenter),
                         (segment.SubpartSegmenter, seg_jax.SubpartSegmenter)):
        with pytest.raises(segment.WeightsUnavailableError) as e:
            cls(**CPU)
        with pytest.raises(seg_jax.WeightsUnavailableError) as ej:
            cls_jax()
        if cls is not segment.SubpartSegmenter:  # the JAX registry lacks FastSurfer
            _same_message(e.value, ej.value)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        seg = segment.BrainSegmenter(allow_random_init=True, **CPU)
    assert any("RANDOM weights" in str(x.message) and x.category is RuntimeWarning
               for x in w)
    want = unet3d.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(seg.variables[k], want[k]) for k in want)


def test_a_checkpoint_under_the_models_dir_is_used(tmp_path):
    variables, module = jax_variables("unet3d", 26, init_features=8)
    state = convert.unet3d_from_jax(variables)
    path = download.get_weight_file.__globals__["models_dir"]() / "brain_mri_t1"
    path.mkdir(parents=True)
    torch.save(state, path / "brain_mri_t1.pt")
    seg = segment.BrainSegmenter(**CPU)  # no random init: the file is read
    assert sorted(seg.variables) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(seg.variables[k], state[k].numpy())
    with pytest.raises(FileNotFoundError):  # no URL: never a download
        download.get_weight_file("fastsurfer_axial")


def test_structure_masks_match_jax():
    rng = np.random.default_rng(27)
    lm = rng.choice([0, 4, 8, 10, 16, 43, 1002, 2024], size=(8, 9, 10)).astype(np.int32)
    for cats in (["ventricles"], ["cortical"], ["subcortical", "cerebellum"],
                 ["non_cortical"], ["brain_stem"], ["White Matter"]):
        got, want = segment.structure_masks(lm, cats), seg_jax.structure_masks(lm, cats)
        assert [(n, i) for n, _, i in got] == [(n, i) for n, _, i in want]
        for (_, m, _), (_, mj, _) in zip(got, want):
            np.testing.assert_array_equal(m, mj)
    assert set(segment.SEGMENTERS) == set(seg_jax.SEGMENTERS)


# ---------------------------------------------------------------------------
# app --cranioplasty
# ---------------------------------------------------------------------------

def _implant_ct():
    rng = np.random.default_rng(28)
    zz, yy, xx = np.mgrid[:4, :40, :44]
    r = np.sqrt((yy - 20.0) ** 2 + (xx - 22.0) ** 2)
    ct = np.where((r > 12) & (r < 17) & (xx < 34), 1200, -1000).astype(np.int16)
    flip = rng.random(ct.shape) < 0.08  # speckle the majority vote removes
    return np.where(flip, np.where(ct > 0, -1000, 1200), ct).astype(np.int16)


def _checkpoints(tmp_path):
    state = majority_implant_state()
    for pkg in ("invesalius3_tpu", "invesalius3_tpu_torch"):
        d = tmp_path / "config" / pkg / "ai" / "cranioplasty_jit_ct_binary"
        d.mkdir(parents=True)
        module = unet2d.Unet2D().eval()
        module.load_state_dict(state)
        torch.jit.save(torch.jit.trace(module, torch.zeros(1, 1, 32, 32)),
                       str(d / "cranioplasty_jit_ct_binary.pt"))


def test_cranioplasty_app_matches_jax(tmp_path, monkeypatch):
    nifti_jax.write_nifti(tmp_path / "ct.nii", _implant_ct(), spacing=(0.5, 0.6, 0.7))
    _checkpoints(tmp_path)
    stl = {}
    for name, main in (("port", lambda a: app.main(a, **CPU)), ("jax", app_jax.main)):
        monkeypatch.setattr(Mask, "general_index", -1)
        monkeypatch.setattr(MaskJax, "general_index", -1)
        monkeypatch.setattr(surface.Surface, "_counter", [-1])
        monkeypatch.setattr(surface_jax.Surface, "_counter", [-1])
        out = tmp_path / f"{name}.stl"
        assert main(["--cranioplasty", str(tmp_path / "ct.nii"), str(out)]) == 0
        stl[name] = out.read_bytes()
    n_tris = int.from_bytes(stl["port"][80:84], "little")
    assert n_tris == int.from_bytes(stl["jax"][80:84], "little") > 100
    assert stl["port"] == stl["jax"]


def test_cranioplasty_mask_is_the_majority_vote(tmp_path):
    """The implant segmenter under those weights: the 3x3 majority vote of
    the bone mask, slice by slice, zero-padded at the borders."""
    ct = _implant_ct()
    seg = segment.ImplantSegmenter(variables=majority_implant_state(), **CPU)
    prob, mask = seg.segment(ct)
    bone = np.pad(ct >= 300, ((0, 0), (1, 1), (1, 1)))
    votes = sum(bone[:, dy:dy + ct.shape[1], dx:dx + ct.shape[2]]
                for dy in range(3) for dx in range(3))
    np.testing.assert_array_equal(mask, np.where(votes >= 5, 255, 0))
    assert np.abs(prob - 0.5).min() > 0.06


def test_cranioplasty_without_weights_raises(tmp_path):
    nifti_jax.write_nifti(tmp_path / "ct.nii", _implant_ct())
    argv = ["--cranioplasty", str(tmp_path / "ct.nii"), str(tmp_path / "o.stl")]
    with pytest.raises(segment.WeightsUnavailableError):
        app.main(argv, **CPU)
    with pytest.raises(seg_jax.WeightsUnavailableError):
        app_jax.main(argv)
    assert not (tmp_path / "o.stl").exists()

"""The port's FastSurfer parcellation (models/fastsurfer.py) and
``SubpartSegmenter`` against the JAX package's, on the CPU, with per-view
Flax variables carried across by ``convert.fastsurfer_from_jax``: the label
table, the sagittal mapping, LUT.tsv, ``conform``, ``thick_slices``, the
three-view pipeline's labels, the quick QC and ``structure_masks``.

The JAX pipeline is run eagerly (``jax.disable_jit``), as
tests/test_fastsurfer.py applies the Flax model: jitted on the CPU, XLA
keeps convolution outputs in float32 where the Flax model rounds them to
bfloat16 (``--xla_allow_excess_precision``, on by default), and on these
random networks, whose logits reach about 1600, the jitted sum moves by up
to 1240 from the eager one (8.7 with the flag off).  The port rounds where
the model does.

Tolerances:
- label ids, the mapping, LUT.tsv bytes, ``thick_slices``, the QC report,
  ``structure_masks``: equal;
- ``conform``: within 1e-4 of 255 (the trilinear resample's float32
  sums; measured 3e-5);
- aggregated logits: within 0.5% of their largest magnitude (measured
  0.28%); labels equal wherever the JAX sum's top two logits differ by more
  than 0.2% of its largest magnitude (measured: none of the 4096 labels
  differs).
"""

import jax
import numpy as np
import pytest
import torch

from invesalius3_tpu.models import fastsurfer as fs_jax
from invesalius3_tpu.models import segment as seg_jax
from invesalius3_tpu.ops import resize as resize_jax
from invesalius3_tpu_torch import convert
from invesalius3_tpu_torch.models import fastsurfer, segment
from tests.test_torch_unet import jax_variables

torch.set_num_threads(2)
CPU = {"device": "cpu"}
VIEWS = (("axial", 0), ("coronal", 1), ("sagittal", 2))


def test_label_table_matches_jax():
    assert fastsurfer.LUT_ROWS == fs_jax.LUT_ROWS and fastsurfer.NUM_CLASSES == 79
    np.testing.assert_array_equal(fastsurfer.class_ids(), fs_jax.class_ids())
    for got, want in zip(fastsurfer.get_labels_from_lut(), fs_jax.get_labels_from_lut()):
        np.testing.assert_array_equal(got, want)
    got, want = fastsurfer.infer_sagittal_mapping(), fs_jax.infer_sagittal_mapping()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_sagittal_mapping_matches_jax():
    n_sag = len(fs_jax.get_labels_from_lut()[1])
    logits = np.random.default_rng(1).normal(size=(2, 3, 4, n_sag)).astype(np.float32)
    got = fastsurfer.apply_sagittal_mapping(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(fs_jax.apply_sagittal_mapping(logits)))
    assert got.shape[-1] == 79


def test_lut_tsv_bytes_match_jax(tmp_path):
    fastsurfer.write_lut_tsv(tmp_path / "port.tsv")
    fs_jax.write_lut_tsv(tmp_path / "jax.tsv")
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_thick_slices_match_jax(axis):
    vol = np.random.default_rng(2).normal(size=(5, 6, 9)).astype(np.float32)
    got = fastsurfer.thick_slices(torch.from_numpy(vol), axis)
    want = np.asarray(fs_jax.thick_slices(vol, axis))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("shape,size", [((20, 24, 28), 16), ((9, 11, 7), 12),
                                        ((6, 6, 6), 6)])
def test_conform_matches_jax(shape, size):
    vol = (np.random.default_rng(3).normal(size=shape) * 300 + 500).astype(np.int16)
    got = fastsurfer.conform(vol, size, **CPU)
    want = fs_jax.conform(vol, size)
    assert got.dtype == want.dtype == np.float32 and got.shape == (size,) * 3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got.min() == 0.0 and got.max() == 255.0
    flat = fastsurfer.conform(np.full(shape, 3, np.int16), size, **CPU)
    np.testing.assert_array_equal(flat, fs_jax.conform(np.full(shape, 3, np.int16), size))


def _view_variables(filters=8):
    n_sag = len(fs_jax.get_labels_from_lut()[1])
    return {view: jax_variables("fastsurfer", 30 + i, 4.0, filters=filters,
                                num_classes=n_sag if view == "sagittal" else 79)[0]
            for i, (view, _) in enumerate(VIEWS)}


def _jax_sum(pipe, vol, progress=None):
    """The JAX pipeline's weighted three-view logit sum, eagerly, with its
    ``run``'s progress calls."""
    agg = None
    with jax.disable_jit():
        for vi, (view, axis) in enumerate(VIEWS):
            lg = pipe._run_plane(vol, axis, view, progress=progress, base=vi / 3.0,
                                 span=1.0 / 3.0) * pipe.VIEW_WEIGHTS[view]
            agg = lg if agg is None else agg + lg
    return np.asarray(agg)


def _same_labels(got, want, agg):
    """Labels equal wherever the JAX sum's top two logits differ by more
    than 0.2% of its largest magnitude."""
    top2 = np.sort(agg, -1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2e-3 * np.abs(agg).max()
    assert decided.mean() > 0.8
    np.testing.assert_array_equal(got[decided], want[decided])


def _port_pipeline(variables, batch_size):
    return fastsurfer.FastSurferPipeline(
        variables={v: convert.fastsurfer_from_jax(x) for v, x in variables.items()},
        batch_size=batch_size, filters=8, **CPU)


@pytest.fixture(scope="module")
def pipelines():
    """The views' variables, a conformed 16^3 volume, and the JAX sum of
    it with the progress values of a JAX run at batch size 8."""
    variables = _view_variables()
    ref = fs_jax.FastSurferPipeline(variables=variables, batch_size=8, filters=8)
    vol = fs_jax.conform(np.random.default_rng(4).normal(size=(20, 24, 28))
                         .astype(np.float32), 16)
    progress = []
    return variables, vol, _jax_sum(ref, vol, progress.append), progress


def test_pipeline_sum_and_labels_match_jax(pipelines):
    """The JAX run's labels are ``argmax(sum, -1)`` as int32
    (JAX fastsurfer.py:447); here they come from the eager sum."""
    variables, vol, agg, _ = pipelines
    port = _port_pipeline(variables, 5)
    got = port.aggregate(torch.from_numpy(vol)).numpy()
    assert got.shape == agg.shape == (16, 16, 16, 79)
    np.testing.assert_allclose(got, agg, atol=5e-3 * np.abs(agg).max(), rtol=0)
    labels = port.run(vol, conform_input=False)
    assert labels.dtype == np.int32
    _same_labels(labels, np.argmax(agg, -1).astype(np.int32), agg)
    ids = port.run(vol, conform_input=False, return_freesurfer_ids=True)
    np.testing.assert_array_equal(ids, fs_jax.class_ids()[labels])


def test_pipeline_progress_and_batch_size(pipelines):
    variables, vol, _, want = pipelines
    got = []
    labels = _port_pipeline(variables, 8).run(vol, conform_input=False, progress=got.append)
    assert got == want and got[-1] == 1.0
    np.testing.assert_array_equal(
        _port_pipeline(variables, 16).run(vol, conform_input=False), labels)


def test_random_init_is_seeded():
    vol = np.random.default_rng(5).normal(size=(8, 8, 8)).astype(np.float32)
    a = fastsurfer.FastSurferPipeline(filters=4, **CPU)
    b = fastsurfer.FastSurferPipeline(filters=4, **CPU)
    assert a.models["sagittal"].classifier.out_channels == len(fs_jax.get_labels_from_lut()[1])
    for view, _ in VIEWS:
        assert all(torch.equal(a.variables[view][k], b.variables[view][k])
                   for k in a.variables[view])
    np.testing.assert_array_equal(a.run(vol, conform_size=16), b.run(vol, conform_size=16))
    assert not torch.equal(a.variables["axial"]["enc1.conv1.weight"],
                           a.variables["coronal"]["enc1.conv1.weight"])


def test_subpart_segmenter_matches_jax():
    variables = _view_variables()
    img = np.random.default_rng(6).normal(size=(20, 24, 28)).astype(np.float32)
    port = segment.SubpartSegmenter(
        variables={v: convert.fastsurfer_from_jax(x) for v, x in variables.items()},
        filters=8, conform_size=16, **CPU)
    ref = seg_jax.SubpartSegmenter(variables=variables, filters=8, conform_size=16)
    progress = []
    labels, mask = port.segment(img, batch_size=4, progress_cb=progress.append)
    with jax.disable_jit():
        want, want_mask = ref.segment(img, batch_size=16)
    assert labels.shape == img.shape and labels.dtype == want.dtype == np.int32
    assert mask.dtype == np.uint8 and progress[-1] == 1.0
    np.testing.assert_array_equal(mask, np.where(labels > 0, 255, 0))
    # the JAX sum on the conformed grid, taken to the image grid as the
    # labels are (nearest, order 0)
    pipe = fs_jax.FastSurferPipeline(variables=variables, batch_size=16, filters=8)
    agg = _jax_sum(pipe, fs_jax.conform(img, 16))
    ids = fs_jax.class_ids()
    top2 = np.sort(agg, -1)[..., -2:]
    gap = np.asarray(resize_jax.resize_volume(top2[..., 1] - top2[..., 0], img.shape, order=0))
    decided = gap > 2e-3 * np.abs(agg).max()
    assert decided.mean() > 0.8 and set(np.unique(labels)) <= set(ids.tolist())
    np.testing.assert_array_equal(labels[decided], want[decided])
    for cats in (["cortical"], ["subcortical", "ventricles"], ["non_cortical"]):
        got_s, want_s = (segment.structure_masks(labels, cats),
                         seg_jax.structure_masks(labels, cats))
        assert [(n, i) for n, _, i in got_s] == [(n, i) for n, _, i in want_s]


def _qc_cases():
    seg = np.zeros((40, 40, 40), np.int32)
    seg[5:35, 5:35, 5:35] = 2
    seg[15:25, 15:25, 15:25] = 4
    seg2 = np.zeros((40, 40, 40), np.int32)
    seg2[10:14, 10:14, 10:14] = 43
    rng = np.random.default_rng(7)
    seg3 = rng.choice([0, 0, 2, 4, 31, 43, 63, 1002], size=(20, 22, 24)).astype(np.int32)
    return [(seg, 64.0), (seg2, 1.0), (seg3, 0.9)]


@pytest.mark.parametrize("case", range(3))
def test_quick_qc_matches_jax(case):
    seg, voxvol = _qc_cases()[case]
    assert fastsurfer.run_quick_qc(seg, voxvol, **CPU) == fs_jax.run_quick_qc(seg, voxvol)
    assert fastsurfer.run_quick_qc(seg, voxvol, 0.01, **CPU) == \
        fs_jax.run_quick_qc(seg, voxvol, 0.01)


def test_checkpoint_loaders_read_the_view_weights(tmp_path):
    from invesalius3_tpu.models import onnx_convert as onnx_jax

    variables = _view_variables(4)["sagittal"]
    state = convert.fastsurfer_from_jax(variables)
    onnx_jax.write_onnx(tmp_path / "s.onnx", {k: v.numpy() for k, v in state.items()})
    torch.save(state, tmp_path / "s.pt")
    for got in (fastsurfer.load_onnx_checkpoint(tmp_path / "s.onnx"),
                fastsurfer.load_torch_checkpoint(tmp_path / "s.pt")):
        assert sorted(got) == sorted(state)
        for k in state:
            np.testing.assert_array_equal(got[k], state[k].numpy())

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

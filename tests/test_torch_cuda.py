"""The port's CUDA kernel on the card, held against its plain version.

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they run where the card is:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from invesalius3_tpu_torch import pipeline
from invesalius3_tpu_torch.ops import kernels, marching, watershed

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(11, 21, 130), (64, 64, 64), (1, 1, 9)])
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
    assert kernels.LAUNCHES[axis] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sweep_kernel_rejects_non_contiguous(cuda):
    rank, lab, f = (torch.from_numpy(a).to(cuda) for a in
                    kernels.sweep_case((8, 9, 10), np.int32, seed=0))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.watershed_sweep(rank.transpose(0, 2), lab.transpose(0, 2),
                                f.transpose(0, 2), 0)


@pytest.mark.parametrize("levels", [0, 2])
def test_small_slice_kernel_equals_plain(cuda, levels, tmp_path):
    n = 48
    ct, markers = pipeline.make_ct(n), pipeline.bench_markers(n)
    ct_d, m_d = torch.from_numpy(ct).to(cuda), torch.from_numpy(markers).to(cuda)
    got = watershed.watershed(ct_d, m_d, multigrid_levels=levels)
    want = watershed.watershed(ct_d, m_d, multigrid_levels=levels,
                               sweep=kernels.watershed_sweep_ref)
    assert torch.equal(got, want)
    mask = torch.where(got == 1, 255, 0).to(torch.uint8)
    dm = marching.mask_to_surface_device(mask, spacing=pipeline.SPACING)
    assert dm.n_tris > 0 and bool(torch.isfinite(dm.verts3v).all())

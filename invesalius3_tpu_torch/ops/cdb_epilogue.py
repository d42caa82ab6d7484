"""The transition between two convolutions of FastSurferCNN's competitive
dense block (``models/fastsurfer.py``): the hand-written CUDA kernel and its
plain version.

``cdb_epilogue(y, norm, skip, slope, out, act)`` computes, per element of
an (N, C, H, W) tensor ``y`` (float32 or bfloat16)::

    r   = (float(y) - mean[c]) * mul[c] + bias[c]   # norm = (mean, mul, bias); else float(y)
    m   = maximum(r, skip)                          # skip: float32 like y; else m = r
    out = m                                         # float32, when out is True
    act = where(m >= 0, m, slope * m).to(act)       # slope: one float32; else m.to(act)

as ``BatchNorm`` (eval), ``torch.maximum``, ``PReLU`` and the next
convolution's cast compute it, bit for bit: ``mul`` is ``rsqrt(running_var
+ eps) * weight``, made by the caller with ``BatchNorm.forward``'s own
expression.  It replaces no TPU kernel: the modules' eager passes took two
thirds of the parcellation's device time on an H100.  A CUDA tensor goes
through ``csrc/cdb_epilogue.cu`` (one launch); only a CPU tensor takes the
plain version, ``cdb_epilogue_ref``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# calls that launched the CUDA kernel, and calls that took the plain version
# on the CPU; callers reset the counts to measure one run
LAUNCHES = {"cdb_epilogue": 0, "ref": 0}

DTYPES = (torch.float32, torch.bfloat16)
_NORM, _MAXOUT, _OUT, _ACT, _PRELU = 1, 2, 4, 8, 16  # the kernel's flags

Norm = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def cdb_epilogue_ref(y: torch.Tensor, norm: Optional[Norm] = None,
                     skip: Optional[torch.Tensor] = None, slope: Optional[torch.Tensor] = None,
                     out: bool = False, act: Optional[torch.dtype] = None):
    """Plain PyTorch: the modules' own expressions, in their order."""
    if norm is not None:
        mean, mul, bias = norm
        shape = (1, -1) + (1,) * (y.dim() - 2)
        m = (y.to(torch.float32) - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    else:
        m = y.to(torch.float32)
    if skip is not None:
        m = torch.maximum(m, skip)
    a = None
    if act is not None:
        a = m if slope is None else torch.where(m >= 0, m, slope.to(m.dtype) * m)
        a = a.to(act)
    return (m if out else None), a


def _check_term(name: str, t: torch.Tensor, shape, y: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.shape != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != y.device:
        raise ValueError(f"{name} is on {t.device}, y on {y.device}")


def _check(y, norm, skip, slope, out, act) -> None:
    if y.dim() != 4 or y.numel() == 0:
        raise ValueError(f"y must be a non-empty (N, C, H, W) tensor, got {tuple(y.shape)}")
    if y.dtype not in DTYPES:
        raise TypeError(f"y must be float32 or bfloat16, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous (N, C, H, W)")
    if not out and act is None:
        raise ValueError("nothing asked: give out=True, act or both")
    if act is not None and act not in DTYPES:
        raise TypeError(f"act must be float32 or bfloat16, got {act}")
    if slope is not None:
        if act is None:
            raise ValueError("a PReLU slope applies to act only")
        _check_term("slope", slope, (1,), y)
    if skip is not None:
        _check_term("skip", skip, y.shape, y)
    if norm is not None:
        channels = (y.shape[1],)
        for name, t in zip(("mean", "mul", "bias"), norm):
            _check_term(name, t, channels, y)


def cdb_epilogue(y: torch.Tensor, norm: Optional[Norm] = None,
                 skip: Optional[torch.Tensor] = None, slope: Optional[torch.Tensor] = None,
                 out: bool = False, act: Optional[torch.dtype] = None):
    """(out, act): the float32 ``m`` (None unless ``out``) and the next
    convolution's input in ``act`` (None without it).  CUDA tensors launch
    the kernel on the current stream; CPU tensors take ``cdb_epilogue_ref``."""
    _check(y, norm, skip, slope, out, act)
    if y.device.type == "cpu":
        LAUNCHES["ref"] += 1
        return cdb_epilogue_ref(y, norm, skip, slope, out, act)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    from invesalius3_tpu_torch import _build

    lib = _build.cdb_epilogue_lib()
    m = torch.empty(y.shape, dtype=torch.float32, device=y.device) if out else None
    a = torch.empty(y.shape, dtype=act, device=y.device) if act is not None else None
    flags = ((_NORM if norm is not None else 0) | (_MAXOUT if skip is not None else 0)
             | (_OUT if out else 0) | (_ACT if act is not None else 0)
             | (_PRELU if slope is not None else 0))
    mean, mul, bias = norm if norm is not None else (None, None, None)
    ptrs = [None if t is None else t.data_ptr() for t in (mean, mul, bias, skip, slope, m, a)]
    n, c = y.numel(), y.shape[1]
    if y.device.index != torch.cuda.current_device():
        with torch.cuda.device(y.device):
            err = _launch(lib, y, ptrs, act, n, c, flags)
    else:
        err = _launch(lib, y, ptrs, act, n, c, flags)
    if err != 0:
        raise RuntimeError(f"cdb_epilogue launch failed ({tuple(y.shape)}, {y.dtype}, flags "
                           f"{flags}): error {err}")
    LAUNCHES["cdb_epilogue"] += 1
    return m, a


def _launch(lib, y, ptrs, act, n, c, flags) -> int:
    # the current stream's handle as torch's own generated kernels read it:
    # ``torch.cuda.current_stream(device)`` builds a Stream object, which
    # cost about a sixth of this wrapper's host time, 36 times a network
    stream = torch._C._cuda_getCurrentRawStream(y.device.index)
    return lib.cdb_epilogue(y.data_ptr(), int(y.dtype == torch.bfloat16), *ptrs,
                            int(act == torch.bfloat16), n, n // (y.shape[0] * c), c, flags,
                            stream)

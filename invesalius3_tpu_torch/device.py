"""Where the port's entry points put their tensors.

Every public entry point that takes a ``device`` defaults to the card
(``DEFAULT_DEVICE``).  Without one it raises instead of falling back: the
CPU is used only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names a CUDA device
    and no card is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for device={str(device)!r}: the port runs on the "
            "card by default; pass device='cpu' to run on the CPU")
    return dev


def as_tensor(x, device: torch.device, dtype: torch.dtype = None) -> torch.Tensor:
    """A tensor or a host array as a tensor on ``device``, in ``dtype`` (its
    own when None); a read-only host array is copied first, so the tensor
    never aliases memory it may not own."""
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(np.asarray(x))
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    return x.to(device=device, dtype=dtype)

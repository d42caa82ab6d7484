"""Torch-checkpoint interop (port of invesalius3_tpu/models/torch_convert.py):
load eager *or* TorchScript archives into plain ``{name: ndarray}`` state
dicts that the port's modules load with ``load_state_dict``.

The reference distributes some models as eager state_dicts (brain/trachea,
reference segment.py:171 ``torch.load``) and others as opaque TorchScript
archives (mandible / cranioplasty implant, reference segment.py:260
``torch.jit.load``).  TorchScript preserves submodule names, so a scripted
model's parameters extract under the same keys as its eager twin.  Only
the weights are read: the scripted module is never run.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# wrapper module prefixes seen around published checkpoints: DataParallel
# ("module."), the reference's WrapModel ("model.", reference
# deep_learning/model.py:116-123), and Lightning ("net.")
_WRAPPER_PREFIXES = ("module.", "model.", "net.")


def strip_wrapper_prefixes(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Remove a single uniform wrapper prefix (applied repeatedly)."""
    while True:
        for p in _WRAPPER_PREFIXES:
            if state and all(k.startswith(p) for k in state):
                state = {k[len(p):]: v for k, v in state.items()}
                break
        else:
            return state


def torch_state_dict(path) -> Dict[str, np.ndarray]:
    """Extract a ``{name: float-ndarray}`` state dict from ``path``.

    Accepts: an eager checkpoint (raw state_dict, or a dict with a
    ``model_state_dict``/``state_dict`` entry per the reference's training
    scripts), a pickled ``nn.Module``, a TorchScript archive, or an ONNX
    model (initializer extraction via models/onnx_convert.py — the format
    the reference ships FastSurfer parcellation weights in, reference
    segment.py:197-209 onnx.load + OnnxRunner).
    """
    if str(path).lower().endswith(".onnx"):
        from .onnx_convert import onnx_state_dict

        return onnx_state_dict(path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:
        obj = torch.jit.load(path, map_location="cpu")
    if isinstance(obj, dict):
        for key in ("model_state_dict", "state_dict"):
            if key in obj:
                obj = obj[key]
                break
    if hasattr(obj, "state_dict") and not isinstance(obj, dict):
        obj = obj.state_dict()
    out = {}
    for k, v in obj.items():
        if k.endswith("num_batches_tracked"):
            continue
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return strip_wrapper_prefixes(out)

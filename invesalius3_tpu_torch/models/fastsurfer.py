"""FastSurfer brain parcellation: competitive-dense-block CNN + 2.5D
three-view pipeline (port of invesalius3_tpu/models/fastsurfer.py).

Reference: invesalius/segmentation/deep_learning/fastsurfer_subpart/ —
``Pipeline`` (pipeline.py:36) conforms the T1 to 1mm/256, runs a per-plane
(axial/coronal/sagittal) FastSurfer network on 7-slice thick-slice inputs
(ONNX checkpoints; misc.py ModelConfig: 79 classes, 7 channels, 256x256),
remaps the sagittal logits to the full label space (data_process.py:320
apply_sagittal_mapping + :301 infer_mapping_from_lut), and aggregates the
views with weights 0.4/0.4/0.2 (inference.py:214 ``self.alpha``); LUT.tsv
lists the 79-class aparc.DKTatlas+aseg label set.

Architecture: the published FastSurferCNN design (Henschel et al.,
NeuroImage 2020) — an encoder/decoder of *competitive dense blocks*
(maxout competition in place of dense connections), 2x2 max-pooling with
index-preserving unpooling, and a 1x1 classifier.  The module names are
those of the JAX package's ``convert_torch_state_dict``: ``<block>.conv{i}``,
``<block>.bn{i}``, ``<block>.prelu{i}`` for enc1..enc4, bottleneck,
dec1..dec4 (enc1 has bn0 and no prelu1), and ``classifier``.

Activations are NCHW; the input is cast to ``dtype`` (bfloat16 by default)
before ``enc1.bn0``, convolutions compute in ``dtype``, batch norms, PReLU,
the competitions and the classifier in float32 (``models/layers.py``).
The pooling indices take the first maximum of each 2x2 window in (dy, dx)
order, as ``jnp.argmax`` does.  The network starts in eval mode (the Flax
flag's default); ``train()`` is the JAX model's ``train=True``.  Gradients
pass as JAX's do: a tied 2x2 maximum and a tied maxout competition split
the cotangent evenly, and unpooling passes it through its one-hot.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.models.layers import (BatchNorm, PReLU, conv, fp32_convs,
                                                 init_state, load)
from invesalius3_tpu_torch.ops import cdb_epilogue as epilogue
from invesalius3_tpu_torch.utils import logging as ilog

CONFORM_SIZE = 256
THICK = 7  # thick-slice input channels (FastSurfer convention)

# ---------------------------------------------------------------------------
# Label table: the published FastSurfer 79-class aparc.DKTatlas+aseg set
# (IDs and names are the FreeSurfer standard; reference LUT.tsv carries the
# same table).  (ID, name, category).
# ---------------------------------------------------------------------------
LUT_ROWS: List[Tuple[int, str, str]] = [
    (0, "Background", "Background"),
    (2, "Left-Cerebral-White-Matter", "White_Matter"),
    (4, "Left-Lateral-Ventricle", "Ventricles"),
    (5, "Left-Inf-Lat-Vent", "Ventricles"),
    (7, "Left-Cerebellum-White-Matter", "White_Matter"),
    (8, "Left-Cerebellum-Cortex", "Cerebellum"),
    (10, "Left-Thalamus", "Subcortical"),
    (11, "Left-Caudate", "Subcortical"),
    (12, "Left-Putamen", "Subcortical"),
    (13, "Left-Pallidum", "Subcortical"),
    (14, "3rd-Ventricle", "Ventricles"),
    (15, "4th-Ventricle", "Ventricles"),
    (16, "Brain-Stem", "Brain_Stem"),
    (17, "Left-Hippocampus", "Subcortical"),
    (18, "Left-Amygdala", "Subcortical"),
    (24, "CSF", "CSF"),
    (26, "Left-Accumbens-area", "Subcortical"),
    (28, "Left-VentralDC", "Subcortical"),
    (31, "Left-choroid-plexus", "Choroid_Plexus"),
    (41, "Right-Cerebral-White-Matter", "White_Matter"),
    (43, "Right-Lateral-Ventricle", "Ventricles"),
    (44, "Right-Inf-Lat-Vent", "Ventricles"),
    (46, "Right-Cerebellum-White-Matter", "White_Matter"),
    (47, "Right-Cerebellum-Cortex", "Cerebellum"),
    (49, "Right-Thalamus", "Subcortical"),
    (50, "Right-Caudate", "Subcortical"),
    (51, "Right-Putamen", "Subcortical"),
    (52, "Right-Pallidum", "Subcortical"),
    (53, "Right-Hippocampus", "Subcortical"),
    (54, "Right-Amygdala", "Subcortical"),
    (58, "Right-Accumbens-area", "Subcortical"),
    (60, "Right-VentralDC", "Subcortical"),
    (63, "Right-choroid-plexus", "Choroid_Plexus"),
    (77, "WM-hypointensities", "White_Matter"),
    (1002, "ctx-lh-caudalanteriorcingulate", "Cortical"),
    (1003, "ctx-lh-caudalmiddlefrontal", "Cortical"),
    (1005, "ctx-lh-cuneus", "Cortical"),
    (1006, "ctx-lh-entorhinal", "Cortical"),
    (1007, "ctx-lh-fusiform", "Cortical"),
    (1008, "ctx-lh-inferiorparietal", "Cortical"),
    (1009, "ctx-lh-inferiortemporal", "Cortical"),
    (1010, "ctx-lh-isthmuscingulate", "Cortical"),
    (1011, "ctx-lh-lateraloccipital", "Cortical"),
    (1012, "ctx-lh-lateralorbitofrontal", "Cortical"),
    (1013, "ctx-lh-lingual", "Cortical"),
    (1014, "ctx-lh-medialorbitofrontal", "Cortical"),
    (1015, "ctx-lh-middletemporal", "Cortical"),
    (1016, "ctx-lh-parahippocampal", "Cortical"),
    (1017, "ctx-lh-paracentral", "Cortical"),
    (1018, "ctx-lh-parsopercularis", "Cortical"),
    (1019, "ctx-lh-parsorbitalis", "Cortical"),
    (1020, "ctx-lh-parstriangularis", "Cortical"),
    (1021, "ctx-lh-pericalcarine", "Cortical"),
    (1022, "ctx-lh-postcentral", "Cortical"),
    (1023, "ctx-lh-posteriorcingulate", "Cortical"),
    (1024, "ctx-lh-precentral", "Cortical"),
    (1025, "ctx-lh-precuneus", "Cortical"),
    (1026, "ctx-lh-rostralanteriorcingulate", "Cortical"),
    (1027, "ctx-lh-rostralmiddlefrontal", "Cortical"),
    (1028, "ctx-lh-superiorfrontal", "Cortical"),
    (1029, "ctx-lh-superiorparietal", "Cortical"),
    (1030, "ctx-lh-superiortemporal", "Cortical"),
    (1031, "ctx-lh-supramarginal", "Cortical"),
    (1034, "ctx-lh-transversetemporal", "Cortical"),
    (1035, "ctx-lh-insula", "Cortical"),
    (2002, "ctx-rh-caudalanteriorcingulate", "Cortical"),
    (2005, "ctx-rh-cuneus", "Cortical"),
    (2010, "ctx-rh-isthmuscingulate", "Cortical"),
    (2012, "ctx-rh-lateralorbitofrontal", "Cortical"),
    (2013, "ctx-rh-lingual", "Cortical"),
    (2014, "ctx-rh-medialorbitofrontal", "Cortical"),
    (2016, "ctx-rh-parahippocampal", "Cortical"),
    (2017, "ctx-rh-paracentral", "Cortical"),
    (2021, "ctx-rh-pericalcarine", "Cortical"),
    (2022, "ctx-rh-postcentral", "Cortical"),
    (2023, "ctx-rh-posteriorcingulate", "Cortical"),
    (2024, "ctx-rh-precentral", "Cortical"),
    (2025, "ctx-rh-precuneus", "Cortical"),
    (2028, "ctx-rh-superiorfrontal", "Cortical"),
]
NUM_CLASSES = len(LUT_ROWS)  # 79

# left aseg label -> right counterpart (FreeSurfer standard; reference
# data_process.py:463 sagittal_coronal_remap_lookup)
_LEFT_TO_RIGHT = {2: 41, 3: 42, 4: 43, 5: 44, 7: 46, 8: 47, 10: 49, 11: 50,
                  12: 51, 13: 52, 17: 53, 18: 54, 26: 58, 28: 60, 31: 63}


def class_ids(rows: Sequence[Tuple[int, str, str]] = LUT_ROWS) -> np.ndarray:
    return np.asarray([r[0] for r in rows], np.int32)


def get_labels_from_lut(rows: Sequence[Tuple[int, str, str]] = LUT_ROWS,
                        label_extract=("Left-", "ctx-rh")):
    """(full ids, sagittal ids) — the sagittal network merges lateralized
    labels, dropping Left-* aseg and ctx-rh-* (reference
    data_process.py:289)."""
    ids = class_ids(rows)
    keep = np.asarray([not r[1].startswith(label_extract) for r in rows])
    return ids, ids[keep]


def infer_sagittal_mapping(rows: Sequence[Tuple[int, str, str]] = LUT_ROWS) -> np.ndarray:
    """full-class index -> sagittal-class index (reference
    data_process.py:301 infer_mapping_from_lut): match by ID, then by
    ID-1000 (ctx-rh -> ctx-lh), then by the left->right aseg table."""
    ids, ids_sag = get_labels_from_lut(rows)
    idx = np.empty(len(ids), np.int16)
    for i, label in enumerate(ids):
        hit = np.where(ids_sag == label)[0]
        if hit.size == 0:
            hit = np.where(ids_sag == label - 1000)[0]
        if hit.size == 0:
            hit = np.where(ids_sag == _LEFT_TO_RIGHT[int(label)])[0]
        idx[i] = hit[0]
    return idx


def sagittal_index(rows: Sequence[Tuple[int, str, str]] = LUT_ROWS,
                   device=None) -> torch.Tensor:
    """``infer_sagittal_mapping`` as an int64 tensor on ``device``."""
    return torch.from_numpy(infer_sagittal_mapping(rows).astype(np.int64)).to(device)


def apply_sagittal_mapping(logits: torch.Tensor,
                           rows: Sequence[Tuple[int, str, str]] = LUT_ROWS,
                           index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Expand sagittal logits (..., n_sag) to the full class space
    (..., n_full) by index gather (reference data_process.py:320).
    ``index`` is ``sagittal_index(rows)`` on the logits' device, made here
    when not given."""
    if index is None:
        index = sagittal_index(rows, logits.device)
    return logits.index_select(-1, index)


def write_lut_tsv(path) -> None:
    """Write the label table as a FreeSurfer-style LUT.tsv (colors are
    deterministic distinct placeholders; IDs/names are the standard)."""
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        f.write("ID\tLabelName\tCategory\tR\tG\tB\tA\n")
        for lid, name, cat in LUT_ROWS:
            r, g, b = rng.integers(0, 256, 3)
            f.write(f"{lid}\t{name}\t{cat}\t{r}\t{g}\t{b}\t0\n")


# ---------------------------------------------------------------------------
# FastSurferCNN: competitive dense blocks, index unpooling
# ---------------------------------------------------------------------------

def max_pool_with_indices(x: torch.Tensor):
    """2x2/stride-2 max pool of (N, C, H, W) returning (pooled, index of the
    first maximum in the 2x2 window, dy * 2 + dx, int8).  Non-overlapping
    windows = a reshape."""
    n, c, h, w = x.shape
    t = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
    t = t.reshape(n, c, h // 2, w // 2, 4)
    return t.amax(-1), torch.argmax(t, dim=-1).to(torch.int8)


def max_unpool(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Inverse of max_pool_with_indices: each value back at its window's
    index, zeros elsewhere (x times a one-hot, as the JAX package)."""
    n, c, h, w = x.shape
    onehot = F.one_hot(idx.long(), 4).to(x.dtype)
    t = (x[..., None] * onehot).reshape(n, c, h, w, 2, 2).permute(0, 1, 2, 4, 3, 5)
    return t.reshape(n, c, h * 2, w * 2)


class CompetitiveDenseBlock(nn.Module):
    """Three (PReLU -> Conv -> BN) sequences with maxout competition after
    the first two (paper Sec. 2.2: dense connections replaced by maxout).
    ``in_block`` swaps the first PReLU for a BN to normalize raw inputs and
    skips the first competition (the raw input has a different width).

    In inference (eval mode, no autograd) each transition around a
    convolution, the norm, the competition, the PReLU and the cast to the
    convolution's type, is one ``ops/cdb_epilogue.py`` call, bit for bit
    the modules' result: four a block.  It takes a contiguous (N, C, H, W)
    float32 input (bfloat16 too for ``in_block``), one slope a PReLU and
    float32 norms; anything else runs the modules one by one.  Traced, a
    fused forward adds its four calls to the root's count
    ``fastsurfer.epilogue``."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 in_block: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"kernel {kernel}: only odd kernels pad as 'SAME'")
        self.in_block = in_block
        self.dtype = dtype
        if in_block:
            self.bn0 = BatchNorm(in_channels)
        else:
            self.prelu1 = PReLU(init=0.25)
        for i, cin in ((1, in_channels), (2, features), (3, features)):
            if i > 1:
                setattr(self, f"prelu{i}", PReLU(init=0.25))
            setattr(self, f"conv{i}", nn.Conv2d(cin, features, kernel,
                                                padding=kernel // 2, bias=False))
            setattr(self, f"bn{i}", BatchNorm(features))
        self._muls: Dict[str, tuple] = {}  # norm name -> (stamp, mul, its storage)

    # by in_block: the PReLUs and the norms of the fused path, in its order
    _PRELUS = {False: ("prelu1", "prelu2", "prelu3"), True: ("prelu2", "prelu3")}
    _NORMS = {False: ("bn1", "bn2", "bn3"), True: ("bn0", "bn1", "bn2", "bn3")}

    def _norm_terms(self, name: str):
        """``(running_mean, mul, bias)`` of the norm ``name`` for the fused
        path, or None when a term is not float32.  ``mul`` is made by
        ``BatchNorm.forward``'s expression once, and anew when the mode,
        ``running_var`` or ``weight`` changes (the stamp holds their storage,
        so no other tensor takes its address).  The modules' dictionaries
        are read directly: ``nn.Module.__getattr__`` would cost more host
        time than the launch."""
        bn = self._modules[name]
        var, w = bn._buffers["running_var"], bn._parameters["weight"]
        mean, bias = bn._buffers["running_mean"], bn._parameters["bias"]
        stamp = (self.training, var.data_ptr(), var._version, w.data_ptr(), w._version)
        hit = self._muls.get(name)
        if hit is None or hit[0] != stamp:
            f32 = all(t.dtype == torch.float32 for t in (mean, var, w, bias))
            hit = self._muls[name] = (stamp, torch.rsqrt(var + bn.eps) * w if f32 else None,
                                      var.detach(), w.detach())
        if hit[1] is None or mean.dtype != torch.float32 or bias.dtype != torch.float32:
            return None
        return mean, hit[1], bias

    def _fused(self, x: torch.Tensor):
        """The norms' terms (bn0 first in ``in_block``) when this call takes
        the fused path, else None."""
        if (self.training or torch.is_grad_enabled() or x.dim() != 4
                or not x.is_contiguous() or x.device.type not in ("cpu", "cuda")
                or self.dtype not in epilogue.DTYPES
                or x.dtype not in (epilogue.DTYPES if self.in_block else (torch.float32,))):
            return None
        mods = self._modules
        for name in self._PRELUS[self.in_block]:
            slope = mods[name]._parameters["weight"]
            if slope.dtype != torch.float32 or slope.numel() != 1:
                return None
        terms = [self._norm_terms(n) for n in self._NORMS[self.in_block]]
        return None if None in terms else terms

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        terms = self._fused(x)
        if terms is not None:
            return self._forward_fused(x, terms)
        if self.in_block:
            m1 = self.bn1(conv(self.conv1, self.bn0(x), self.dtype))
        else:
            r1 = self.bn1(conv(self.conv1, self.prelu1(x), self.dtype))
            m1 = torch.maximum(r1, x)
        r2 = self.bn2(conv(self.conv2, self.prelu2(m1), self.dtype))
        m2 = torch.maximum(r2, m1)
        return self.bn3(conv(self.conv3, self.prelu3(m2), self.dtype))

    def _forward_fused(self, x: torch.Tensor, terms) -> torch.Tensor:
        ep, dt, mods = epilogue.cdb_epilogue, self.dtype, self._modules

        def conv_out(i, a):  # a convolution's output as the kernel takes it
            return conv(mods[f"conv{i}"], a, dt).contiguous()

        slope = {i: mods[f"prelu{i}"]._parameters["weight"]
                 for i in ((2, 3) if self.in_block else (1, 2, 3))}
        if self.in_block:
            t0, t1, t2, t3 = terms
            _, a = ep(x, norm=t0, act=dt)
        else:
            t1, t2, t3 = terms
            _, a = ep(x, slope=slope[1], act=dt)
        m1, a = ep(conv_out(1, a), norm=t1, skip=None if self.in_block else x, slope=slope[2],
                   out=True, act=dt)
        _, a = ep(conv_out(2, a), norm=t2, skip=m1, slope=slope[3], act=dt)
        out = ep(conv_out(3, a), norm=t3, out=True)[0]
        ilog.count("fastsurfer.epilogue", 4)
        return out


class FastSurferCNN(nn.Module):
    """Encoder (4 CDB + pool) -> bottleneck CDB -> decoder (4 x unpool +
    maxout-skip + CDB) -> 1x1 classifier.  Input: (N, 7, H, W) thick
    slices; output: (N, num_classes, H, W) float32 logits."""

    def __init__(self, num_classes: int = NUM_CLASSES, filters: int = 64,
                 kernel: int = 3, dtype: torch.dtype = torch.bfloat16,
                 thick: int = THICK):
        super().__init__()
        f = filters
        self.dtype = dtype
        self.enc1 = CompetitiveDenseBlock(thick, f, kernel, True, dtype)
        for name in ("enc2", "enc3", "enc4", "bottleneck", "dec4", "dec3", "dec2", "dec1"):
            setattr(self, name, CompetitiveDenseBlock(f, f, kernel, False, dtype))
        self.classifier = nn.Conv2d(f, num_classes, 1)
        self.eval()  # Flax's default, train=False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with fp32_convs(x.device):
            skips, indices = [], []
            y = x.to(self.dtype)
            for i in range(1, 5):
                y = getattr(self, f"enc{i}")(y)
                skips.append(y)
                y, idx = max_pool_with_indices(y)
                indices.append(idx)
            y = self.bottleneck(y)
            for i in range(3, -1, -1):
                y = torch.maximum(max_unpool(y, indices[i]), skips[i])  # competition
                y = getattr(self, f"dec{i + 1}")(y)
            return conv(self.classifier, y, torch.float32)


def load_torch_checkpoint(path) -> Dict:
    """The state dict of a torch checkpoint (eager, pickled module or
    TorchScript)."""
    from invesalius3_tpu_torch.models.torch_convert import torch_state_dict

    return torch_state_dict(path)


def load_onnx_checkpoint(path) -> Dict:
    """Load published FastSurfer ONNX weights (the format the reference
    ships for parcellation, reference fastsurfer_subpart/inference.py:159
    TinyGradInference + tinygrad_extra/onnx.py) via initializer extraction —
    no ONNX runtime involved."""
    from invesalius3_tpu_torch.models.onnx_convert import onnx_state_dict

    return onnx_state_dict(path)


# ---------------------------------------------------------------------------
# 2.5D pipeline: conform -> thick slices -> 3 views -> aggregate
# ---------------------------------------------------------------------------

def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def conform_tensor(volume: torch.Tensor, out_size: int = CONFORM_SIZE) -> torch.Tensor:
    """``conform`` on the volume's device, the result a float32 tensor."""
    from invesalius3_tpu_torch.ops.resize import resize_volume

    v = resize_volume(volume.to(torch.float32), (out_size,) * 3, order=1)
    vmin, vmax = v.min(), v.max()
    span = torch.where(vmax == vmin, _f32(1.0, v.device), vmax - vmin)
    return (v - vmin) / span * _f32(255.0, v.device)


def conform(volume: np.ndarray, out_size: int = CONFORM_SIZE,
            device=DEFAULT_DEVICE) -> np.ndarray:
    """Conform to isotropic out_size^3 with intensity rescale to [0, 255]
    (reference pipeline.py conform_and_save :203 semantics, simplified: no
    LIA reorientation — the reader already canonicalizes to RAS, and view
    axes are taken directly from the canonical volume), computed on
    ``device``."""
    v = torch.from_numpy(np.ascontiguousarray(volume)).to(resolve_device(device))
    return conform_tensor(v, out_size).cpu().numpy()


def thick_slices(volume: torch.Tensor, axis: int, thick: int = THICK) -> torch.Tensor:
    """(N, thick, H, W) batch of thick slices along ``axis`` (edge pad),
    matching reference data_process.py ProcessDataThickSlices (the JAX
    package's (N, H, W, thick) with the channels first)."""
    v = volume.movedim(axis, 0)
    h = thick // 2
    padded = torch.cat([v[:1]] * h + [v] + [v[-1:]] * h)
    return torch.stack([padded[i: i + v.shape[0]] for i in range(thick)], dim=1)


def kernel_of(variables) -> int:
    """The blocks' convolution width in ``variables`` (a state dict, or one
    a view): the first convolution's last dimension, 3 with no weights."""
    state = variables.get("axial", variables) if variables else {}
    w = state.get("enc1.conv1.weight") if hasattr(state, "get") else None
    return 3 if w is None else int(w.shape[-1])


class FastSurferPipeline:
    """Per-plane inference + view aggregation (reference pipeline.py:36,
    inference.py eval: sagittal remap + alpha weights), on ``device``.

    The weighted logits of each batch of slices are added into one
    (D, H, W, classes) float32 sum as the batch finishes, the views in the
    JAX package's order, so the sum is the JAX package's value by value and
    no view's logits are kept whole.  Batches stay NCHW: channels-last ran
    no faster on an H100 (PERF.md §5)."""

    VIEW_WEIGHTS = {"axial": 0.4, "coronal": 0.4, "sagittal": 0.2}
    VIEWS = (("axial", 0), ("coronal", 1), ("sagittal", 2))

    def __init__(self, num_classes: int = NUM_CLASSES,
                 variables: Optional[Dict] = None, batch_size: int = 8,
                 filters: int = 64, sagittal_merged: bool = True,
                 device=DEFAULT_DEVICE):
        """`variables` maps view -> state dict (or is one shared state dict).
        The blocks' convolution width is the weights' own (``kernel_of``:
        the published networks' 5), 3 for a random init.
        With ``sagittal_merged`` the sagittal net predicts the merged
        (non-lateralized) class set and its logits are expanded via
        apply_sagittal_mapping, as the reference does.  A view without
        weights gets a random init from ``torch.Generator().manual_seed(i)``,
        i its index in (axial, coronal, sagittal) (tests and smoke runs)."""
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.sagittal_merged = sagittal_merged and num_classes == NUM_CLASSES
        n_sag = (len(get_labels_from_lut()[1]) if self.sagittal_merged
                 else num_classes)
        if variables is None:
            variables = {}
        kernel = kernel_of(variables)
        models = {
            "axial": FastSurferCNN(num_classes=num_classes, filters=filters, kernel=kernel),
            "coronal": FastSurferCNN(num_classes=num_classes, filters=filters, kernel=kernel),
            "sagittal": FastSurferCNN(num_classes=n_sag, filters=filters, kernel=kernel),
        }
        if isinstance(variables, dict) and "axial" not in variables:
            # single shared state dict (tests) or empty -> random init
            shared = variables or None
            variables = {}
            for i, (view, m) in enumerate(models.items()):
                if shared is not None and view != "sagittal":
                    variables[view] = shared
                else:
                    variables[view] = init_state(m, torch.Generator().manual_seed(i))
        self.variables = variables
        self.models = {view: load(m, variables[view], self.device)
                       for view, m in models.items()}
        # made once a pipeline: a host-made index's copy to the card, from
        # pageable memory, waits for the card's queue to drain
        self.sagittal_index = (sagittal_index(device=self.device)
                               if self.sagittal_merged else None)

    def view_logits(self, batch: torch.Tensor, view: str) -> torch.Tensor:
        """(b, H, W, classes) float32 logits of a (b, 7, H, W) batch of
        thick slices through ``view``'s network, in its own class set."""
        with torch.inference_mode():
            return self.models[view](batch).permute(0, 2, 3, 1)

    def full_classes(self, logits: torch.Tensor, view: str) -> torch.Tensor:
        """``view_logits`` in the full class set: the sagittal ones
        expanded by ``apply_sagittal_mapping``."""
        if view == "sagittal" and self.sagittal_merged:
            return apply_sagittal_mapping(logits, index=self.sagittal_index)
        return logits

    def plane_logits(self, batch: torch.Tensor, view: str) -> torch.Tensor:
        """(b, H, W, num_classes) float32 logits of a (b, 7, H, W) batch of
        thick slices through ``view``'s network, the sagittal ones expanded
        to the full class set."""
        return self.full_classes(self.view_logits(batch, view), view)

    def aggregate(self, volume: torch.Tensor, progress=None) -> torch.Tensor:
        """(D, H, W, num_classes) float32: the views' logits weighted and
        summed (axial, then coronal, then sagittal).  Traced, each view is
        the span ``parcellate.view``, each batch ``parcellate.batch`` with
        ``parcellate.model`` (the network) and ``parcellate.add`` (remap,
        weight and add into the sum) inside; the count
        ``parcellate.slices`` adds the slices through a network."""
        agg = None
        for vi, (view, axis) in enumerate(self.VIEWS):
            with ilog.span("parcellate.view", view=view):
                batch = thick_slices(volume, axis)
                n = batch.shape[0]
                weight = _f32(self.VIEW_WEIGHTS[view], volume.device)
                for i in range(0, n, self.batch_size):
                    with ilog.span("parcellate.batch", index=i // self.batch_size):
                        with ilog.span("parcellate.model"):
                            logits = self.view_logits(batch[i: i + self.batch_size], view)
                        with ilog.span("parcellate.add"):
                            part = (self.full_classes(logits, view) * weight).movedim(0, axis)
                            if agg is None:
                                agg = torch.empty(volume.shape + (part.shape[-1],),
                                                  dtype=torch.float32, device=volume.device)
                            dst = agg.narrow(axis, i, part.shape[axis])
                            if vi == 0:
                                dst.copy_(part)
                            else:
                                dst.add_(part)
                    ilog.count("parcellate.slices", part.shape[axis])
                    if progress is not None:
                        progress(vi / 3.0 + (1.0 / 3.0) * min(1.0, (i + self.batch_size) / n))
        return agg

    def run_tensor(self, t1_volume, conform_input: bool = True,
                   conform_size: int = CONFORM_SIZE,
                   return_freesurfer_ids: bool = False, progress=None) -> torch.Tensor:
        """``run`` with the labels left on the device.  Traced, the move
        to the device and the conform are the span ``parcellate.conform``,
        the argmax and the id map ``parcellate.labels``."""
        with ilog.span("parcellate.conform"):
            vol = torch.as_tensor(np.ascontiguousarray(t1_volume)).to(self.device)
            vol = conform_tensor(vol, conform_size) if conform_input else vol.to(torch.float32)
        agg = self.aggregate(vol, progress)
        with ilog.span("parcellate.labels"):
            labels = torch.argmax(agg, dim=-1).to(torch.int32)
            del agg
            if return_freesurfer_ids:
                labels = torch.from_numpy(class_ids()).to(self.device)[labels.long()]
        return labels

    def run(self, t1_volume: np.ndarray, conform_input: bool = True,
            conform_size: int = CONFORM_SIZE,
            return_freesurfer_ids: bool = False, progress=None) -> np.ndarray:
        """int32 label volume: argmax of the weighted three-view logits;
        optionally mapped from class index to FreeSurfer label id.
        ``progress`` (0..1 callback) mirrors reference pipeline.py's
        progress_callback seam (segment.py:663)."""
        return self.run_tensor(t1_volume, conform_input, conform_size,
                               return_freesurfer_ids, progress).cpu().numpy()


# ---------------------------------------------------------------------------
# Quick QC (reference fastsurfer_subpart/quick_qc.py:35-196)
# ---------------------------------------------------------------------------

VENT_LABELS = {
    "Left-Lateral-Ventricle": 4,
    "Right-Lateral-Ventricle": 43,
    "Left-choroid-plexus": 31,
    "Right-choroid-plexus": 63,
}


def _qc_counts(seg: torch.Tensor) -> Tuple[int, int]:
    """Total foreground count + the count of background voxels touching a
    1-voxel dilation of the ventricle system (reference quick_qc.py:63-134
    get_region_bg_intersection_mask), on the label volume's device."""
    from invesalius3_tpu_torch.ops import morphology

    vent_ids = torch.tensor(sorted(VENT_LABELS.values()), dtype=torch.int32,
                            device=seg.device)
    fg = (seg > 0).sum()
    vent_dil = morphology.binary_dilation(
        torch.isin(seg, vent_ids), morphology.generate_binary_structure(3, 3))
    leak = (vent_dil & (seg == 0)).sum()
    return int(fg), int(leak)


def run_quick_qc(seg: np.ndarray, voxel_volume: float,
                 volume_threshold: float = 0.70, device=DEFAULT_DEVICE) -> dict:
    """Sanity checks on a FreeSurfer-id label volume (reference
    quick_qc.py:137-196 run_quick_qc): total segmented volume must exceed
    ``volume_threshold`` liters, and the ventricle/background contact
    volume estimates CSF leakage.  Same keys as the reference's report."""
    seg_t = torch.from_numpy(np.ascontiguousarray(seg).astype(np.int32, copy=False))
    fg, leak = _qc_counts(seg_t.to(resolve_device(device)))
    total_volume_liters = float(fg) * voxel_volume / 1e6
    volume_check_passed = total_volume_liters >= volume_threshold
    return {
        "volume_check_passed": bool(volume_check_passed),
        "total_volume_liters": total_volume_liters,
        "ventricle_bg_intersection_volume_mm3": float(leak) * voxel_volume,
        "overall_passed": bool(volume_check_passed),
    }

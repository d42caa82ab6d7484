"""Deep-learning segmentation pipeline: sliding-window patch inference (port
of invesalius3_tpu/models/segment.py).

Reference behavior (invesalius/segmentation/deep_learning/segment.py):
``gen_patches`` :74 yields 48^3 patches with 50% overlap (grid positions
clamped so a final patch ends exactly at the border), one
``SegmentProcess`` subprocess runs the model patch-by-patch and writes
into a probability memmap, overwriting on overlap; models normalize input
with ``image_normalize`` to [0, 1].

On the device: the patch grid is computed on the host; each batch of
patches is gathered from the normalized volume in one indexed read, runs
through the U-Net, and is written back into the probability volume as the
batch finishes, patch by patch in grid order, so later patches overwrite
earlier ones as in the reference's sequential loop and the JAX package's
scatter, with no buffer of every patch's probabilities.  Every segmenter
runs on ``device`` (the card unless "cpu") and returns host numpy arrays.
"""

from __future__ import annotations

import threading
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.models.layers import init_state, load
from invesalius3_tpu_torch.models.unet3d import SIZE, Unet3D
from invesalius3_tpu_torch.utils import logging as ilog


class WeightsUnavailableError(RuntimeError):
    """Raised when a segmenter is built without trained weights.

    The reference downloads real checkpoints before inference or fails
    (segment.py:404-440); silently running an untrained network would
    produce wrong clinical output.
    """


def _resolve_weights(weight_name: str, allow_random_init: bool, loader=None):
    """Try to load the reference checkpoint for ``weight_name``.

    ``loader`` is the per-architecture checkpoint reader (defaults to
    unet3d's; ImplantSegmenter passes unet2d's).  Returns its state dict,
    or None when ``allow_random_init`` (with a loud warning).  Raises
    WeightsUnavailableError otherwise.
    """
    try:
        from invesalius3_tpu_torch.net.download import get_weight_file

        if loader is None:
            from invesalius3_tpu_torch.models.unet3d import load_torch_checkpoint
            loader = load_torch_checkpoint
        path = get_weight_file(weight_name)
        return loader(path)
    except Exception as e:
        if allow_random_init:
            warnings.warn(
                f"segmenter {weight_name!r} running with RANDOM weights "
                f"({e}); output is noise, not a segmentation",
                RuntimeWarning, stacklevel=3,
            )
            return None
        raise WeightsUnavailableError(
            f"no trained weights for {weight_name!r}: {e}. Place the "
            f"reference checkpoint under the ai/ models dir, pass "
            f"variables= explicitly, or (tests only) allow_random_init=True"
        ) from e


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def image_normalize(image: torch.Tensor, min_: float = 0.0, max_: float = 1.0) -> torch.Tensor:
    """Reference segment.py image_normalize: linear rescale to [min_, max_]
    in float32, on the image's device."""
    img = image.to(torch.float32)
    imin, imax = img.min(), img.max()
    span = torch.where(imax == imin, _f32(1.0, img.device), imax - imin)
    return (img - imin) * (_f32(max_ - min_, img.device) / span) + _f32(min_, img.device)


def patch_grid(shape: Tuple[int, int, int], patch_size: int = SIZE,
               overlap: float = 0.5) -> List[Tuple[int, int, int]]:
    """Static patch origin list matching reference gen_patches:74-96."""
    frac = overlap / 100.0 if overlap > 1 else overlap  # accept percent or fraction
    ov = int(patch_size * frac)
    step = patch_size - ov

    def axis_starts(s):
        starts = [i for i in range(0, s, step) if i + patch_size <= s]
        if not starts:
            starts = [0]
        elif starts[-1] + patch_size < s:
            starts.append(s - patch_size)
        return starts

    sz, sy, sx = shape
    return [
        (iz, iy, ix)
        for iz in axis_starts(sz)
        for iy in axis_starts(sy)
        for ix in axis_starts(sx)
    ]


def gather_patches(image: torch.Tensor, origins: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, p, p, p) patches of ``image`` at the (N, 3) int64 ``origins``
    (on the image's device), in one indexed read; the grid keeps every
    patch inside the image."""
    r = torch.arange(patch_size, device=image.device)
    z, y, x = (origins[:, a, None] + r for a in range(3))
    return image[z[:, :, None, None], y[:, None, :, None], x[:, None, None, :]]


def scatter_patches(out: torch.Tensor, probs: torch.Tensor,
                    origins: List[Tuple[int, ...]]) -> None:
    """Write each patch of ``probs`` into ``out`` at its origin, in order
    (later overwrites earlier — reference overwrite semantics)."""
    for prob, origin in zip(probs, origins):
        out[tuple(slice(o, o + s) for o, s in zip(origin, prob.shape))] = prob


def _image_on(image, device: torch.device) -> torch.Tensor:
    if isinstance(image, torch.Tensor):
        return image.to(device)
    a = np.ascontiguousarray(image)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def _host_result(prob: torch.Tensor, threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """(probability float32, mask uint8 0/255) on the host."""
    mask = (prob >= threshold).to(torch.uint8) * 255
    return prob.cpu().numpy(), mask.cpu().numpy()


class BrainSegmenter:
    """Patch-grid U-Net segmentation (reference BrainSegmentProcess
    semantics: normalize image to [0,1], 48^3 patches, 50% overlap,
    probability threshold -> mask).

    ``variables`` is the model's state dict (e.g. ``load_torch_checkpoint``
    or ``convert.unet3d_from_jax``); ``model`` (default ``Unet3D`` in
    bfloat16, as the JAX package builds it) receives it and moves to
    ``device``.  Weights and patches are channels-last (NDHWC): cuDNN's
    bf16 convolutions run 6-7% faster so on an H100 than on NCDHW, which
    they transpose to NDHWC and back around every layer (PERF.md §5)."""

    WEIGHT_NAME = "brain_mri_t1"

    def __init__(self, variables=None, model: Optional[Unet3D] = None,
                 patch_size: int = SIZE, overlap: float = 0.5,
                 use_ww_wl: bool = False, ww: float = 255.0, wl: float = 127.5,
                 allow_random_init: bool = False, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        model = model or Unet3D(dtype=torch.bfloat16)
        self.patch_size = patch_size
        self.overlap = overlap
        self.use_ww_wl = use_ww_wl
        self.ww, self.wl = ww, wl
        self.memory_format = torch.channels_last_3d
        if variables is None:
            variables = _resolve_weights(self.WEIGHT_NAME, allow_random_init)
        if variables is None:  # explicit random init (tests / smoke only)
            variables = init_state(model, torch.Generator().manual_seed(0))
        self.variables = variables
        self.model = load(model, variables, self.device, self.memory_format)

    def apply(self, batch: torch.Tensor) -> torch.Tensor:
        """(N, p, p, p) normalized patches -> (N, p, p, p) probabilities."""
        with torch.inference_mode():
            x = batch[:, None].contiguous(memory_format=self.memory_format)
            return self.model(x)[:, 0]

    def normalized(self, image) -> torch.Tensor:
        """The model's input volume on the device: the image windowed (with
        ``use_ww_wl``), normalized to [0, 1], zero-padded to at least one
        patch along each axis."""
        from invesalius3_tpu_torch.ops.windowing import get_lut_value_255

        img = _image_on(image, self.device)
        if self.use_ww_wl:
            img = get_lut_value_255(img, self.ww, self.wl)
        norm = image_normalize(img)
        pad = [max(0, self.patch_size - s) for s in norm.shape]
        if any(pad):
            norm = F.pad(norm, (0, pad[2], 0, pad[1], 0, pad[0]))
        return norm

    def segment(self, image, probability_threshold: float = 0.5,
                batch_size: int = 8, progress_cb=None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (probability (Z, Y, X) float32, mask uint8 0/255).
        Traced (``utils.logging.span``), it is the span ``segment``; each
        batch is ``segment.batch`` with ``segment.gather``,
        ``segment.model`` and ``segment.scatter`` inside, and the copy to
        the host ``segment.host_result``."""
        shape = tuple(int(s) for s in np.shape(image))
        with ilog.span("segment", shape=shape, batch=batch_size) as root:
            norm = self.normalized(image)
            padded_shape = tuple(int(s) for s in norm.shape)

            origins_list = patch_grid(padded_shape, self.patch_size, self.overlap)
            origins = torch.tensor(origins_list, dtype=torch.int64, device=self.device)
            prob = torch.zeros(padded_shape, dtype=torch.float32, device=self.device)
            n = len(origins_list)
            root.set(patches=n)
            for i in range(0, n, batch_size):
                chunk = origins_list[i: i + batch_size]
                with ilog.span("segment.batch", index=i // batch_size):
                    with ilog.span("segment.gather"):
                        patches = gather_patches(norm, origins[i: i + len(chunk)],
                                                 self.patch_size)
                    with ilog.span("segment.model"):
                        probs = self.apply(patches)
                    with ilog.span("segment.scatter"):
                        scatter_patches(prob, probs, chunk)
                if progress_cb is not None:
                    progress_cb(min(1.0, (i + len(chunk)) / n))
            with ilog.span("segment.host_result") as host:
                out = _host_result(prob[: shape[0], : shape[1], : shape[2]],
                                   probability_threshold)
                host.set(bytes=sum(a.nbytes for a in out))
            return out


# ---------------------------------------------------------------------------
# Job orchestration (reference SegmentProcess, segment.py:297-420)
# ---------------------------------------------------------------------------


class SegmentJob(threading.Thread):
    """Background segmentation job with progress + cancellation.

    The reference runs one multiprocessing.Process per job with memmap IPC
    and an exception Pipe (segment.py:313-380); here a thread + callbacks
    carry the same contract: ``progress`` in [0, 1], ``exception``
    captured, ``stop()`` cancels between patch batches.
    """

    def __init__(self, segmenter: "BrainSegmenter", image,
                 probability_threshold: float = 0.5, batch_size: int = 8):
        super().__init__(daemon=True)
        self.segmenter = segmenter
        self.image = image
        self.threshold = probability_threshold
        self.batch_size = batch_size
        self.progress = 0.0
        self.exception: Optional[BaseException] = None
        self.probability: Optional[np.ndarray] = None
        self.mask: Optional[np.ndarray] = None
        self._stop_event = threading.Event()

    def _on_progress(self, value: float) -> None:
        self.progress = value
        if self._stop_event.is_set():
            raise _Cancelled()

    def run(self) -> None:
        try:
            self.probability, self.mask = self.segmenter.segment(
                self.image, self.threshold, self.batch_size, self._on_progress)
            self.progress = 1.0
        except _Cancelled:
            pass
        except BaseException as e:  # mirrored to the caller like the ref Pipe
            self.exception = e

    def stop(self) -> None:
        self._stop_event.set()


class _Cancelled(Exception):
    pass


# ---------------------------------------------------------------------------
# Model family (reference segment.py:505-1165 process subclasses)
# ---------------------------------------------------------------------------


class TracheaSegmenter(BrainSegmenter):
    """Trachea CT segmentation (reference TracheaSegmentProcess :919):
    same 48^3 patch U-Net, image pre-windowed with WW/WL before
    normalization."""

    WEIGHT_NAME = "trachea_ct"

    def __init__(self, variables=None, **kw):
        kw.setdefault("use_ww_wl", True)
        kw.setdefault("ww", 2000.0)
        kw.setdefault("wl", -500.0)
        super().__init__(variables=variables, **kw)


class MandibleSegmenter(BrainSegmenter):
    """Mandible CT segmentation (reference MandibleCTSegmentProcess :956,
    TorchScript weights in the reference, read into the same U-Net)."""

    WEIGHT_NAME = "mandible_jit_ct"

    def __init__(self, variables=None, patch_size: int = 96, **kw):
        super().__init__(variables=variables, patch_size=patch_size, **kw)


class ImplantSegmenter:
    """Cranioplasty implant generation (reference ImplantCTSegmentProcess
    :1050 + run_cranioplasty_implant :30): slice-wise 2D patches of
    480x480 with overlap, binary or gray input method, U-Net-2D.

    The JAX package runs one patch a call; here a call runs ``batch_size``
    slices at one patch position, the positions in grid order, so each
    slice's patches still overwrite in the JAX package's order.  Weights
    and patches are channels-last (NHWC; 13% faster on an H100, PERF.md
    §5)."""

    PATCH = 480
    WEIGHT_NAME = "cranioplasty_jit_ct_binary"

    def __init__(self, variables=None, model=None, method: str = "binary",
                 overlap: float = 0.5, patch_size: int = 480,
                 allow_random_init: bool = False, device=DEFAULT_DEVICE):
        from invesalius3_tpu_torch.models.unet2d import Unet2D, load_torch_checkpoint

        self.device = resolve_device(device)
        model = model or Unet2D()
        self.method = method
        self.overlap = overlap
        self.patch_size = patch_size
        self.memory_format = torch.channels_last
        if variables is None:
            variables = _resolve_weights(self.WEIGHT_NAME, allow_random_init,
                                         loader=load_torch_checkpoint)
        if variables is None:  # explicit random init (tests / smoke only)
            variables = init_state(model, torch.Generator().manual_seed(0))
        self.variables = variables
        self.model = load(model, variables, self.device, self.memory_format)

    def apply(self, batch: torch.Tensor) -> torch.Tensor:
        """(N, p, p) input patches -> (N, p, p) probabilities."""
        with torch.inference_mode():
            x = batch[:, None].contiguous(memory_format=self.memory_format)
            return self.model(x)[:, 0]

    def slices(self, image) -> torch.Tensor:
        """The model's input slices on the device: 'binary' feeds the bone
        mask (image >= 300 HU), 'gray' WW/WL-normalized intensity (reference
        implant methods); zero-padded to at least one patch in y and x."""
        img = _image_on(image, self.device)
        if self.method == "binary":
            data = (img >= 300).to(torch.float32)
        else:
            from invesalius3_tpu_torch.ops.windowing import get_lut_value_255

            data = get_lut_value_255(img, 2000.0, 300.0) / _f32(255.0, self.device)
        p = self.patch_size
        return F.pad(data, (0, max(0, p - data.shape[2]), 0, max(0, p - data.shape[1])))

    def segment(self, image, probability_threshold: float = 0.5,
                batch_size: int = 8, progress_cb=None):
        """Per-slice 2D patch inference: (probability float32, mask uint8
        0/255) on the host."""
        Z, Y, X = np.shape(image)
        data = self.slices(image)
        p = self.patch_size
        Yp, Xp = data.shape[1:]
        # 2D grid per slice (reference: 480^2 patches, overlap 0.5)
        origins = [(gy, gx) for (_, gy, gx) in patch_grid((1, Yp, Xp), p, self.overlap)]

        prob = torch.zeros((Z, Yp, Xp), dtype=torch.float32, device=self.device)
        n_total = Z * len(origins)
        done = 0
        for gy, gx in origins:
            for z in range(0, Z, batch_size):
                zs = slice(z, min(z + batch_size, Z))
                prob[zs, gy:gy + p, gx:gx + p] = self.apply(data[zs, gy:gy + p, gx:gx + p])
                done += zs.stop - zs.start
                if progress_cb:
                    progress_cb(done / n_total)
        return _host_result(prob[:, :Y, :X], probability_threshold)


class SubpartSegmenter:
    """FastSurfer brain parcellation as a DL job backend (reference
    SubpartSegmentProcess segment.py:544 + apply_segment_threshold :734):
    conform -> 3-view CNN -> FreeSurfer-id labelmap resampled back to the
    image grid (nearest, like the reference's resample_from_to order=0).

    ``segment`` returns (labelmap int32, whole-brain mask); ``labelmap``
    rides in the probability slot so callers can split per-structure masks
    with :func:`structure_masks`."""

    WEIGHT_NAMES = ("fastsurfer_axial", "fastsurfer_coronal",
                    "fastsurfer_sagittal")

    def __init__(self, variables=None, allow_random_init: bool = False,
                 filters: int = 64, conform_size: Optional[int] = None,
                 device=DEFAULT_DEVICE):
        from invesalius3_tpu_torch.models import fastsurfer as fs

        self.device = resolve_device(device)
        self._fs = fs
        self.filters = filters
        self.conform_size = conform_size or fs.CONFORM_SIZE
        if variables is None:
            variables = self._resolve(allow_random_init)
        self.variables = variables  # {} -> random init (tests/smoke)

    def _resolve(self, allow_random_init: bool):
        """Per-view checkpoints (torch .pt or ONNX, reference model_info
        segment.py:576-613); all three or nothing."""
        try:
            from invesalius3_tpu_torch.net.download import get_weight_file

            out = {}
            for name, view in zip(self.WEIGHT_NAMES,
                                  ("axial", "coronal", "sagittal")):
                path = str(get_weight_file(name))
                loader = (self._fs.load_onnx_checkpoint
                          if path.endswith(".onnx")
                          else self._fs.load_torch_checkpoint)
                out[view] = loader(path)
            return out
        except Exception as e:
            if allow_random_init:
                warnings.warn(
                    f"FastSurfer subpart running with RANDOM weights ({e}); "
                    f"output is noise, not a parcellation",
                    RuntimeWarning, stacklevel=3)
                return {}
            raise WeightsUnavailableError(
                f"no FastSurfer checkpoints ({self.WEIGHT_NAMES}): {e}"
            ) from e

    def segment(self, image, probability_threshold: float = 0.5,
                batch_size: int = 8, progress_cb=None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(FreeSurfer-id labels int32, mask uint8 0/255) on the host.
        Traced, it is the span ``parcellate``: the pipeline's construction
        and weight load ``parcellate.build`` (with the count
        ``parcellate.weight_bytes``, the three networks' parameters and
        buffers once loaded), then the pipeline's spans
        (``FastSurferPipeline.run_tensor``), a resample back to the image
        grid ``parcellate.resample``, and the copy to the host
        ``parcellate.host_result``."""
        from invesalius3_tpu_torch.ops.resize import resize_volume

        img = np.asarray(image)
        with ilog.span("parcellate", shape=tuple(int(s) for s in img.shape),
                       batch=batch_size, conform=self.conform_size):
            with ilog.span("parcellate.build"):
                pipe = self._fs.FastSurferPipeline(
                    variables=self.variables or {}, batch_size=batch_size,
                    filters=self.filters, device=self.device)
                if ilog.root_span() is not None:  # traced: the bytes the networks moved
                    ilog.count("parcellate.weight_bytes",
                               sum(t.nbytes for m in pipe.models.values()
                                   for t in m.state_dict().values()))
            labels = pipe.run_tensor(img, conform_size=self.conform_size,
                                     return_freesurfer_ids=True, progress=progress_cb)
            if tuple(labels.shape) != img.shape:  # back to the image grid
                with ilog.span("parcellate.resample"):
                    labels = resize_volume(labels, img.shape, order=0)
            with ilog.span("parcellate.host_result") as host:
                mask = (labels > 0).to(torch.uint8) * 255  # whole-brain fallback
                out = labels.cpu().numpy(), mask.cpu().numpy()
                host.set(bytes=sum(a.nbytes for a in out))
            return out


def structure_masks(labelmap: np.ndarray, categories) -> list:
    """Per-structure binary masks for the selected LUT categories
    (reference apply_segment_threshold :744-917 pick_regions).  Returns
    [(name, mask uint8, label_id)]; empty structures are skipped like the
    reference.

    "subcortical" selects the LUT's Subcortical gray-matter structures
    (thalamus, caudate, hippocampus, ...); the reference pick_regions'
    broader "everything that's not cortical and not background" set
    (which also sweeps in ventricles/CSF/WM/cerebellum) is available as
    "non_cortical"."""
    from invesalius3_tpu_torch.models.fastsurfer import LUT_ROWS

    out = []
    for cat in categories:
        c = str(cat).lower().replace("-", "_").replace(" ", "_")
        for lid, name, category in LUT_ROWS:
            if lid == 0:
                continue
            if c == "non_cortical":
                match = not name.startswith("ctx-")
            elif c == "cortical":
                match = name.startswith("ctx-")
            else:
                match = category.lower() == c
            if not match:
                continue
            m = (labelmap == lid).astype(np.uint8) * 255
            if m.any():
                out.append((name.replace("-", "_"), m, lid))
    return out


SEGMENTERS = {
    "brain_mri_t1": BrainSegmenter,
    "trachea_ct": TracheaSegmenter,
    "mandible_jit_ct": MandibleSegmenter,
    "cranioplasty_implant": ImplantSegmenter,
    "fastsurfer_subpart": SubpartSegmenter,
}

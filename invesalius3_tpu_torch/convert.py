"""Numpy bridge: inputs onto a device, outputs back to the host, and the
JAX package's state carried over into the port's: its device mesh, the
slice viewer's volume, masks and ``Slice``, the app's surfaces and
project, and the 3D viewer's raycasting presets.

Most of the system runs no model; there its "weights" are its inputs and
the state one stage hands the next.  This module moves that state across,
so each port stage can be fed the JAX stage's exact input, and carries the
segmentation models' Flax variables and optax's Adam state over as the
port's state dicts.  It never imports jax: it
reads JAX objects through their attributes, and anything array-like goes
through ``np.asarray``.  Every bridge puts its tensors on the card unless
the caller passes ``device="cpu"``; the weight carriers return host tensors,
as a checkpoint read from disk is.
"""

from __future__ import annotations

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from invesalius3_tpu_torch.ops.marching import DeviceMesh


def to_device(array, device=DEFAULT_DEVICE) -> torch.Tensor:
    """A numpy (or array-like) volume, marker grid or table as a tensor on
    ``device``, dtype preserved.  A read-only array (a view of a JAX
    buffer) is copied, so the tensor never aliases memory it may not own."""
    device = resolve_device(device)
    a = np.ascontiguousarray(np.asarray(array))
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy()


def from_jax_mesh(jm, device=DEFAULT_DEVICE) -> DeviceMesh:
    """The port's ``DeviceMesh`` equal to a JAX ``marching.DeviceMesh``.

    The JAX mesh is sized to buckets: faces and corners past ``n_tris`` are
    padding, and when there is padding its slots (key -1) sort first and
    form one orphan vertex, id 0.  This drops the padding and the orphan
    and shifts every vertex id down by one in that case.  Corner ids
    m = c * T_pad + t become c * n_tris + t.
    """
    device = resolve_device(device)
    n_tris = int(jm.n_tris)
    n_verts = int(jm.n_verts)
    faces3t = np.asarray(jm.faces3t)
    T_pad = faces3t.shape[1]
    sorted_valid = np.asarray(jm.sorted_valid)
    shift = 0 if sorted_valid.size == 0 or sorted_valid[0] else 1
    n_pad_corners = 3 * (T_pad - n_tris)

    order = np.asarray(jm.order).astype(np.int64)[n_pad_corners:]
    order = (order // T_pad) * n_tris + order % T_pad
    gos = np.asarray(jm.group_of_sorted).astype(np.int64)[n_pad_corners:] - shift
    inverse = (np.asarray(jm.inverse).astype(np.int64).reshape(3, T_pad)
               [:, :n_tris].reshape(-1) - shift)
    return DeviceMesh(
        verts3v=to_device(np.asarray(jm.verts3v)[:, shift:n_verts], device),
        faces3t=to_device(faces3t[:, :n_tris].astype(np.int32) - shift, device),
        inverse=to_device(inverse, device),
        order=to_device(order, device),
        group_of_sorted=to_device(gos, device),
        spacing=tuple(jm.spacing), vol_shape=tuple(jm.vol_shape),
        origin_shift=tuple(jm.origin_shift))


# ---------------------------------------------------------------------------
# the slice viewer's state: a JAX Volume / Mask / Slice as the port's
# ---------------------------------------------------------------------------


def volume_from_jax(vol, device=DEFAULT_DEVICE):
    """The port's ``Volume`` equal to a JAX ``core.volume.Volume``: data via
    numpy onto ``device``, then spacing, affine, modality and window."""
    from invesalius3_tpu_torch.core.volume import Volume

    return Volume(data=to_device(vol.data, device), spacing=tuple(vol.spacing),
                  affine=None if vol.affine is None else np.array(vol.affine),
                  modality=vol.modality, window_width=vol.window_width,
                  window_level=vol.window_level)


def mask_from_jax(m, device=DEFAULT_DEVICE):
    """The port's ``Mask`` equal to a JAX ``core.mask.Mask``.

    Index, name, colour and the other metadata are carried over as they
    are: the process-wide mask counter (which decides a new mask's index
    and colour) is not advanced.  The undo/redo history is copied too."""
    from invesalius3_tpu_torch.core.mask import Mask

    device = resolve_device(device)
    out = Mask.restore(m.index, m.name)
    out.colour = tuple(m.colour)
    out.opacity = m.opacity
    out.threshold_range = tuple(m.threshold_range)
    out.edition_threshold_range = tuple(m.edition_threshold_range)
    out.is_shown = m.is_shown
    out.was_edited = m.was_edited
    out.derived_from = m.derived_from
    out.spacing = tuple(m.spacing)
    out.data = None if m.data is None else to_device(m.data, device)
    # entries are (orientation, index, before, after), snapshots in numpy
    copy = lambda entry: (*entry[:2], np.array(entry[2]), np.array(entry[3]))  # noqa: E731
    out.history.size = m.history.size
    out.history._undo.extend(copy(e) for e in m.history._undo)
    out.history._redo.extend(copy(e) for e in m.history._redo)
    return out


def slice_from_jax(slc, device=DEFAULT_DEVICE, bus=None):
    """The port's ``Slice`` in the state of a JAX ``core.slice.Slice``: the
    volume, the masks and the current mask, the window, projection type and
    slab count, the image versions and the colour overlay.  Sends no bus
    message."""
    from invesalius3_tpu_torch.core.geometry import Box
    from invesalius3_tpu_torch.core.slice import Slice

    device = resolve_device(device)
    out = Slice(bus=bus)
    data = slc.volume.data
    out.volume = volume_from_jax(slc.volume, device)
    out.window_width = slc.window_width
    out.window_level = slc.window_level
    out.projection_type = slc.projection_type
    out.n_slabs = slc.n_slabs
    out.masks = {i: mask_from_jax(m, device) for i, m in slc.masks.items()}
    cur = slc.current_mask
    if cur is not None:
        same = [i for i, m in slc.masks.items() if m is cur]
        out.current_mask = out.masks[same[0]] if same else mask_from_jax(cur, device)
    if hasattr(slc, "_image_versions"):
        # a version that is the volume's own array shares the port's tensor
        out._image_versions = [
            (lbl, out.volume.data if mat is data else to_device(mat, device))
            for lbl, mat in slc._image_versions]
        out.current_image_label = slc.current_image_label
    ov = getattr(slc, "_overlay_u8", None)
    out._overlay_u8 = None if ov is None else np.array(ov)
    lut = getattr(slc, "_overlay_lut", None)
    out._overlay_lut = None if lut is None else np.array(lut)
    box = getattr(slc, "crop_box", None)
    if box is not None:
        out.crop_box = Box(box.shape, box.spacing)
        out.crop_box.set_limits(*box.limits)
    return out


# ---------------------------------------------------------------------------
# the app's state: a JAX Surface / Project as the port's
# ---------------------------------------------------------------------------


def surface_from_jax(s):
    """The port's ``Surface`` equal to a JAX ``core.surface.Surface``.

    A JAX surface made from a marching mesh that padded holds the padding
    orphan at vertex id 0 (decimation keeps it; keep-largest drops it).
    When no face references vertex 0, it is dropped and every face id
    shifts down by one, as the port's own surfaces have no orphan.  Index,
    name and the other metadata are carried over without advancing the
    process-wide surface counter."""
    from invesalius3_tpu_torch.core.surface import Surface

    verts = np.array(s.vertices, np.float32)
    faces = np.array(s.faces, np.int32)
    if len(verts) and not (faces == 0).any():
        verts, faces = verts[1:], faces - 1
    out = Surface(vertices=verts, faces=faces, index=s.index, name=s.name,
                  colour=tuple(s.colour), transparency=s.transparency,
                  volume=s.volume, area=s.area, is_shown=s.is_shown,
                  category=s.category)
    if hasattr(s, "filled_holes"):
        out.filled_holes = s.filled_holes
    return out


def project_from_jax(p, device=DEFAULT_DEVICE):
    """The port's ``Project`` in the state of a JAX ``core.project.Project``:
    metadata, the volume, masks (``mask_from_jax``), surfaces
    (``surface_from_jax``), measurements and image versions, on ``device``
    (the card unless "cpu")."""
    import copy

    from invesalius3_tpu_torch.core.project import Project

    device = resolve_device(device)
    out = Project()
    for attr in ("name", "modality", "original_orientation", "window", "level",
                 "compress"):
        setattr(out, attr, getattr(p, attr))
    out.threshold_range = tuple(p.threshold_range)
    out.image_fiducials = np.array(p.image_fiducials)
    out.measurement_dict = copy.deepcopy(p.measurement_dict)
    data = None
    if p.volume is not None:
        out.volume = volume_from_jax(p.volume, device)
        data = p.volume.data
    out.mask_dict = {i: mask_from_jax(m, device) for i, m in p.mask_dict.items()}
    out.surface_dict = {i: surface_from_jax(s) for i, s in p.surface_dict.items()}
    # a version that is the volume's own array shares the port's tensor
    out.image_versions = [
        (lbl, out.volume.data if mat is data else to_device(mat, device))
        for lbl, mat in p.image_versions]
    return out


# ---------------------------------------------------------------------------
# the 3D viewer's state: a JAX RaycastPreset as the port's
# ---------------------------------------------------------------------------


def preset_from_jax(p):
    """The port's ``RaycastPreset`` with the fields of a JAX
    ``ops.raycast.RaycastPreset`` (host data: no device)."""
    import dataclasses

    from invesalius3_tpu_torch.ops.raycast import RaycastPreset

    out = RaycastPreset(**{f.name: getattr(p, f.name)
                           for f in dataclasses.fields(RaycastPreset)})
    out.rgba = np.array(out.rgba, np.float32)
    out.background = tuple(out.background)
    return out


# ---------------------------------------------------------------------------
# the segmentation models' weights: Flax {params, batch_stats} as the
# port's state dicts, each the exact inverse of the JAX package's
# convert_torch_state_dict
# ---------------------------------------------------------------------------


def _t(a, axes=None) -> torch.Tensor:
    a = np.asarray(a)
    return torch.tensor(a if axes is None else a.transpose(axes)).contiguous()


def _conv(state, name, p, axes) -> None:
    """A Flax conv's kernel (axes moved to torch's order) and bias."""
    state[f"{name}.weight"] = _t(p["kernel"], axes)
    if "bias" in p:
        state[f"{name}.bias"] = _t(p["bias"])


def _norm(state, name, p, stats) -> None:
    """A Flax batch norm's scale, bias, mean and var under torch's names
    (the running statistics only where ``stats`` is given)."""
    state[f"{name}.weight"] = _t(p["scale"])
    state[f"{name}.bias"] = _t(p["bias"])
    if stats is not None:
        state[f"{name}.running_mean"] = _t(stats["mean"])
        state[f"{name}.running_var"] = _t(stats["var"])


def _stats(variables, *path):
    """The ``batch_stats`` entry at ``path``, None for a parameter tree
    alone (variables without ``batch_stats``)."""
    node = variables.get("batch_stats")
    for key in path:
        if node is None:
            return None
        node = node[key]
    return node


_UNET3D_ALIAS = {"encoder1": "enc1", "encoder2": "enc2", "encoder3": "enc3",
                 "encoder4": "enc4", "bottleneck": "bottleneck", "decoder1": "dec4",
                 "decoder2": "dec4", "decoder3": "dec4", "decoder4": "dec4"}


def unet3d_from_jax(variables) -> dict:
    """The port's ``Unet3D`` state dict (the reference torch names, the
    decoders' inner layers ``dec4_*``) of the JAX ``Unet3D``'s variables.
    Flax kernels (kd, kh, kw, in, out) become Conv3d (out, in, kd, kh, kw);
    ``transpose_kernel`` ConvTranspose kernels (kd, kh, kw, out, in) become
    ConvTranspose3d (in, out, kd, kh, kw).  Without ``batch_stats`` it
    carries the parameters alone."""
    params = variables["params"]
    axes = (4, 3, 0, 1, 2)
    state = {}
    for block, alias in _UNET3D_ALIAS.items():
        for i in (1, 2):
            _conv(state, f"{block}.{alias}_conv{i}", params[block][f"conv{i}"], axes)
            _norm(state, f"{block}.{alias}_norm{i}", params[block][f"norm{i}"],
                  _stats(variables, block, f"norm{i}"))
    for name in ("upconv4", "upconv3", "upconv2", "upconv1", "conv"):
        _conv(state, name, params[name], axes)
    return state


def unet2d_from_jax(variables) -> dict:
    """The port's ``Unet2D`` state dict of the JAX ``Unet2D``'s variables:
    kernels (kh, kw, in, out) -> (out, in, kh, kw), transpose kernels
    (kh, kw, out, in) -> (in, out, kh, kw)."""
    params = variables["params"]
    state = {}
    for b in ("enc1", "enc2", "enc3", "dec2", "dec1"):
        _conv(state, f"{b}_conv", params[f"{b}_conv"], (3, 2, 0, 1))
        _norm(state, f"{b}_norm", params[f"{b}_norm"], _stats(variables, f"{b}_norm"))
    for name in ("upconv2", "upconv1", "conv"):
        _conv(state, name, params[name], (3, 2, 0, 1))
    return state


def fastsurfer_from_jax(variables) -> dict:
    """The port's ``FastSurferCNN`` state dict of the JAX model's variables:
    ``<block>.conv{i}`` (bias-free), ``<block>.bn{i}``, ``<block>.prelu{i}``
    (a slope of shape (1,)) and ``classifier``."""
    params = variables["params"]
    state = {}
    _conv(state, "classifier", params["classifier"], (3, 2, 0, 1))
    for block, layers in params.items():
        if block == "classifier":
            continue
        for layer, p in layers.items():
            name = f"{block}.{layer}"
            if layer.startswith("conv"):
                _conv(state, name, p, (3, 2, 0, 1))
            elif layer.startswith("prelu"):
                state[f"{name}.weight"] = _t(p["negative_slope"]).reshape(1)
            else:
                _norm(state, name, p, _stats(variables, block, layer))
    return state


def adam_state_from_jax(opt_state, model) -> dict:
    """The port's Adam state (``models/train.Adam.load_state_dict``) of
    ``optax.adam``'s state for the parameters of ``model``'s JAX
    counterpart: ``count``, and the first and second moments ``mu`` and
    ``nu`` carried as the parameters are (a ``Unet3D``, ``Unet2D`` or
    ``FastSurferCNN``) and listed in ``model.parameters()`` order."""
    from invesalius3_tpu_torch.models.fastsurfer import FastSurferCNN
    from invesalius3_tpu_torch.models.unet2d import Unet2D
    from invesalius3_tpu_torch.models.unet3d import Unet3D

    adam = opt_state[0]  # ScaleByAdamState, then scale_by_learning_rate's empty state
    carry = {Unet3D: unet3d_from_jax, Unet2D: unet2d_from_jax,
             FastSurferCNN: fastsurfer_from_jax}[type(model)]
    names = [name for name, _ in model.named_parameters()]
    mu, nu = carry({"params": adam.mu}), carry({"params": adam.nu})
    return {"count": int(np.asarray(adam.count)), "mu": [mu[k] for k in names],
            "nu": [nu[k] for k in names]}

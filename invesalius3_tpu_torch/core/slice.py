"""Slice: the volume facade of the 2D viewer — windowing, slab projections,
the rendered frame, masks, crop and image versions (port of
invesalius3_tpu/core/slice.py).

The frame path: ``get_rendered_slice`` picks a slab (a view of the volume
on its device), projects it (``ops/projections``: LMIP and MIDA through the
CUDA ray kernels on the card), maps WW/WL to RGB on the device, and copies
only the RGB plane to the host.  The mask and colour overlays and the
canvas drawing then run as the same numpy code as in the JAX package, so
the bytes are identical.

Surface creation runs on the mask's device (``core/surface.py``).  Not
ported yet (they need modules the port does not have): ``calc_mask_area``,
``apply_image_filter`` and ``apply_reorientation``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.core.mask import Mask
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.ops import projections, threshold as thr_ops
from invesalius3_tpu_torch.ops.windowing import apply_ww_wl_rgb

_CONTOUR_TMIP = {
    const.PROJECTION_CONTOUR_MIP: 0,
    const.PROJECTION_CONTOUR_LMIP: 1,
    const.PROJECTION_CONTOUR_MIDA: 2,
}


class Slice:
    def __init__(self, volume: Optional[Volume] = None,
                 bus: Optional[events.Publisher] = None):
        self.volume: Optional[Volume] = volume
        self.masks: Dict[int, Mask] = {}
        self.current_mask: Optional[Mask] = None
        self.window_width: float = 255.0
        self.window_level: float = 127.5
        self.projection_type: int = const.PROJECTION_NORMAL
        self.n_slabs: int = 1
        self.bus = bus or events.bus
        if volume is not None:
            self.set_volume(volume)

    # -- volume ---------------------------------------------------------------
    def set_volume(self, volume: Volume) -> None:
        self.volume = volume
        self.window_width = volume.window_width
        self.window_level = volume.window_level
        self.bus.send_message("slice.volume_set", shape=volume.shape)

    def load_new_volume(self, volume: Volume) -> None:
        """Replace the study: new volume, masks/versions/overlays dropped."""
        self.set_volume(volume)
        self.masks = {}
        self.current_mask = None
        self._image_versions = [("original", volume.data)]
        self.current_image_label = "original"
        self.clear_color_overlay()
        self.projection_type = const.PROJECTION_NORMAL
        self.bus.send_message("slice.study_replaced", shape=volume.shape)

    @property
    def matrix(self) -> torch.Tensor:
        return self.volume.data

    @property
    def spacing(self):
        return self.volume.spacing

    def set_window(self, ww: float, wl: float) -> None:
        self.window_width = ww
        self.window_level = wl
        self.bus.send_message("slice.window_changed", ww=ww, wl=wl)

    # -- slab projections -------------------------------------------------------
    def project(self, orientation: str, slice_number: int,
                number_slices: int = 1, inverted: bool = False,
                border_size: float = 1.0, projection: Optional[int] = None,
                window_level: Optional[float] = None,
                plain: bool = False) -> torch.Tensor:
        """The projected plane as a tensor on the volume's device.
        ``plain=True`` walks LMIP/MIDA rays through the kernels' plain
        PyTorch versions (to hold the kernels against them)."""
        axis = const.ORIENTATION_AXIS[orientation]
        proj = self.projection_type if projection is None else projection
        if proj == const.PROJECTION_NORMAL:
            number_slices = 1
        lo = slice_number
        hi = min(slice_number + number_slices, self.matrix.shape[axis])
        slab = self.matrix.narrow(axis, lo, hi - lo)
        if inverted:
            slab = torch.flip(slab, dims=(axis,))

        wl = self.window_level if window_level is None else window_level
        if proj == const.PROJECTION_MaxIP:
            return projections.maxip(slab, axis)
        if proj == const.PROJECTION_MinIP:
            return projections.minip(slab, axis)
        if proj == const.PROJECTION_MeanIP:
            return projections.meanip(slab, axis)
        if proj == const.PROJECTION_LMIP:
            # quirk preserved: the reference passes wl for both bounds
            return projections.lmip(slab, axis, wl, wl, plain=plain)
        if proj == const.PROJECTION_MIDA:
            return projections.mida(slab, axis, wl, wl, plain=plain)
        if proj in _CONTOUR_TMIP:
            return projections.fast_contour_mip(slab, border_size, axis, wl, wl,
                                                _CONTOUR_TMIP[proj], plain=plain)
        return slab.select(axis, 0)  # PROJECTION_NORMAL and unknown ids

    def get_image_slice(self, orientation: str, slice_number: int,
                        number_slices: int = 1, inverted: bool = False,
                        border_size: float = 1.0,
                        projection: Optional[int] = None,
                        window_level: Optional[float] = None,
                        plain: bool = False) -> np.ndarray:
        """The projected plane on the host (reference get_image_slice)."""
        return self.project(orientation, slice_number, number_slices,
                            inverted, border_size, projection, window_level,
                            plain).cpu().numpy()

    def get_rendered_slice(self, orientation: str, slice_number: int,
                           ww: Optional[float] = None,
                           wl: Optional[float] = None,
                           projection: Optional[int] = None,
                           slabs: Optional[int] = None,
                           measures=None, crop_box=None, cross=None,
                           ruler: bool = False,
                           orientation_labels: bool = False, **kw) -> np.ndarray:
        """WW/WL-mapped RGB of a slice with its overlays: the 2D viewer's
        per-frame path.  The overrides are request-local; ``kw`` goes to
        ``project`` (``inverted``, ``border_size``, ``plain``)."""
        ww = self.window_width if ww is None else ww
        wl = self.window_level if wl is None else wl
        img = self.project(
            orientation, slice_number, self.n_slabs if slabs is None else slabs,
            projection=projection, window_level=wl, **kw)
        return self.render_image(img, orientation, slice_number, ww, wl,
                                 measures=measures, crop_box=crop_box,
                                 cross=cross, ruler=ruler,
                                 orientation_labels=orientation_labels)

    def render_image(self, img: torch.Tensor, orientation: str,
                     slice_number: int, ww: float, wl: float, measures=None,
                     crop_box=None, cross=None, ruler: bool = False,
                     orientation_labels: bool = False) -> np.ndarray:
        """The frame's RGB from a projected plane: WW/WL on the plane's
        device, then the mask overlay, the colour overlay and the canvas
        layers on the host."""
        rgb = apply_ww_wl_rgb(img, ww, wl).cpu().numpy()
        if self.current_mask is not None and self.current_mask.is_shown:
            m = self.get_mask_slice(orientation, slice_number)
            colour = np.array(self.current_mask.colour) * 255
            vis = m >= const.MASK_VISIBLE_MIN
            op = self.current_mask.opacity
            rgb = rgb.astype(np.float32)
            rgb[vis] = rgb[vis] * (1 - op) + colour * op
            rgb = rgb.astype(np.uint8)
        rgb = self._composite_color_overlay(rgb, orientation, slice_number)
        if (measures is not None or crop_box is not None or cross is not None
                or ruler or orientation_labels):
            from invesalius3_tpu_torch.core import canvas

            if crop_box is not None:
                canvas.draw_crop_box(rgb, crop_box, orientation, slice_number)
            if measures is not None:
                items = getattr(measures, "measures", None)
                items = items.values() if items is not None else measures
                for m in items:
                    canvas.draw_measure(rgb, m, orientation, slice_number,
                                        self.spacing)
            if ruler:
                sx, sy, sz = self.spacing
                # pixel pitch of the rendered row axis for this orientation
                px_per_mm = 1.0 / {"AXIAL": sy, "CORONAL": sz,
                                   "SAGITAL": sz}.get(orientation, sy)
                canvas.draw_ruler(rgb, px_per_mm)
            if orientation_labels:
                canvas.draw_orientation_labels(rgb, orientation)
            if cross is not None:
                canvas.draw_cross(rgb, cross)
        return rgb

    def get_mask_slice(self, orientation: str, slice_number: int) -> np.ndarray:
        ax = const.ORIENTATION_AXIS[orientation]
        return self.current_mask.data.select(ax, slice_number).cpu().numpy()

    # -- color overlays (fMRI activation etc.) -----------------------------------
    def set_color_overlay(self, data, colormap: str = "autumn",
                          alpha: float = 0.6) -> None:
        """Colormapped auxiliary volume composited onto every slice (the
        fMRI-support flow): normalised to uint8, a matplotlib colormap, the
        value that the original zero maps to transparent."""
        if isinstance(data, torch.Tensor):
            data = data.cpu().numpy()
        arr = np.asarray(data, np.float32)
        if arr.shape != tuple(self.matrix.shape):
            raise ValueError(
                f"overlay shape {arr.shape} does not match the structural "
                f"volume {tuple(self.matrix.shape)}")
        lo, hi = float(arr.min()), float(arr.max())
        scale = (hi - lo) or 1.0
        u8 = ((arr - lo) / scale * 255.0).astype(np.uint8)
        zero_value = int((0.0 - lo) / scale * 255.0) if lo <= 0.0 <= hi else None
        try:
            import matplotlib

            cmap = matplotlib.colormaps[colormap]
            lut = (cmap(np.arange(256) / 255.0) * 255.0).astype(np.float32)
        except Exception:  # headless fallback: black->red->yellow ramp
            t = np.arange(256, dtype=np.float32) / 255.0
            lut = np.stack([np.clip(2 * t, 0, 1) * 255.0,
                            np.clip(2 * t - 1, 0, 1) * 255.0,
                            np.zeros(256, np.float32),
                            np.full(256, 255.0)], axis=1)
        lut[:, 3] = alpha * 255.0
        if zero_value is not None:
            lut[zero_value, 3] = 0.0  # background transparent
        self._overlay_u8 = u8
        self._overlay_lut = lut
        self.bus.send_message("slice.overlay_set", colormap=colormap)

    def clear_color_overlay(self) -> None:
        self._overlay_u8 = None
        self._overlay_lut = None
        self.bus.send_message("slice.overlay_cleared")

    def _composite_color_overlay(self, rgb, orientation, slice_number):
        ov = getattr(self, "_overlay_u8", None)
        if ov is None:
            return rgb
        ax = const.ORIENTATION_AXIS[orientation]
        sl = np.take(ov, slice_number, axis=ax)
        rgba = self._overlay_lut[sl]  # (H, W, 4)
        a = rgba[..., 3:4] / 255.0
        out = rgb.astype(np.float32) * (1 - a) + rgba[..., :3] * a
        return out.astype(np.uint8)

    # -- masks ------------------------------------------------------------------
    def create_new_mask(self, name: str = "",
                        threshold_range: Optional[Tuple[float, float]] = None,
                        apply_threshold: bool = True, show: bool = True) -> Mask:
        """Reference Slice.create_new_mask :1578."""
        m = Mask(shape=self.matrix.shape, name=name, device=self.matrix.device)
        m.spacing = self.spacing
        if threshold_range is not None:
            m.threshold_range = threshold_range
        if apply_threshold:
            tmin, tmax = m.threshold_range
            m.data = thr_ops.threshold_new_mask(self.matrix, tmin, tmax)
        self.masks[m.index] = m
        if show or self.current_mask is None:
            self.current_mask = m
        self.bus.send_message("slice.mask_added", index=m.index, name=m.name)
        return m

    def select_mask(self, index: int) -> None:
        self.current_mask = self.masks[index]
        self.bus.send_message("slice.mask_selected", index=index)

    def remove_mask(self, index: int) -> None:
        self.masks.pop(index, None)
        if self.current_mask is not None and self.current_mask.index == index:
            self.current_mask = next(iter(self.masks.values()), None)
        self.bus.send_message("slice.mask_removed", index=index)

    def set_mask_threshold(self, tmin: float, tmax: float,
                           mask: Optional[Mask] = None) -> None:
        """Reference SetMaskThreshold :1225 + do_threshold_to_all_slices."""
        mask = mask or self.current_mask
        mask.threshold_range = (tmin, tmax)
        mask.apply(thr_ops.threshold_mask(self.matrix, mask.data, tmin, tmax))
        self.bus.send_message("slice.mask_thresholded", index=mask.index,
                              threshold=(tmin, tmax))

    # -- surface creation (reference CreateSurfaceFromIndex :1338) ---------------
    def create_surface_from_mask(self, mask: Optional[Mask] = None, **options):
        """``core.surface.create_surface_from_mask`` of ``mask`` (the current
        mask by default) at the volume's spacing, on the mask's device."""
        from invesalius3_tpu_torch.core.surface import create_surface_from_mask

        mask = mask or self.current_mask
        return create_surface_from_mask(mask, self.spacing, **options)

    # -- mask statistics (reference slice_.py:2283) -------------------------------
    def calc_image_density(self, mask: Optional[Mask] = None):
        """(min, max, mean, std) of the image's non-NaN voxels under the
        visible mask, in float32 on the volume's device, std with ddof 0 as
        ``jnp.nanstd``; an empty mask gives (0, 0, 0, 0), a mask over NaN
        alone four NaNs."""
        mask = mask or self.current_mask
        sel = self.matrix[mask.visible_array()].to(torch.float32)
        if sel.numel() == 0:
            return 0, 0, 0, 0
        sel = sel[~torch.isnan(sel)]
        if sel.numel() == 0:
            return (float("nan"),) * 4
        return (float(sel.min()), float(sel.max()), float(sel.mean()),
                float(sel.std(correction=0)))

    def do_boolean_op(self, op: int, index1: int, index2: int) -> Mask:
        """Combine two masks into a new one: union / diff / intersection /
        xor over the visible (>= 127) voxels, written as 0/255."""
        from invesalius3_tpu_torch.utils.helpers import next_copy_name

        m1, m2 = self.masks[index1], self.masks[index2]
        a, b = m1.visible_array(), m2.visible_array()
        if op == const.BOOLEAN_UNION:
            r = a | b
        elif op == const.BOOLEAN_DIFF:
            r = a & ~b
        elif op == const.BOOLEAN_AND:
            r = a & b
        elif op == const.BOOLEAN_XOR:
            r = a ^ b
        else:
            raise ValueError(f"unknown boolean op {op!r}")

        name = f"{const.BOOLEAN_OP_NAMES[op]}_{m1.name}_{m2.name}"
        existing = [m.name for m in self.masks.values()]
        out = Mask(device=self.matrix.device)
        out.name = next_copy_name(name, existing)
        out.spacing = self.spacing
        out.data = r.to(torch.uint8) * const.MASK_THRESHOLD_IN
        out.was_edited = True
        self.masks[out.index] = out
        self.current_mask = out
        self.bus.send_message("slice.mask_added", index=out.index, name=out.name)
        return out

    # -- crop box -----------------------------------------------------------------
    def create_crop_box(self):
        """A full-volume crop Box sized/spaced to the current volume."""
        from invesalius3_tpu_torch.core.geometry import Box

        self.crop_box = Box(self.matrix.shape, self.spacing)
        return self.crop_box

    def apply_crop(self, box=None, mask: Optional[Mask] = None) -> None:
        """Zero every mask voxel outside the box (undo-recorded)."""
        from invesalius3_tpu_torch.ops.morphology import crop_mask

        box = box or getattr(self, "crop_box", None)
        if box is None:
            box = self.create_crop_box()
        mask = mask or self.current_mask
        mask.apply(crop_mask(mask.data, box.limits))
        self.bus.send_message("slice.mask_cropped", index=mask.index,
                              limits=box.limits)

    # -- mask import (reference control.py:264 OnImportMaskNifti) ----------------
    def import_mask_from_nifti(self, path, name: str = "") -> Mask:
        """A NIfTI label map as a new mask (voxels > 0 become 255) on the
        volume's device.  Volume and mask both go through the same RAS
        canonicalisation, so their orientations agree."""
        from invesalius3_tpu_torch.convert import to_device
        from invesalius3_tpu_torch.io.nifti import read_nifti

        img = read_nifti(path)
        if tuple(img.data.shape) != tuple(self.matrix.shape):
            raise ValueError(
                f"mask shape {img.data.shape} does not match volume "
                f"{tuple(self.matrix.shape)}")
        m = Mask(name=name or Path(str(path)).name.split(".")[0])
        m.spacing = self.spacing
        m.threshold_range = (0, 255)
        labels = to_device(img.data, self.matrix.device)
        m.data = (labels > 0).to(torch.uint8) * const.MASK_THRESHOLD_IN
        m.was_edited = True
        self.masks[m.index] = m
        self.current_mask = m
        self.bus.send_message("slice.mask_added", index=m.index, name=m.name)
        return m

    # -- image versions -------------------------------------------------------------
    @property
    def image_versions(self):
        """[(label, (Z,Y,X) tensor)] — [0] is always the unfiltered original."""
        if not hasattr(self, "_image_versions"):
            self._image_versions = [("original", self.volume.data)]
            self.current_image_label = "original"
        return self._image_versions

    def select_image_version(self, label: str) -> None:
        """Swap the active volume to a stored version; re-threshold the
        current mask against it unless manually edited."""
        for lbl, mat in self.image_versions:
            if lbl == label:
                self.volume = self.volume.replace(data=mat)
                self.current_image_label = label
                if self.current_mask is not None and not self.current_mask.was_edited:
                    tmin, tmax = self.current_mask.threshold_range
                    self.current_mask.data = thr_ops.threshold_new_mask(
                        self.matrix, tmin, tmax)
                self.bus.send_message("slice.image_version_selected", label=label)
                return
        raise KeyError(f"no image version {label!r}")

    # -- reorientation ----------------------------------------------------------------
    def flip_volume(self, axis: int) -> None:
        """Flip image + every version along `axis`; masks are re-evaluated
        from their thresholds."""
        self.volume = self.volume.replace(data=torch.flip(self.matrix, dims=(axis,)))
        if hasattr(self, "_image_versions"):
            self._image_versions = [
                (lbl, torch.flip(mat, dims=(axis,))) for lbl, mat in self._image_versions]
        self._invalidate_masks()
        self.bus.send_message("slice.volume_flipped", axis=axis)

    def swap_volume_axes(self, axis0: int, axis1: int) -> None:
        """Swap two volume axes, permuting spacing (spacing is (sx, sy, sz)
        X-first while the matrix is (Z, Y, X)).  The swapped volume is made
        contiguous, as JAX materialises it."""
        sx, sy, sz = self.spacing
        spacing_map = {  # matrix-axis pair -> new (sx, sy, sz)
            (2, 1): (sy, sx, sz), (1, 2): (sy, sx, sz),
            (2, 0): (sz, sy, sx), (0, 2): (sz, sy, sx),
            (1, 0): (sx, sz, sy), (0, 1): (sx, sz, sy),
        }
        new_spacing = spacing_map[(axis0, axis1)]
        self.volume = self.volume.replace(
            data=self.matrix.transpose(axis0, axis1).contiguous(),
            spacing=new_spacing)
        if hasattr(self, "_image_versions"):
            self._image_versions = [
                (lbl, mat.transpose(axis0, axis1).contiguous())
                for lbl, mat in self._image_versions]
        self._invalidate_masks(new_shape=self.matrix.shape)
        self.bus.send_message("slice.volume_axes_swapped", axes=(axis0, axis1))

    def _invalidate_masks(self, new_shape=None) -> None:
        for m in self.masks.values():
            m.spacing = self.spacing
            m.history.clear()
            tmin, tmax = m.threshold_range
            m.data = thr_ops.threshold_new_mask(self.matrix, tmin, tmax)
            m.was_edited = False

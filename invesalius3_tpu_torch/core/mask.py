"""Mask domain object: uint8 label volume + edition history + serialization
(port of invesalius3_tpu/core/mask.py).

The mask is a borderless (Z, Y, X) uint8 tensor on the volume's device.
The port never writes into a mask's tensor in place: every edit makes a
new tensor, as the JAX package's immutable arrays do, so masks that share
data (``duplicate``) stay independent.  Undo snapshots live on the host as
numpy arrays, as in the JAX package.
"""

from __future__ import annotations

import plistlib
from collections import deque
from typing import Deque, Optional, Tuple

import numpy as np
import torch

from invesalius3_tpu_torch import constants as const
from invesalius3_tpu_torch.device import DEFAULT_DEVICE, resolve_device

MASK_COLOURS = [
    (0.33, 1.0, 0.33),
    (1.0, 0.33, 0.33),
    (0.33, 0.33, 1.0),
    (1.0, 1.0, 0.33),
    (0.33, 1.0, 1.0),
    (1.0, 0.33, 1.0),
]


class EditionHistory:
    """Undo/redo ring (reference mask.py:78-204, size 50)."""

    def __init__(self, size: int = const.MASK_HISTORY_SIZE):
        self.size = size
        self._undo: Deque = deque(maxlen=size)
        self._redo: list = []

    def add(self, orientation: str, index: int, before: np.ndarray, after: np.ndarray) -> None:
        self._undo.append((orientation, index, np.array(before), np.array(after)))
        self._redo.clear()

    def undo(self) -> Optional[Tuple[str, int, np.ndarray]]:
        if not self._undo:
            return None
        orientation, index, before, after = self._undo.pop()
        self._redo.append((orientation, index, before, after))
        return orientation, index, before

    def redo(self) -> Optional[Tuple[str, int, np.ndarray]]:
        if not self._redo:
            return None
        orientation, index, before, after = self._redo.pop()
        self._undo.append((orientation, index, before, after))
        return orientation, index, after

    def clear(self) -> None:
        self._undo.clear()
        self._redo.clear()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class Mask:
    # process-wide counter: decides each new mask's index and colour
    general_index = -1

    def __init__(self, shape=None, index: Optional[int] = None, name: str = "",
                 device=DEFAULT_DEVICE):
        """An empty mask; with ``shape``, zeros on ``device`` (the card
        unless "cpu"; without a shape no tensor is made)."""
        data = None if shape is None else torch.zeros(
            tuple(shape), dtype=torch.uint8, device=resolve_device(device))
        Mask.general_index += 1
        self._set_defaults(Mask.general_index if index is None else index, name)
        self.data = data

    def _set_defaults(self, index: int, name: str) -> None:
        self.index = index
        self.name = name or f"Mask {self.index + 1}"
        self.colour = MASK_COLOURS[self.index % len(MASK_COLOURS)]
        self.opacity = 0.4
        self.threshold_range: Tuple[float, float] = (const.THRESHOLD_PRESETS_CT["Bone"])
        self.edition_threshold_range: Tuple[float, float] = (127, 255)
        self.is_shown = True
        self.was_edited = False
        self.derived_from = "Original"
        self.spacing = (1.0, 1.0, 1.0)
        self.history = EditionHistory()
        self.data: Optional[torch.Tensor] = None

    @classmethod
    def restore(cls, index: int, name: str) -> "Mask":
        """A mask with the given index and the defaults, without advancing
        the process-wide counter (for carrying a mask over from elsewhere)."""
        m = cls.__new__(cls)
        m._set_defaults(index, name)
        return m

    # -- edits ----------------------------------------------------------------
    def apply(self, new_data: torch.Tensor, orientation: str = "VOLUME", index: int = 0) -> None:
        """Replace mask data, recording undo history."""
        before = _host(self.data) if self.data is not None else None
        self.data = new_data
        if before is not None:
            if orientation == "VOLUME":
                self.history.add(orientation, index, before, _host(new_data))
            else:
                ax = const.ORIENTATION_AXIS[orientation]
                self.history.add(orientation, index,
                                 np.take(before, index, axis=ax),
                                 np.take(_host(new_data), index, axis=ax))
        self.was_edited = True

    def _from_host(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(array)).to(self.data.device)

    def _put_slice(self, orientation: str, index: int, plane: np.ndarray) -> None:
        idx = [slice(None)] * 3
        idx[const.ORIENTATION_AXIS[orientation]] = index
        data = self.data.clone()
        data[tuple(idx)] = self._from_host(plane)
        self.data = data

    def undo(self) -> bool:
        item = self.history.undo()
        if item is None:
            return False
        orientation, index, before = item
        if orientation == "VOLUME":
            self.data = self._from_host(before)
        else:
            self._put_slice(orientation, index, before)
        return True

    def redo(self) -> bool:
        item = self.history.redo()
        if item is None:
            return False
        orientation, index, after = item
        if orientation == "VOLUME":
            self.data = self._from_host(after)
        else:
            self._put_slice(orientation, index, after)
        return True

    def clear_history(self) -> None:
        self.history.clear()

    # -- ops ------------------------------------------------------------------
    def fill_holes_auto(self, size: int, conn: int = 6) -> None:
        """Fill the background components of at most ``size`` voxels with
        254, undo-recorded (reference mask.py:519 fill_holes_auto)."""
        from invesalius3_tpu_torch.ops.connected import fill_holes_automatically

        self.apply(fill_holes_automatically(self.data, size, conn))

    def visible_array(self) -> torch.Tensor:
        return self.data >= const.MASK_VISIBLE_MIN

    def duplicate(self, existing_names=()) -> "Mask":
        from invesalius3_tpu_torch.utils.helpers import next_copy_name

        m = Mask()
        m.name = next_copy_name(self.name, list(existing_names))
        m.colour = self.colour
        m.opacity = self.opacity
        m.threshold_range = self.threshold_range
        m.edition_threshold_range = self.edition_threshold_range
        m.is_shown = self.is_shown
        m.was_edited = self.was_edited
        m.spacing = self.spacing
        m.data = self.data
        return m

    # -- .inv3-compatible serialization ----------------------------------------
    def to_bordered_matrix(self) -> np.ndarray:
        """On-disk layout: shape + 1 border; border flags set to 1 meaning
        'computed' (reference mask.py:422-431 convention)."""
        data = _host(self.data)
        out = np.zeros(tuple(s + 1 for s in data.shape), np.uint8)
        out[1:, 1:, 1:] = data
        out[0, 0, 0] = 1
        out[1:, 0, 0] = 1  # per-slice computed flags
        return out

    @staticmethod
    def from_bordered_matrix(mat: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(mat[1:, 1:, 1:])

    def save_plist(self, datfile_name: str) -> bytes:
        info = {
            "index": self.index,
            "name": self.name,
            "colour": list(self.colour),
            "opacity": self.opacity,
            "threshold_range": list(self.threshold_range),
            "edition_threshold_range": list(self.edition_threshold_range),
            "visible": self.is_shown,
            "mask_file": datfile_name,
            "mask_shape": [int(s) + 1 for s in self.data.shape],
            "edited": self.was_edited,
            "derived_from": self.derived_from,
        }
        return plistlib.dumps(info)

    @classmethod
    def load_plist(cls, plist_bytes: bytes, dat_bytes: bytes,
                   device=DEFAULT_DEVICE) -> "Mask":
        """A mask read from its plist and bordered .dat bytes, its data on
        ``device`` (the card unless "cpu")."""
        device = resolve_device(device)
        info = plistlib.loads(plist_bytes)
        m = cls(index=info["index"], name=info["name"])
        m.colour = tuple(info["colour"])
        m.opacity = info["opacity"]
        m.threshold_range = tuple(info["threshold_range"])
        m.edition_threshold_range = tuple(info.get("edition_threshold_range", (127, 255)))
        m.is_shown = info["visible"]
        m.was_edited = info.get("edited", False)
        m.derived_from = info.get("derived_from", "Original")
        shape = tuple(int(s) for s in info["mask_shape"])
        mat = np.frombuffer(dat_bytes, np.uint8).reshape(shape)
        m.data = torch.from_numpy(cls.from_bordered_matrix(mat)).to(device)
        return m

"""Interaction-style state machine (port of invesalius3_tpu/core/styles.py).

Reference: invesalius/style.py ``StyleStateManager`` :67 — every mouse
tool is a state constant with a level; enabling a higher-level state
pushes it, disabling pops back to the highest remaining level.  The GUI is
gone but the state machine governs which kernel a pointer event maps to
(and the remote-control protocol drives it over the bus).
"""

from __future__ import annotations

from typing import Dict, List

from invesalius3_tpu_torch import events

# tool states (semantics of reference constants.py:649-680)
STATE_DEFAULT = "default"
STATE_ZOOM = "zoom"
STATE_PAN = "pan"
STATE_SPIN = "spin"
STATE_WL = "window_level"
STATE_MEASURE_DISTANCE = "measure_distance"
STATE_MEASURE_ANGLE = "measure_angle"
STATE_MEASURE_DENSITY_ELLIPSE = "measure_density_ellipse"
STATE_MEASURE_DENSITY_POLYGON = "measure_density_polygon"
SLICE_STATE_CROSS = "cross"
SLICE_STATE_SCROLL = "scroll"
SLICE_STATE_EDITOR = "editor"
SLICE_STATE_WATERSHED = "watershed"
SLICE_STATE_REORIENT = "reorient"
SLICE_STATE_MASK_FFILL = "mask_ffill"
SLICE_STATE_REMOVE_MASK_PARTS = "remove_mask_parts"
SLICE_STATE_SELECT_MASK_PARTS = "select_mask_parts"
SLICE_STATE_FFILL_SEGMENTATION = "ffill_segmentation"
SLICE_STATE_CROP_MASK = "crop_mask"
SLICE_STATE_MASK_3D_EDIT = "mask_3d_edit"
VOLUME_STATE_SEED = "volume_seed"

STYLE_LEVELS: Dict[str, int] = {
    STATE_DEFAULT: 0,
    STATE_ZOOM: 1,
    STATE_PAN: 1,
    STATE_SPIN: 1,
    STATE_WL: 1,
    SLICE_STATE_CROSS: 2,
    SLICE_STATE_SCROLL: 2,
    STATE_MEASURE_DISTANCE: 2,
    STATE_MEASURE_ANGLE: 2,
    STATE_MEASURE_DENSITY_ELLIPSE: 2,
    STATE_MEASURE_DENSITY_POLYGON: 2,
    SLICE_STATE_EDITOR: 3,
    SLICE_STATE_WATERSHED: 3,
    SLICE_STATE_REORIENT: 3,
    SLICE_STATE_MASK_FFILL: 3,
    SLICE_STATE_REMOVE_MASK_PARTS: 3,
    SLICE_STATE_SELECT_MASK_PARTS: 3,
    SLICE_STATE_FFILL_SEGMENTATION: 3,
    SLICE_STATE_CROP_MASK: 3,
    SLICE_STATE_MASK_3D_EDIT: 3,
    VOLUME_STATE_SEED: 3,
}


class StyleStateManager:
    """Level-based push/pop of tool states (reference style.py:67-120)."""

    def __init__(self, bus=None):
        self.bus = bus or events.bus
        self._stack: List[str] = [STATE_DEFAULT]

    @property
    def current(self) -> str:
        return self._stack[-1]

    def add_state(self, state: str) -> str:
        """Enable a tool: replaces any same-level state, pushes above
        lower-level ones."""
        level = STYLE_LEVELS.get(state, 1)
        self._stack = [s for s in self._stack if STYLE_LEVELS.get(s, 1) < level]
        if not self._stack:
            self._stack = [STATE_DEFAULT]
        self._stack.append(state)
        self.bus.send_message("styles.changed", state=self.current)
        return self.current

    def remove_state(self, state: str) -> str:
        if state in self._stack and state != STATE_DEFAULT:
            self._stack.remove(state)
        if not self._stack:
            self._stack = [STATE_DEFAULT]
        self.bus.send_message("styles.changed", state=self.current)
        return self.current

"""E-field visualization pipeline: per-coil-pose field estimates over a
cortical ROI (port of invesalius3_tpu/navigation/efield.py).

Reference: invesalius/data/e_field.py ``Visualize_E_field_Thread`` :44: on
each new coil pose it asks ``NeuronavigationApi.update_efield_vectorROIMax``
(an external solver process) for the e-field norms over the ROI's vertex
ids and queues them for rendering; ``--debug-efield`` substitutes fake
norms (reference app.py:443-447).

The debug solver is a dipole-like falloff over the ROI vertices, computed on
the worker's device (the card unless the caller passes "cpu"); the worker
synchronises by copying the norms to the host before it publishes them.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from invesalius3_tpu_torch import events
from invesalius3_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device


def debug_efield_norms(roi_vertices: torch.Tensor, coil_pos: torch.Tensor,
                       coil_dir: torch.Tensor) -> torch.Tensor:
    """Fake but spatially coherent e-norms on the inputs' device: distance
    falloff modulated by the alignment with the coil axis."""
    d = roi_vertices - coil_pos[None, :]
    r = torch.linalg.vector_norm(d, dim=1)
    axis_align = torch.abs(d @ coil_dir) / torch.clamp(r, min=1e-6)
    return 100.0 * torch.exp(-r / 30.0) * (0.5 + 0.5 * axis_align)


class VisualizeEFieldThread(threading.Thread):
    """Consumes coil poses, produces e-norms (reference e_field.py:44-117)."""

    def __init__(self, pose_queue: queue.Queue, api=None,
                 roi_vertices: Optional[np.ndarray] = None,
                 roi_ids: Optional[np.ndarray] = None,
                 debug: bool = False, bus=None, device=DEFAULT_DEVICE):
        super().__init__(daemon=True)
        self.pose_queue = pose_queue
        self.api = api
        self.debug = debug or api is None
        self.device = resolve_device(device)
        self.roi_vertices = (None if roi_vertices is None
                             else as_tensor(roi_vertices, self.device, torch.float32))
        self.roi_ids = roi_ids
        self.bus = bus or events.bus
        self._stop_event = threading.Event()

    def compute_once(self, item: dict) -> Optional[np.ndarray]:
        coils = item.get("coils_img", {})
        m = item.get("m_probe_img") if not coils else next(iter(coils.values()))
        if m is None:
            return None
        pos = np.asarray(m[:3, 3], np.float32)
        direction = np.asarray(m[:3, 2], np.float32)
        if self.debug:
            if self.roi_vertices is None:
                return None
            norms = debug_efield_norms(
                self.roi_vertices, as_tensor(pos, self.device),
                as_tensor(direction, self.device)).cpu().numpy()
        else:
            norms = self.api.update_efield_vector_roi_max(
                position=pos.tolist(), orientation=direction.tolist(),
                t_rot=np.asarray(m[:3, :3]).tolist(), id_list=self.roi_ids)
        return None if norms is None else np.asarray(norms)

    def run(self):
        while not self._stop_event.is_set():
            try:
                item = self.pose_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            norms = self.compute_once(item)
            if norms is not None:
                self.bus.send_message(
                    "navigation.efield", enorms=norms, max_id=int(np.argmax(norms)),
                    roi_ids=None if self.roi_ids is None else np.asarray(self.roi_ids),
                    timestamp=item.get("timestamp"))

    def stop(self):
        self._stop_event.set()

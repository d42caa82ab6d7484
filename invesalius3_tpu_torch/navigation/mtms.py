"""Multichannel TMS (mTMS) stimulator integration (port of
invesalius3_tpu/navigation/mtms.py; numpy on the host).

Reference: invesalius/navigation/mtms.py — a Windows-only ActiveX
(LabVIEW) bridge that maps a coil->target offset to a row of a
pulse-parameter file and triggers pulses (``GetOffset`` :79,
``FindmTMSParameters`` :86 with the 18-line-header tab-separated table
keyed ``x_y_rz``, ``UpdateTarget``/``UpdateTargetSequence`` :42-77,
``SendToMTMS`` :100, ``SaveSequence`` :121).  The offset quantization,
parameter-table lookup, sequence randomization, and CSV logging are fully
implemented here; only the ActiveX/LabVIEW transport is behind a device
seam (a callable you inject, or the bus in dry-run mode).
"""

from __future__ import annotations

import csv
import random
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from invesalius3_tpu_torch import events


def compute_relative_distance(target_coord, img_coord) -> np.ndarray:
    """Target pose expressed in the coil frame (reference
    coregistration.py ``ComputeRelativeDistanceToTarget``): the (x, y, z,
    rx, ry, rz) displacement of ``img_coord`` relative to
    ``target_coord``."""
    from invesalius3_tpu_torch.ops import transforms as tr

    def pose_matrix(p):
        m = tr.euler_matrix(np.radians(p[3]), np.radians(p[4]),
                            np.radians(p[5]), axes="sxyz")
        m[:3, 3] = p[:3]
        return m

    m_target = pose_matrix(np.asarray(target_coord, float))
    m_img = pose_matrix(np.asarray(img_coord, float))
    m_rel = np.linalg.inv(m_target) @ m_img
    ax, ay, az = np.degrees(tr.euler_from_matrix(m_rel, axes="sxyz"))
    x, y, z = m_rel[:3, 3]
    return np.array([x, y, z, ax, ay, az])


def offset_from_distance(distance: Sequence[float]) -> Tuple[int, int, int]:
    """Quantize a relative pose to the mTMS grid (reference mtms.py:79
    ``GetOffset``): integer-mm x/y with the axis swap/negation the coil
    grid uses, and rotation snapped to 15-degree steps."""
    offset_xy = [int(np.round(x)) for x in np.asarray(distance)[:2]]
    offset_rz = int(np.round(float(distance[-1]) / 15.0) * 15)
    return (-int(offset_xy[1]), int(offset_xy[0]), offset_rz)


def parse_pulse_parameters(path) -> List[str]:
    """Read a pulse-parameter file: 18 header lines then tab-separated
    rows whose first column is the ``x_y_rz`` target key (reference
    mtms.py:86-99)."""
    lines = [ln.strip() for ln in Path(path).read_text().splitlines()]
    return [ln.split("\t")[0] for ln in lines[18:] if ln]


class MTMS:
    """Offset->stimulation-parameter mapping + pulse sequencing.

    ``device`` is the transport seam: a callable ``device(row: int,
    intensity: float) -> None`` standing in for the LabVIEW ActiveX
    ``SendToMTMS`` (row is 1-based like the reference).  Without one, the
    pulse is published on the bus only (dry-run; the reference is
    similarly inert off-Windows).
    """

    def __init__(self, bus=None, parameter_file=None,
                 device: Optional[Callable[[int, float], None]] = None,
                 intensity: float = 20.0, log_name: str = "mtms_subject_00_run_0"):
        self.bus = bus or events.bus
        self.device = device
        self.intensity = intensity
        self.log_name = log_name
        self.keys: List[str] = []
        if parameter_file is not None:
            self.load_parameter_file(parameter_file)
        self.sequence_log: List[dict] = []
        try:  # Windows-only ActiveX bridge (never available here)
            import win32com.client  # noqa: F401

            self._activex = True
        except ImportError:
            self._activex = False

    @property
    def available(self) -> bool:
        return self.device is not None or self._activex

    def load_parameter_file(self, path) -> int:
        self.keys = parse_pulse_parameters(path)
        return len(self.keys)

    # -- mapping ------------------------------------------------------------
    def get_offset(self, coil_pose, brain_target) -> Tuple[int, int, int]:
        """reference UpdateTarget :57-66: y is flipped on both poses
        before the relative distance."""
        coil = np.asarray(coil_pose, float).copy()
        target = np.asarray(brain_target, float).copy()
        coil[1] = -coil[1]
        target[1] = -target[1]
        distance = compute_relative_distance(coil, target)
        return offset_from_distance(distance)

    def find_parameters(self, offset) -> Tuple[str, Optional[int]]:
        """offset -> (key, 0-based row index into the parameter table) or
        (key, None) when the grid has no entry (reference
        FindmTMSParameters :86)."""
        key = "_".join(str(int(x)) for x in offset)
        try:
            return key, self.keys.index(key)
        except ValueError:
            return key, None

    def check_targets(self, coil_pose, brain_targets) -> bool:
        """All targets must map to grid entries (reference CheckTargets)."""
        for target in brain_targets:
            _, row = self.find_parameters(self.get_offset(coil_pose, target))
            if row is None:
                return False
        return True

    # -- stimulation --------------------------------------------------------
    def update_target(self, coil_pose, brain_target) -> bool:
        """Map one target and fire (reference UpdateTarget :56)."""
        offset = self.get_offset(coil_pose, brain_target)
        key, row = self.find_parameters(offset)
        if row is None:
            self.bus.send_message("mtms.invalid_target", offset=list(offset))
            return False
        self.send_stimulus(row + 1)  # device rows are 1-based
        self.sequence_log.append({
            "mTMS_target": key,
            "brain_target(nav)": list(np.asarray(brain_target, float)),
            "coil_pose(nav)": list(np.asarray(coil_pose, float)),
            "intensity": self.intensity,
        })
        return True

    def update_target_sequence(self, coil_pose, brain_targets,
                               number_of_stim: int = 3,
                               inter_pulse_s: Tuple[float, float] = (3.0, 5.0),
                               rng: Optional[random.Random] = None,
                               sleep=time.sleep) -> bool:
        """Randomized stimulation sequence (reference
        UpdateTargetSequence :42): shuffle targets, ``number_of_stim``
        pulses each with a jittered inter-pulse interval."""
        if not brain_targets:
            return False
        if not self.check_targets(coil_pose, brain_targets):
            return False
        rng = rng or random.Random()
        order = list(brain_targets)
        rng.shuffle(order)
        for target in order:
            for _ in range(number_of_stim):
                self.update_target(coil_pose, target)
                sleep(rng.randrange(300, 500) / 100.0)
        return True

    def send_stimulus(self, row: int) -> bool:
        if self.device is not None:
            self.device(int(row), self.intensity)
        elif not self._activex:
            self.bus.send_message("mtms.unavailable")
        self.bus.send_message("mtms.pulse_sent", row=int(row),
                              intensity=self.intensity)
        return True

    def save_sequence(self, directory=".") -> Path:
        """Tab-separated CSV log (reference SaveSequence :121)."""
        ts = time.localtime()
        name = "_".join([
            f"{ts.tm_year:0>4d}{ts.tm_mon:0>2d}{ts.tm_mday:0>2d}",
            f"{ts.tm_hour:0>2d}{ts.tm_min:0>2d}{ts.tm_sec:0>2d}",
            self.log_name, "sequence"]) + ".csv"
        out = Path(directory) / name
        cols = ["mTMS_target", "brain_target(nav)", "coil_pose(nav)",
                "intensity"]
        with open(out, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=cols, delimiter="\t")
            w.writeheader()
            w.writerows(self.sequence_log)
        return out

    # -- back-compat shim (pre-round-3 surface) ------------------------------
    def get_offsets(self, target_pose, coil_pose) -> Tuple[float, float, float]:
        d = np.asarray(target_pose[:3]) - np.asarray(coil_pose[:3])
        dtheta = float(target_pose[5] - coil_pose[5])
        return float(d[0]), float(d[1]), dtheta

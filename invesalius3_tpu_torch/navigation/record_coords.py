"""Tracker-coordinate CSV recording (port of
invesalius3_tpu/navigation/record_coords.py).

Reference: invesalius/data/record_coords.py — a thread appending
timestamped tracker coordinates to CSV while recording is enabled.
"""

from __future__ import annotations

import csv
import threading
import time
from pathlib import Path


class RecordCoords(threading.Thread):
    def __init__(self, tracker, path, poll_hz: float = 20.0):
        super().__init__(daemon=True)
        self.tracker = tracker
        self.path = Path(path)
        self.period = 1.0 / poll_hz
        self._stop_event = threading.Event()

    def run(self):
        with open(self.path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["timestamp", "sensor", "x", "y", "z", "alpha", "beta", "gamma"])
            while not self._stop_event.is_set():
                coords, _ = self.tracker.get_coordinates()
                ts = time.time()
                for i, c in enumerate(coords):
                    w.writerow([f"{ts:.4f}", i, *[f"{v:.4f}" for v in c]])
                time.sleep(self.period)

    def stop(self):
        self._stop_event.set()

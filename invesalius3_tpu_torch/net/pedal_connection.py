"""Pedal input abstraction (hands-free fiducial capture / pulse trigger;
port of invesalius3_tpu/net/pedal_connection.py).

Reference: invesalius/net/pedal_connection.py — ``PedalConnector`` :37
abstracts a MIDI pedal (``MidiPedal`` thread :106 via mido) vs an
API-provided pedal; listeners register callbacks keyed by name, optionally
auto-removed after one press.

``mido`` is imported only when a MIDI pedal is made, and its absence
raises naming it; the programmatic pedal covers headless use and tests.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional


class PedalBase:
    def __init__(self):
        self._callbacks: Dict[str, tuple] = {}

    def add_callback(self, name: str, callback: Callable[[bool], None],
                     remove_when_released: bool = False) -> None:
        self._callbacks[name] = (callback, remove_when_released)

    def remove_callback(self, name: str) -> None:
        self._callbacks.pop(name, None)

    def _dispatch(self, state: bool) -> None:
        for name in list(self._callbacks):
            cb, once = self._callbacks[name]
            cb(state)
            if once and not state:
                self._callbacks.pop(name, None)


class ProgrammaticPedal(PedalBase):
    """Headless pedal: call press()/release() (test + remote-control seam)."""

    def press(self) -> None:
        self._dispatch(True)

    def release(self) -> None:
        self._dispatch(False)


class MidiPedal(PedalBase):
    """MIDI pedal via mido (reference MidiPedal :106).  Gated: raises a
    clear error if mido isn't installed."""

    def __init__(self, port_name: Optional[str] = None):
        super().__init__()
        try:
            import mido
        except ImportError as e:
            raise RuntimeError("MIDI pedal requires the 'mido' package") from e
        self._mido = mido
        names = mido.get_input_names()
        if not names:
            raise RuntimeError("no MIDI input ports found")
        self.port_name = port_name or names[0]
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._stop_event = threading.Event()
        self._thread.start()

    def _loop(self) -> None:
        with self._mido.open_input(self.port_name) as port:
            while not self._stop_event.is_set():
                for msg in port.iter_pending():
                    if msg.type == "note_on":
                        self._dispatch(True)
                    elif msg.type == "note_off":
                        self._dispatch(False)

    def stop(self) -> None:
        self._stop_event.set()


class PedalConnector:
    """Combines available pedal sources (reference PedalConnector :37)."""

    def __init__(self, api=None, use_midi: bool = False):
        self.pedals = []
        self.programmatic = ProgrammaticPedal()
        self.pedals.append(self.programmatic)
        if use_midi:
            self.pedals.append(MidiPedal())
        if api is not None and hasattr(api, "add_pedal_callback"):
            self.pedals.append(api)

    def add_callback(self, name, callback, remove_when_released=False):
        for p in self.pedals:
            p.add_callback(name, callback, remove_when_released)

    def remove_callback(self, name):
        for p in self.pedals:
            p.remove_callback(name)

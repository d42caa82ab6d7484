"""Serial-port TTL trigger connection (port of
invesalius3_tpu/navigation/serial_port.py; it posts on the port's bus).

Reference: invesalius/data/serial_port_connection.py ``SerialPortConnection``
:28 — a thread that pulses a TTL line on marker events (TMS pulse
synchronization) and reads trigger-in state at the navigation rate.

pyserial is not in this environment; the port layer is injectable (tests
use a fake port), and opening a real port raises a clear error when
pyserial is absent.
"""

from __future__ import annotations

import threading
import time

from invesalius3_tpu_torch import events


class SerialPortConnection(threading.Thread):
    def __init__(self, port: str = "COM1", baud: int = 9600, bus=None,
                 serial_port=None, poll_hz: float = 120.0):
        super().__init__(daemon=True)
        self.bus = bus or events.bus
        self.period = 1.0 / poll_hz
        self._stop_event = threading.Event()
        self.trigger_in = False
        if serial_port is not None:
            self.port = serial_port
        else:
            try:
                import serial  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "serial trigger requires the 'pyserial' package") from e
            self.port = serial.Serial(port, baudrate=baud, timeout=0)

    def send_pulse(self) -> None:
        """Pulse the TTL line (reference: set RTS briefly on marker)."""
        try:
            self.port.setRTS(True)
            time.sleep(0.005)
            self.port.setRTS(False)
            self.bus.send_message("serial.pulse_sent")
        except Exception:
            pass

    def run(self) -> None:
        while not self._stop_event.is_set():
            try:
                data = self.port.read(1)
                if data:
                    self.trigger_in = True
                    self.bus.send_message("serial.trigger_received")
            except Exception:
                pass
            time.sleep(self.period)

    def stop(self) -> None:
        self._stop_event.set()
        try:
            self.port.close()
        except Exception:
            pass

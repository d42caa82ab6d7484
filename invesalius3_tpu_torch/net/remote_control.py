"""Remote control: mirror the internal event bus to/from an external
controller over a line-delimited JSON TCP socket (port of
invesalius3_tpu/net/remote_control.py).

Reference: invesalius/net/remote_control.py :29 — a Socket.IO client that
(a) re-publishes received ``to_neuronavigation`` messages onto the
internal bus and (b) registers a ``add_sendMessage_hook`` forwarding every
internal pubsub message out.  Socket.IO isn't in this environment, so the
transport is a dependency-free JSON-lines TCP protocol with identical
semantics: {"topic": ..., "data": {...}} per line in both directions.

A payload of host data (numpy, Python scalars, strings, lists, dicts)
mirrors as the JAX package's line.  Anything else goes out as its
``repr()``, as in the JAX package: where a JAX message carries a
``jax.Array`` the port's carries a ``torch.Tensor``, whose ``repr`` is
torch's text (and, for a CUDA tensor, a copy to the host on the sender's
thread).

One fault of the JAX module is not copied: its reader stops the mirror when
no line arrives within the connect timeout (the socket's read timeout ends
its loop); here a read timeout only restarts the read.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Optional

from invesalius3_tpu_torch import events


class RemoteControl:
    def __init__(self, host: str, port: int = 5000, bus=None):
        self.host = host
        self.port = port
        self.bus = bus or events.bus
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[threading.Thread] = None
        self._connected = False
        self._lock = threading.Lock()

    def connect(self, timeout: float = 5.0) -> bool:
        self._sock = socket.create_connection((self.host, self.port), timeout=timeout)
        self._connected = True
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        # forward every internal event outward (reference remote_control.py:57)
        self.bus.add_send_message_hook(self._on_internal_message)
        return True

    def disconnect(self) -> None:
        """Remove the bus hook, close the socket and join the reader (the
        socket is shut down first, so a blocked read returns at once)."""
        self._connected = False
        self.bus.remove_send_message_hook()
        if self._sock:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._reader is not None and self._reader is not threading.current_thread():
            self._reader.join(timeout=5.0)
            self._reader = None

    # -- outbound: internal bus -> remote ----------------------------------------
    def _on_internal_message(self, topic: str, kwargs: dict) -> None:
        if not self._connected:
            return
        try:
            payload = json.dumps({"topic": topic, "data": _jsonable(kwargs)})
            with self._lock:
                self._sock.sendall(payload.encode() + b"\n")
        except (OSError, TypeError, ValueError):
            pass

    # -- inbound: remote -> internal bus (no hook, avoid echo loops) --------------
    def _read_loop(self) -> None:
        buf = b""
        sock = self._sock  # disconnect() clears the attribute
        while self._connected:
            try:
                chunk = sock.recv(4096)
            except socket.timeout:  # a quiet controller: keep listening
                continue
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                try:
                    msg = json.loads(line)
                    self.bus.send_message_no_hook(msg["topic"], **msg.get("data", {}))
                except (ValueError, KeyError):
                    continue
        self._connected = False


def _jsonable(obj):
    import numpy as np

    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)

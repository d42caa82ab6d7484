"""Development event server for the remote-control channel (port of
invesalius3_tpu/net/remote_server.py).

The reference ships ``scripts/invesalius_server.py`` — a Socket.IO server
used to watch the mirrored event bus and inject events back into a
running InVesalius (``app.py --remote-host``).  This is its JSON-lines
equivalent for :mod:`invesalius3_tpu_torch.net.remote_control`:

    # console 1
    python -m invesalius3_tpu_torch.net.remote_server 5000
    # console 2
    python -m invesalius3_tpu_torch.app --import-file t1.nii.gz --remote-host 127.0.0.1:5000

Every mirrored bus event prints as it arrives; typing
``topic {"json": "payload"}`` on stdin sends an event back into the app
(republished on its internal bus, same as the reference's
``to_neuronavigation`` path).

Programmatic use (tests, tooling): ``RemoteEventServer`` collects events
in ``received`` and ``send(topic, **data)`` injects into every connected
client.
"""

from __future__ import annotations

import json
import socket
import socketserver
import sys
import threading
from typing import List, Optional


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        srv: "RemoteEventServer" = self.server.owner  # type: ignore[attr-defined]
        with srv._lock:
            srv._clients.append(self.connection)
        try:
            for raw in self.rfile:
                line = raw.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                srv.received.append(msg)
                if srv.echo:
                    print(f"[event] {msg.get('topic')} "
                          f"{json.dumps(msg.get('data', {}))[:200]}",
                          flush=True)
        finally:
            with srv._lock:
                try:
                    srv._clients.remove(self.connection)
                except ValueError:
                    pass


class _TCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class RemoteEventServer:
    """Listen for RemoteControl connections; record mirrored events and
    inject events back (reference scripts/invesalius_server.py)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 echo: bool = False):
        self.received: List[dict] = []
        self.echo = echo
        self._clients: List[socket.socket] = []
        self._lock = threading.Lock()
        self._server = _TCP((host, port), _Handler)
        self._server.owner = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RemoteEventServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="remote-event-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def send(self, topic: str, **data) -> int:
        """Inject an event into every connected app; returns sends."""
        payload = json.dumps({"topic": topic, "data": data}).encode() + b"\n"
        n = 0
        with self._lock:
            for c in list(self._clients):
                try:
                    c.sendall(payload)
                    n += 1
                except OSError:
                    pass
        return n


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    port = int(args[0]) if args else 5000
    srv = RemoteEventServer(port=port, echo=True).start()
    print(f"remote event server on 127.0.0.1:{srv.port} — "
          f"type: topic {{json}}  (Ctrl-D to exit)", flush=True)
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            topic, _, rest = line.partition(" ")
            try:
                data = json.loads(rest) if rest else {}
            except ValueError:
                print("bad JSON payload", flush=True)
                continue
            n = srv.send(topic, **data)
            print(f"sent to {n} client(s)", flush=True)
    except KeyboardInterrupt:
        pass
    srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

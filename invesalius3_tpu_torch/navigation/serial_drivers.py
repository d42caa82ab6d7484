"""Protocol-level serial tracker drivers with a recorded-bytes replay
transport (port of invesalius3_tpu/navigation/serial_drivers.py: the same
bytes on the wire, the same coordinates; host code, no tensors).

The reference talks to Polhemus ISOTRAK/FASTRAK over pyserial (reference
invesalius/data/tracker_connection.py:264 ``PolhemusSerialConnection`` —
init command bytes per model, 0.03 s timeout; invesalius/data/
coordinates.py:467 ``PolhemusSerialCoord`` — poll with ``P``, read lines,
split fields that abut through their minus signs, cm -> mm scale, optional
dynamic-reference correction :622).  No tracker hardware exists in this
environment, so the protocol logic runs against a byte-transcript replay
transport — the same seam the DIMSE stack uses for its loopback tests —
and plugs into navigation/tracker.py unchanged.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from invesalius3_tpu_torch.navigation import vendor_coords
from invesalius3_tpu_torch.navigation.tracker import TrackerConnection


class SerialTransport:
    """Byte-level transport boundary (what pyserial provides)."""

    def write(self, data: bytes) -> None:
        raise NotImplementedError

    def readlines(self) -> List[bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class PySerialTransport(SerialTransport):
    """Real COM-port transport (reference tracker_connection.py:276:
    ``serial.Serial(com_port, baudrate=baud_rate, timeout=0.03)``).
    Import is deferred — pyserial and hardware are absent in CI."""

    def __init__(self, com_port: str, baud_rate: int = 115200,
                 timeout: float = 0.03):
        import serial  # hardware-gated

        self._ser = serial.Serial(com_port, baudrate=baud_rate,
                                  timeout=timeout)

    def write(self, data: bytes) -> None:
        self._ser.write(data)

    def readlines(self) -> List[bytes]:
        return self._ser.readlines()

    def close(self) -> None:
        self._ser.close()


class ReplayTransport(SerialTransport):
    """Replays a recorded transcript: a list of ``{"write": hex,
    "lines": [hex, ...]}`` entries.  Each ``write`` must match the bytes
    the driver sends (protocol conformance is part of the assertion);
    ``readlines`` returns that entry's recorded response.  Poll entries
    cycle once the transcript is exhausted when ``loop=True`` (a tracker
    streaming the last pose forever)."""

    def __init__(self, transcript: Sequence[dict], loop: bool = True):
        self.transcript = list(transcript)
        self.loop = loop
        self.pos = 0
        self.writes: List[bytes] = []
        self._lock = threading.Lock()

    @classmethod
    def from_file(cls, path, **kw) -> "ReplayTransport":
        return cls(json.loads(Path(path).read_text()), **kw)

    def _entry(self) -> dict:
        if self.pos >= len(self.transcript):
            if not self.loop:
                raise EOFError("replay transcript exhausted")
            # loop over the trailing poll section (entries sharing the
            # final entry's command — b"P" for Polhemus, framed TX: for
            # NDI) so long-running navigation keeps a pose
            last = self.transcript[-1]["write"]
            polls = [e for e in self.transcript
                     if e["write"] == last] or self.transcript
            return polls[(self.pos - len(self.transcript)) % len(polls)]
        return self.transcript[self.pos]

    def write(self, data: bytes) -> None:
        with self._lock:
            e = self._entry()
            want = bytes.fromhex(e["write"])
            if data != want:
                raise AssertionError(
                    f"protocol mismatch at entry {self.pos}: driver wrote "
                    f"{data!r}, transcript expects {want!r}")
            self.writes.append(data)

    def readlines(self) -> List[bytes]:
        with self._lock:
            e = self._entry()
            self.pos += 1
            return [bytes.fromhex(h) for h in e.get("lines", [])]


class TranscriptRecorder(SerialTransport):
    """Wrap a real transport and capture the byte exchange into the
    replay format (run once against hardware, then test forever)."""

    def __init__(self, inner: SerialTransport):
        self.inner = inner
        self.entries: List[dict] = []

    def write(self, data: bytes) -> None:
        self.inner.write(data)
        self.entries.append({"write": data.hex(), "lines": []})

    def readlines(self) -> List[bytes]:
        lines = self.inner.readlines()
        if self.entries:
            self.entries[-1]["lines"] = [ln.hex() for ln in lines]
        return lines

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.entries, indent=1))

    def close(self) -> None:
        self.inner.close()


class PolhemusSerialConnection(TrackerConnection):
    """ISOTRAK/FASTRAK serial driver (reference coordinates.py:467
    ``PolhemusSerialCoord`` + tracker_connection.py:264 init sequence).

    Sensor rows: 0 = probe (dynamic-referenced when ``ref_mode``),
    1 = reference sensor raw pose, 2 = coil (not provided on this link).
    """

    POLL = b"P"
    # "u": English units (cm), "F": ASCII output format, "Y": tip offset
    INIT = {"isotrak": [b"u", b"F", b"Y"], "fastrak": [b"u", b"F"]}

    def __init__(self, transport: SerialTransport, model: str = "isotrak",
                 ref_mode: bool = True):
        if model not in self.INIT:
            raise ValueError(f"unknown Polhemus model {model!r}")
        self.transport = transport
        self.model = model
        self.ref_mode = ref_mode
        self.stylus_button = False

    def connect(self) -> bool:
        for cmd in self.INIT[self.model]:
            self.transport.write(cmd)
            self.transport.readlines()  # drain any echo/ack
        return True

    def disconnect(self) -> None:
        self.transport.close()

    def get_coordinates(self) -> Tuple[np.ndarray, np.ndarray]:
        self.transport.write(self.POLL)
        lines = self.transport.readlines()
        coords = np.zeros((self.n_sensors, 6))
        flags = np.array([False, False, False])
        if not lines:
            return coords, flags
        probe = vendor_coords.parse_polhemus_serial(lines[0])
        if self.ref_mode and len(lines) > 1:
            reference = vendor_coords.parse_polhemus_serial(lines[1])
            coords[0] = vendor_coords.polhemus_dynamic_pose(probe, reference)
            coords[1] = reference
            flags[:2] = True
        else:
            coords[0] = probe
            flags[0] = True
        return coords, flags


# ---------------------------------------------------------------------------
# NDI Combined API (Polaris / Polaris P4 / Vega) over serial
# ---------------------------------------------------------------------------

def crc16_ndi(data: bytes) -> int:
    """CRC16 of the NDI Combined API (CRC-16/ARC: reflected poly 0xA001,
    init 0) — appended as 4 uppercase hex chars to every command and reply.
    The reference reaches Polaris through the closed pypolaris SWIG wrapper
    (tracker_connection.py:417); this build speaks the wire protocol the
    wrapper wraps, so the framing is implemented here."""
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ 0xA001 if crc & 1 else crc >> 1
    return crc


def frame_ndi(cmd: bytes) -> bytes:
    """Frame a command: payload + CRC16 (4 hex) + CR."""
    return cmd + f"{crc16_ndi(cmd):04X}".encode() + b"\r"


def unframe_ndi(reply: bytes) -> bytes:
    """Strip CR + verify/remove the trailing CRC of a device reply."""
    reply = reply.rstrip(b"\r\n")
    body, crc_hex = reply[:-4], reply[-4:]
    want = f"{crc16_ndi(body):04X}".encode()
    if crc_hex.upper() != want:
        raise AssertionError(
            f"NDI reply CRC mismatch: got {crc_hex!r}, want {want!r}")
    return body


class NDIProtocolError(RuntimeError):
    pass


class NDIPolarisConnection(TrackerConnection):
    """Polaris driver speaking the NDI Combined API over serial
    (reference tracker_connection.py:386 ``PolarisTrackerConnection`` /
    coordinates.py:139 ``PolarisP4Coord`` — there via the closed pypolaris
    wrapper; here at protocol level so the replay transport can assert the
    exact byte exchange).

    Init sequence: ``INIT:`` -> ``PHSR:02`` (handles needing init) ->
    per handle ``PINIT:HH`` + ``PENA:HHD`` (dynamic) -> ``TSTART:``.
    Poll: ``TX:0001`` — per-handle ASCII transform records in the P4
    layout vendor_coords.parse_polaris_p4 decodes (four 6-char quaternion
    ints x1e-4, three 7-char translation ints x1e-2, 'MISSING' when the
    tool is out of view), LF-separated, then 4-hex system status.

    Handle order follows tool-load order like the reference wrapper:
    probe, reference, coil (coordinates.py:259 reads trck.probe/ref/objs).
    """

    POLL = b"TX:0001"

    def __init__(self, transport: SerialTransport, n_tools: int = 3,
                 rom_files: Optional[Sequence] = None):
        self.transport = transport
        self.n_tools = n_tools
        self.rom_files = list(rom_files or [])
        self.handles: List[str] = []

    # -- framing ----------------------------------------------------------
    def _exchange(self, cmd: bytes) -> bytes:
        self.transport.write(frame_ndi(cmd))
        reply = b"".join(self.transport.readlines())
        body = unframe_ndi(reply)
        if body.startswith(b"ERROR"):
            raise NDIProtocolError(
                f"device error {body[5:7].decode()} for command {cmd!r}")
        return body

    # -- tool definition (ROM) upload -------------------------------------
    def _load_rom(self, path) -> str:
        """Upload a wireless-tool definition file: ``PHRQ`` requests a
        free port handle, then ``PVWR:HH AAAA <64 bytes hex>`` writes the
        .rom in 64-byte pages (NDI Combined API; the reference ships the
        vendor .rom files under navigation/ndi_files and loads them
        through the closed pypolaris wrapper)."""
        data = Path(path).read_bytes() if not isinstance(path, bytes) \
            else path
        h = self._exchange(b"PHRQ:*********1****").decode()[:2]
        data += b"\x00" * (-len(data) % 64)
        for off in range(0, len(data), 64):
            page = data[off:off + 64].hex().upper()
            self._exchange(f"PVWR:{h}{off:04X}{page}".encode())
        return h

    # -- lifecycle --------------------------------------------------------
    def connect(self) -> bool:
        if self._exchange(b"INIT:") != b"OKAY":
            return False
        self.handles = [self._load_rom(p) for p in self.rom_files]
        if not self.handles:  # wired / auto-detected tools
            phsr = self._exchange(b"PHSR:02").decode()
            n = int(phsr[:2], 16)
            self.handles = [phsr[2 + 5 * i:4 + 5 * i] for i in range(n)]
        for h in self.handles:
            self._exchange(f"PINIT:{h}".encode())
            self._exchange(f"PENA:{h}D".encode())
        self._exchange(b"TSTART:")
        return True

    def disconnect(self) -> None:
        try:
            self._exchange(b"TSTOP:")
        except Exception:
            pass
        self.transport.close()

    # -- polling ----------------------------------------------------------
    def get_coordinates(self) -> Tuple[np.ndarray, np.ndarray]:
        body = self._exchange(self.POLL).decode()
        records = body.split("\n")
        n = int(records[0][:2], 16)
        records[0] = records[0][2:]
        coords = np.zeros((self.n_sensors, 6))
        flags = np.array([False] * 3)
        for i, rec in enumerate(records[:n]):
            if i >= self.n_sensors:
                break
            pose = vendor_coords.parse_polaris_p4(rec)
            if pose is not None:
                coords[i] = pose
                if i < 3:
                    flags[i] = True
        return coords, flags


def make_polaris_transcript(frames: Sequence[Sequence[Optional[Tuple[
        Sequence[float], Sequence[float]]]]],
        handles: Sequence[str] = ("0A", "0B", "0C"),
        rom_files: Optional[Sequence[bytes]] = None) -> List[dict]:
    """Synthesize the byte transcript a Polaris would produce for the
    given frames — each frame is a per-tool list of ``(q_wxyz, t_mm)`` or
    ``None`` (tool out of view).  Replies carry real CRC16s so the driver's
    CRC verification is part of the replay assertion.  With ``rom_files``
    (one .rom blob per tool) the transcript carries the PHRQ/PVWR
    tool-definition upload exchange instead of the PHSR auto-detect."""
    def reply(body: bytes) -> str:
        return (body + f"{crc16_ndi(body):04X}".encode() + b"\r").hex()

    handles = list(handles)[:len(frames[0])]
    entries = [
        {"write": frame_ndi(b"INIT:").hex(), "lines": [reply(b"OKAY")]},
    ]
    if rom_files:
        for h, rom in zip(handles, rom_files):
            entries.append({"write": frame_ndi(b"PHRQ:*********1****").hex(),
                            "lines": [reply(h.encode())]})
            rom = rom + b"\x00" * (-len(rom) % 64)
            for off in range(0, len(rom), 64):
                page = rom[off:off + 64].hex().upper()
                entries.append({
                    "write": frame_ndi(
                        f"PVWR:{h}{off:04X}{page}".encode()).hex(),
                    "lines": [reply(b"OKAY")]})
    else:
        phsr = f"{len(handles):02X}" + "".join(h + "001" for h in handles)
        entries.append({"write": frame_ndi(b"PHSR:02").hex(),
                        "lines": [reply(phsr.encode())]})
    for h in handles:
        entries.append({"write": frame_ndi(f"PINIT:{h}".encode()).hex(),
                        "lines": [reply(b"OKAY")]})
        entries.append({"write": frame_ndi(f"PENA:{h}D".encode()).hex(),
                        "lines": [reply(b"OKAY")]})
    entries.append({"write": frame_ndi(b"TSTART:").hex(),
                    "lines": [reply(b"OKAY")]})

    def tool_record(handle: str, tool) -> str:
        if tool is None:
            return handle + "MISSING" + "0" * 8 + "0" * 8
        q, t = tool
        qs = "".join(f"{int(round(v * 10000)):+06d}" for v in q)
        ts = "".join(f"{int(round(v * 100)):+07d}" for v in t)
        err, status, frame_no = "+00001", "0" * 8, "0" * 8
        return handle + qs + ts + err + status + frame_no

    for frame in frames:
        recs = [tool_record(h, tool) for h, tool in zip(handles, frame)]
        body = (f"{len(recs):02X}" + "\n".join(recs) + "\n0000").encode()
        entries.append({"write": frame_ndi(NDIPolarisConnection.POLL).hex(),
                        "lines": [reply(body)]})
    return entries


def make_isotrak_transcript(poses: Sequence[Tuple[Sequence[float],
                                                  Sequence[float]]],
                            model: str = "isotrak") -> List[dict]:
    """Synthesize a byte transcript an ISOTRAK would produce for the given
    (probe_cm_deg, reference_cm_deg) pose pairs — used by tests and the
    demo replay tracker.  Field layout per reference coordinates.py:467:
    station id then six fixed-width floats, negatives abutting the
    previous field."""
    entries = [{"write": c.hex(), "lines": []}
               for c in PolhemusSerialConnection.INIT[model]]

    def fmt(station: int, pose) -> bytes:
        txt = f"{station}"
        for v in pose:
            # negative values consume the separating space (full-width
            # columns on the real device) — the parser quirk the driver
            # must handle via the " -" re-split
            sep = "" if v < 0 else " "
            txt += f"{sep}{v:.2f}"
        return txt.encode() + b"\r\n"

    for probe, ref in poses:
        entries.append({
            "write": PolhemusSerialConnection.POLL.hex(),
            "lines": [fmt(1, probe).hex(), fmt(2, ref).hex()],
        })
    return entries


# ---------------------------------------------------------------------------
# Optitrack (NatNet streaming protocol)
# ---------------------------------------------------------------------------

# The reference drives Optitrack through the closed Motive SDK wrapper
# (`import optitrack`, reference tracker_connection.py:78-128;
# coordinates.py:183 OptitrackCoord reads probe/ref/coil rigid bodies and
# converts quaternions to Euler).  Motive also STREAMS the same data over
# the documented NatNet UDP protocol, so the TPU build implements the
# NatNet FrameOfMocapData wire format directly — runnable against a real
# socket or a recorded-datagram replay, like every other driver here.

NATNET_FRAME_OF_DATA = 7


def parse_natnet_frame(data: bytes) -> List[dict]:
    """Parse a NatNet 3.x FrameOfMocapData datagram -> rigid bodies
    [{"id", "pos" (m), "quat" (qx,qy,qz,qw), "tracked"}].

    Subset: marker sets and unlabeled markers are skipped over (their
    sizes are encoded in-stream); rigid bodies are fully decoded
    (id, position, orientation, mean error, tracking-valid flag)."""
    import struct as _s

    msg_id, nbytes = _s.unpack_from("<HH", data, 0)
    if msg_id != NATNET_FRAME_OF_DATA:
        raise ValueError(f"not a FrameOfMocapData packet (id {msg_id})")
    off = 4
    off += 4  # frame number
    (n_marker_sets,) = _s.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_marker_sets):
        end = data.index(b"\x00", off)
        off = end + 1
        (n_markers,) = _s.unpack_from("<i", data, off)
        off += 4 + 12 * n_markers
    (n_unlabeled,) = _s.unpack_from("<i", data, off)
    off += 4 + 12 * n_unlabeled
    (n_bodies,) = _s.unpack_from("<i", data, off)
    off += 4
    bodies = []
    for _ in range(n_bodies):
        bid, px, py, pz, qx, qy, qz, qw = _s.unpack_from("<ifffffff",
                                                         data, off)
        off += 32
        (mean_err,) = _s.unpack_from("<f", data, off)
        off += 4
        (params,) = _s.unpack_from("<h", data, off)
        off += 2
        bodies.append({"id": bid, "pos": (px, py, pz),
                       "quat": (qx, qy, qz, qw), "err": mean_err,
                       "tracked": bool(params & 0x01)})
    return bodies


def make_natnet_frame(bodies: Sequence[dict]) -> bytes:
    """Synthesize a FrameOfMocapData datagram (tests / demo replay)."""
    import struct as _s

    payload = _s.pack("<i", 0)          # frame number
    payload += _s.pack("<i", 0)         # no marker sets
    payload += _s.pack("<i", 0)         # no unlabeled markers
    payload += _s.pack("<i", len(bodies))
    for b in bodies:
        payload += _s.pack("<ifffffff", b["id"], *b["pos"], *b["quat"])
        payload += _s.pack("<f", b.get("err", 0.0))
        payload += _s.pack("<h", 0x01 if b.get("tracked", True) else 0)
    return _s.pack("<HH", NATNET_FRAME_OF_DATA, len(payload)) + payload


class DatagramTransport:
    """One recv() = one datagram — the UDP analog of SerialTransport."""

    def recv(self) -> Optional[bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class UDPDatagramTransport(DatagramTransport):
    """Live NatNet data socket (Motive multicast 239.255.42.99:1511)."""

    def __init__(self, port: int = 1511, group: str = "239.255.42.99",
                 timeout: float = 0.05):
        import socket

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("", port))
        mreq = socket.inet_aton(group) + socket.inet_aton("0.0.0.0")
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP,
                             mreq)
        self.sock.settimeout(timeout)

    def recv(self) -> Optional[bytes]:
        import socket

        try:
            return self.sock.recv(65535)
        except socket.timeout:
            return None

    def close(self) -> None:
        self.sock.close()


class ReplayDatagramTransport(DatagramTransport):
    """Replays recorded NatNet datagrams (loops by default)."""

    def __init__(self, frames: Sequence[bytes], loop: bool = True):
        self.frames = list(frames)
        self.loop = loop
        self.i = 0

    def recv(self) -> Optional[bytes]:
        if not self.frames:
            return None
        if self.i >= len(self.frames):
            if not self.loop:
                return None
            self.i = 0
        f = self.frames[self.i]
        self.i += 1
        return f


class OptitrackNatNetConnection(TrackerConnection):
    """Optitrack over NatNet streaming (reference coordinates.py:183
    OptitrackCoord semantics: rigid bodies probe/ref/coil, quaternion ->
    'rzyx' Euler via vendor_coords.optitrack_pose, meters -> mm)."""

    def __init__(self, transport: DatagramTransport,
                 probe_id: int = 1, ref_id: int = 2, coil_id: int = 3):
        self.transport = transport
        self.ids = (probe_id, ref_id, coil_id)

    def connect(self) -> bool:
        return True

    def disconnect(self) -> None:
        self.transport.close()

    def get_coordinates(self) -> Tuple[np.ndarray, np.ndarray]:
        coords = np.zeros((3, 6))
        flags = np.array([False, False, False])
        data = self.transport.recv()
        if not data:
            return coords, flags
        for b in parse_natnet_frame(data):
            if b["id"] not in self.ids:
                continue
            row = self.ids.index(b["id"])
            qx, qy, qz, qw = b["quat"]
            # optitrack_pose does the Motive m->mm scale + axis permutation
            coords[row] = vendor_coords.optitrack_pose(qw, qx, qy, qz,
                                                       *b["pos"])
            flags[row] = b["tracked"]
        return coords, flags


# ---------------------------------------------------------------------------
# Claron MicronTracker
# ---------------------------------------------------------------------------


class ClaronConnection(TrackerConnection):
    """Claron MicronTracker (reference coordinates.py:283 ClaronCoord +
    tracker_connection.py:130).

    The vendor exposes ONLY a closed SDK (`pyclaron` — attribute API:
    ``Run()`` then ``PositionTooltip{X,Y,Z}{1,2,3}`` / ``Angle{Z,Y,X}{n}``
    and per-body visibility); there is no wire protocol to implement, so
    this driver speaks exactly that attribute surface: pass the real
    ``pyclaron.pyclaron()`` instance when present, or a ``ReplayMTC``
    stand-in (same attributes, recorded poses) in this environment."""

    def __init__(self, sdk):
        self.sdk = sdk

    def connect(self) -> bool:
        init = getattr(self.sdk, "Initialize", None)
        if init is not None:
            init()
        return True

    def disconnect(self) -> None:
        close = getattr(self.sdk, "Close", None)
        if close is not None:
            close()

    def get_coordinates(self) -> Tuple[np.ndarray, np.ndarray]:
        self.sdk.Run()
        coords = np.zeros((3, 6))
        flags = np.zeros(3, bool)
        for row, n in enumerate((1, 2, 3)):  # probe, reference, coil
            try:
                coords[row] = vendor_coords.claron_pose(
                    float(getattr(self.sdk, f"PositionTooltipX{n}")),
                    float(getattr(self.sdk, f"PositionTooltipY{n}")),
                    float(getattr(self.sdk, f"PositionTooltipZ{n}")),
                    float(getattr(self.sdk, f"AngleZ{n}")),
                    float(getattr(self.sdk, f"AngleY{n}")),
                    float(getattr(self.sdk, f"AngleX{n}")))
                flags[row] = bool(getattr(self.sdk, f"Visible{n}", True))
            except AttributeError:
                pass
        return coords, flags


class ReplayMTC:
    """pyclaron attribute-API stand-in fed by recorded poses (each pose:
    3 bodies x [x, y, z, az, ay, ax])."""

    def __init__(self, poses: Sequence[Sequence[Sequence[float]]],
                 loop: bool = True):
        self.poses = [np.asarray(p, float) for p in poses]
        self.loop = loop
        self.i = -1

    def Run(self):
        if self.i + 1 < len(self.poses) or self.loop:
            self.i = (self.i + 1) % len(self.poses)
        p = self.poses[self.i]
        for n in range(3):
            x, y, z, az, ay, ax = p[n]
            setattr(self, f"PositionTooltipX{n + 1}", x)
            setattr(self, f"PositionTooltipY{n + 1}", y)
            setattr(self, f"PositionTooltipZ{n + 1}", z)
            setattr(self, f"AngleZ{n + 1}", az)
            setattr(self, f"AngleY{n + 1}", ay)
            setattr(self, f"AngleX{n + 1}", ax)
            setattr(self, f"Visible{n + 1}", True)

"""DICOM networking: C-ECHO / C-FIND / C-MOVE client + C-STORE storage SCP
(port of invesalius3_tpu/net/dicom_net.py; host sockets and bytes, no
tensors).

Reference: invesalius/net/dicom.py ``DicomNet`` — C-ECHO :42, C-FIND
patient query :46, C-MOVE retrieve :135 via GDCM's network classes.

A native DIMSE implementation over TCP: A-ASSOCIATE-RQ/AC, C-ECHO,
study-root C-FIND, and C-MOVE with an in-process storage SCP
(``StorageSCP``) that receives the moved instances over incoming C-STORE
associations and writes Part-10 files — the piece GDCM's
``ServiceClassUser::SendMove`` hides.  A C-STORE SCU (``send_c_store``)
rounds out the conformance surface and powers the loopback tests.

Every PDU sent and every file written is the JAX module's, byte for byte.
Two internal differences: the storage SCP gathers a dataset's PDV
fragments in a ``bytearray`` and reads PDUs into a preallocated buffer
(the JAX SCP concatenates ``bytes``, which copies a 512 KiB instance's 33
fragments into about 9 MB of intermediate buffers); and every socket has
Nagle's algorithm off (``TCP_NODELAY``), so an exchange of several small
PDUs does not wait for a delayed ACK (``_connect``).
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from pathlib import Path
from typing import Dict, List, Optional

VERIFICATION_SOP = "1.2.840.10008.1.1"
STUDY_ROOT_FIND = "1.2.840.10008.5.1.4.1.2.2.1"
STUDY_ROOT_MOVE = "1.2.840.10008.5.1.4.1.2.2.2"
CT_STORAGE = "1.2.840.10008.5.1.4.1.1.2"
MR_STORAGE = "1.2.840.10008.5.1.4.1.1.4"
SC_STORAGE = "1.2.840.10008.5.1.4.1.1.7"
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"


def _pdu(pdu_type: int, payload: bytes) -> bytes:
    return struct.pack(">BBI", pdu_type, 0, len(payload)) + payload


def _item(item_type: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", item_type, 0, len(payload)) + payload


def _uid(s: str) -> bytes:
    b = s.encode("ascii")
    return b + (b"\x00" if len(b) % 2 else b"")


class DicomNet:
    """PACS client (reference DicomNet API surface)."""

    def __init__(self, host: str = "", port: int = 104,
                 aetitle_call: str = "ANYSCP", aetitle: str = "INVESALIUS"):
        self.host = host
        self.port = port
        self.aetitle_call = aetitle_call
        self.aetitle = aetitle

    def SetHost(self, host):  # reference-compatible setters
        self.host = host

    def SetPort(self, port):
        self.port = int(port)

    def SetAETitleCall(self, aetitle):
        self.aetitle_call = aetitle

    def SetAETitle(self, aetitle):
        self.aetitle = aetitle

    def _associate(self, sock: socket.socket, abstract_syntax: str) -> bool:
        app_context = _item(0x10, _uid("1.2.840.10008.3.1.1.1"))
        pres_context = _item(
            0x20,
            struct.pack(">BBBB", 1, 0, 0, 0)
            + _item(0x30, _uid(abstract_syntax))
            + _item(0x40, _uid(IMPLICIT_VR_LE)),
        )
        user_info = _item(0x50, _item(0x51, struct.pack(">I", 16384)))
        called = self.aetitle_call.ljust(16).encode("ascii")
        calling = self.aetitle.ljust(16).encode("ascii")
        payload = (
            struct.pack(">HH", 1, 0) + called + calling + b"\x00" * 32
            + app_context + pres_context + user_info
        )
        sock.sendall(_pdu(0x01, payload))
        head = _recv_exact(sock, 6)
        if head is None:
            return False
        (length,) = struct.unpack(">I", head[2:6])
        _recv_exact(sock, length)  # consume the full AC/RJ payload
        return head[0] == 0x02  # A-ASSOCIATE-AC

    def RunCEcho(self, timeout: float = 5.0) -> bool:
        """C-ECHO: associate on the Verification SOP class (reference
        dicom.py:42).  Returns True if the SCP accepts the association and
        answers the echo."""
        try:
            with _connect(self.host, self.port, timeout) as s:
                if not self._associate(s, VERIFICATION_SOP):
                    return False
                # C-ECHO-RQ command set (implicit VR LE group 0000)
                def el(tag_elem: int, vr_payload: bytes) -> bytes:
                    return struct.pack("<HHI", 0x0000, tag_elem, len(vr_payload)) + vr_payload

                cmd = b"".join([
                    el(0x0002, _uid(VERIFICATION_SOP)),
                    el(0x0100, struct.pack("<H", 0x0030)),  # C-ECHO-RQ
                    el(0x0110, struct.pack("<H", 1)),  # message id
                    el(0x0800, struct.pack("<H", 0x0101)),  # no dataset
                ])
                group_len = el(0x0000, struct.pack("<I", len(cmd)))
                full = group_len + cmd
                pdv = struct.pack(">IB", len(full) + 2, 1) + b"\x03" + full
                s.sendall(_pdu(0x04, pdv))
                rsp = s.recv(6)
                # release
                s.sendall(_pdu(0x05, b"\x00" * 4))
                return len(rsp) == 6 and rsp[0] == 0x04
        except OSError:
            return False

    def RunCFind(self, patient_name: str = "*", level: str = "STUDY",
                 timeout: float = 10.0):
        """Study-root C-FIND (reference dicom.py:46): returns a list of
        matched identifier dicts ({tag_name: value})."""
        results = []
        try:
            with _connect(self.host, self.port, timeout) as s:
                if not self._associate(s, STUDY_ROOT_FIND):
                    return results

                def el(elem: int, payload: bytes, group: int = 0x0000) -> bytes:
                    return struct.pack("<HHI", group, elem, len(payload)) + payload

                # command set
                cmd = b"".join([
                    el(0x0002, _uid(STUDY_ROOT_FIND)),
                    el(0x0100, struct.pack("<H", 0x0020)),  # C-FIND-RQ
                    el(0x0110, struct.pack("<H", 1)),
                    el(0x0700, struct.pack("<H", 0)),  # priority MEDIUM
                    el(0x0800, struct.pack("<H", 0x0000)),  # dataset follows
                ])
                cmd = el(0x0000, struct.pack("<I", len(cmd))) + cmd

                # identifier dataset (implicit VR LE)
                def ds_el(group, elem, text):
                    b = text.encode("ascii")
                    if len(b) % 2:
                        b += b" "
                    return struct.pack("<HHI", group, elem, len(b)) + b

                ident = b"".join([
                    ds_el(0x0008, 0x0052, level),  # QueryRetrieveLevel
                    ds_el(0x0010, 0x0010, patient_name),
                    ds_el(0x0010, 0x0020, ""),  # PatientID (return)
                    ds_el(0x0020, 0x000D, ""),  # StudyInstanceUID (return)
                    ds_el(0x0008, 0x1030, ""),  # StudyDescription (return)
                ])
                s.sendall(_pdu(0x04, struct.pack(">IB", len(cmd) + 2, 1) + b"\x03" + cmd))
                s.sendall(_pdu(0x04, struct.pack(">IB", len(ident) + 2, 1) + b"\x02" + ident))

                # read response PDUs until final status
                while True:
                    head = _recv_exact(s, 6)
                    if head is None or head[0] != 0x04:
                        break
                    (length,) = struct.unpack(">I", head[2:6])
                    payload = _recv_exact(s, length)
                    if payload is None:
                        break
                    pos = 0
                    while pos + 6 <= len(payload):
                        (pdv_len,) = struct.unpack(">I", payload[pos : pos + 4])
                        mch = payload[pos + 5]
                        data = payload[pos + 6 : pos + 4 + pdv_len]
                        pos += 4 + pdv_len
                        if mch & 0x01:  # command
                            status = _read_implicit_tag(data, 0x0000, 0x0900)
                            if status is not None and status not in (0xFF00, 0xFF01):
                                s.sendall(_pdu(0x05, b"\x00" * 4))
                                return results
                        else:  # dataset (a match)
                            from invesalius3_tpu_torch.io.dicom import _parse_elements

                            tags, _, _ = _parse_elements(data, 0, False, False)
                            results.append(tags)
        except OSError:
            pass
        return results

    def RunCMove(self, study_uid: str, dest_folder, listen_port: int = 0,
                 timeout: float = 30.0) -> List[str]:
        """Study-root C-MOVE (reference dicom.py:135): starts a local
        ``StorageSCP`` on `listen_port` (0 = ephemeral), asks the PACS to
        move `study_uid` to our AE title, and returns the file paths the
        SCP received.  The PACS must map our AE title to this host/port
        (standard C-MOVE plumbing)."""
        received: List[str] = []
        scp = StorageSCP(dest_folder, port=listen_port, aetitle=self.aetitle,
                         received_files=received)
        scp.start()
        try:
            with _connect(self.host, self.port, timeout) as s:
                if not self._associate(s, STUDY_ROOT_MOVE):
                    raise ConnectionError("PACS rejected the MOVE association")

                def el(elem: int, payload: bytes) -> bytes:
                    return struct.pack("<HHI", 0x0000, elem, len(payload)) + payload

                dest = self.aetitle.ljust(16).encode("ascii")
                cmd = b"".join([
                    el(0x0002, _uid(STUDY_ROOT_MOVE)),
                    el(0x0100, struct.pack("<H", 0x0021)),  # C-MOVE-RQ
                    el(0x0110, struct.pack("<H", 1)),
                    el(0x0600, dest),                        # MoveDestination
                    el(0x0700, struct.pack("<H", 0)),
                    el(0x0800, struct.pack("<H", 0x0000)),   # dataset follows
                ])
                cmd = el(0x0000, struct.pack("<I", len(cmd))) + cmd

                def ds_el(group, elem, text):
                    b = text.encode("ascii")
                    if len(b) % 2:
                        b += b" " if group != 0x0020 else b"\x00"
                    return struct.pack("<HHI", group, elem, len(b)) + b

                ident = b"".join([
                    ds_el(0x0008, 0x0052, "STUDY"),
                    ds_el(0x0020, 0x000D, study_uid),
                ])
                s.sendall(_pdu(0x04, struct.pack(">IB", len(cmd) + 2, 1) + b"\x03" + cmd))
                s.sendall(_pdu(0x04, struct.pack(">IB", len(ident) + 2, 1) + b"\x02" + ident))

                s.settimeout(timeout)
                while True:
                    head = _recv_exact(s, 6)
                    if head is None or head[0] != 0x04:
                        break
                    (length,) = struct.unpack(">I", head[2:6])
                    payload = _recv_exact(s, length)
                    if payload is None:
                        break
                    status = None
                    pos = 0
                    while pos + 6 <= len(payload):
                        (pdv_len,) = struct.unpack(">I", payload[pos:pos + 4])
                        mch = payload[pos + 5]
                        data = payload[pos + 6:pos + 4 + pdv_len]
                        pos += 4 + pdv_len
                        if mch & 0x01:
                            status = _read_implicit_tag(data, 0x0000, 0x0900)
                    if status is not None and status not in (0xFF00, 0xFF01):
                        s.sendall(_pdu(0x05, b"\x00" * 4))
                        _recv_exact(s, 6)  # release response (best effort)
                        break
        finally:
            scp.stop()
        return received


def _connect(host: str, port: int, timeout: float) -> socket.socket:
    """A TCP connection with Nagle's algorithm off: a command PDU and the
    PDUs after it leave at once instead of waiting for the peer's delayed
    ACK (about 40 ms an exchange); the bytes are the same."""
    s = socket.create_connection((host, port), timeout=timeout)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def _recv_exact(sock: socket.socket, n: int):
    """Exactly ``n`` bytes from ``sock`` (None if the peer closes first),
    read into one preallocated buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return bytes(buf)


def _read_implicit_tag(data: bytes, group: int, elem: int):
    pos = 0
    while pos + 8 <= len(data):
        g, e, length = struct.unpack_from("<HHI", data, pos)
        pos += 8
        if (g, e) == (group, elem):
            if length >= 2:
                return struct.unpack_from("<H", data, pos)[0]
            return None
        pos += length
    return None


def _read_implicit_text(data: bytes, group: int, elem: int) -> Optional[str]:
    pos = 0
    while pos + 8 <= len(data):
        g, e, length = struct.unpack_from("<HHI", data, pos)
        pos += 8
        if (g, e) == (group, elem):
            return bytes(data[pos:pos + length]).decode("ascii", "replace").strip("\x00 ")
        pos += length
    return None


# ---------------------------------------------------------------------------
# Storage SCP: receive C-STORE associations, write Part-10 files
# ---------------------------------------------------------------------------

_ACCEPTED_STORAGE = {VERIFICATION_SOP, CT_STORAGE, MR_STORAGE, SC_STORAGE,
                     # enhanced CT/MR + PET + secondary-capture multiframe
                     "1.2.840.10008.5.1.4.1.1.2.1",
                     "1.2.840.10008.5.1.4.1.1.4.1",
                     "1.2.840.10008.5.1.4.1.1.128"}


def _parse_associate_rq(payload: bytes):
    """-> [(ctx_id, abstract_syntax, [transfer_syntaxes])]"""
    contexts = []
    pos = 68  # version(2) + reserved(2) + called(16) + calling(16) + reserved(32)
    n = len(payload)
    while pos + 4 <= n:
        item_type = payload[pos]
        (ln,) = struct.unpack_from(">H", payload, pos + 2)
        body = payload[pos + 4:pos + 4 + ln]
        if item_type == 0x20:  # presentation context
            ctx_id = body[0]
            sub = 4
            abstract = ""
            syntaxes = []
            while sub + 4 <= len(body):
                st = body[sub]
                (sl,) = struct.unpack_from(">H", body, sub + 2)
                sb = body[sub + 4:sub + 4 + sl]
                if st == 0x30:
                    abstract = sb.decode("ascii").strip("\x00")
                elif st == 0x40:
                    syntaxes.append(sb.decode("ascii").strip("\x00"))
                sub += 4 + sl
            contexts.append((ctx_id, abstract, syntaxes))
        pos += 4 + ln
    return contexts


class _StoreHandler(socketserver.BaseRequestHandler):
    def handle(self):  # one association per connection
        srv: "StorageSCP" = self.server.scp  # type: ignore[attr-defined]
        s = self.request
        s.settimeout(30.0)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            self._serve(s, srv)
        except (OSError, struct.error):
            pass

    def _serve(self, s, srv):
        head = _recv_exact(s, 6)
        if head is None or head[0] != 0x01:
            return
        (length,) = struct.unpack(">I", head[2:6])
        payload = _recv_exact(s, length)
        if payload is None:
            return
        contexts = _parse_associate_rq(payload)

        # accept implicit/explicit LE on known storage classes
        ctx_ts: Dict[int, str] = {}
        ac_items = _item(0x10, _uid("1.2.840.10008.3.1.1.1"))
        for ctx_id, abstract, syntaxes in contexts:
            chosen = next((t for t in (IMPLICIT_VR_LE, EXPLICIT_VR_LE)
                           if t in syntaxes), None)
            ok = abstract in _ACCEPTED_STORAGE and chosen is not None
            result = 0 if ok else 3  # 3 = abstract syntax not supported
            ts = chosen or IMPLICIT_VR_LE
            if ok:
                ctx_ts[ctx_id] = ts
            ac_items += _item(
                0x21, struct.pack(">BBBB", ctx_id, 0, result, 0) + _item(0x40, _uid(ts)))
        ac_items += _item(0x50, _item(0x51, struct.pack(">I", 65536)))
        fixed = payload[:68]  # echo version + AE titles back
        s.sendall(_pdu(0x02, fixed + ac_items))

        cmd_buf = bytearray()
        ds_buf = bytearray()
        cmd: Dict[str, object] = {}
        while True:
            head = _recv_exact(s, 6)
            if head is None:
                return
            pdu_type = head[0]
            (length,) = struct.unpack(">I", head[2:6])
            payload = _recv_exact(s, length)
            if payload is None:
                return
            if pdu_type == 0x05:  # A-RELEASE-RQ
                s.sendall(_pdu(0x06, b"\x00" * 4))
                return
            if pdu_type == 0x07:  # A-ABORT
                return
            if pdu_type != 0x04:
                continue
            view = memoryview(payload)
            pos = 0
            while pos + 6 <= len(payload):
                (pdv_len,) = struct.unpack_from(">I", payload, pos)
                ctx_id = payload[pos + 4]
                mch = payload[pos + 5]
                data = view[pos + 6:pos + 4 + pdv_len]
                pos += 4 + pdv_len
                if mch & 0x01:  # command fragment
                    cmd_buf += data
                    if mch & 0x02:  # last
                        cmd = {
                            "field": _read_implicit_tag(cmd_buf, 0x0000, 0x0100),
                            "msg_id": _read_implicit_tag(cmd_buf, 0x0000, 0x0110),
                            "sop_class": _read_implicit_text(cmd_buf, 0x0000, 0x0002),
                            "sop_instance": _read_implicit_text(cmd_buf, 0x0000, 0x1000),
                            "no_dataset": _read_implicit_tag(cmd_buf, 0x0000, 0x0800) == 0x0101,
                        }
                        cmd_buf = bytearray()
                        if cmd["field"] == 0x0030:  # C-ECHO-RQ
                            self._respond(s, ctx_id, 0x8030, cmd, status=0)
                            cmd = {}
                else:  # dataset fragment
                    ds_buf += data
                    if mch & 0x02 and cmd.get("field") == 0x0001:  # C-STORE-RQ
                        path = srv._write_instance(
                            ds_buf, str(cmd.get("sop_class") or SC_STORAGE),
                            str(cmd.get("sop_instance") or f"1.2.3.{len(srv.received_files)}"),
                            ctx_ts.get(ctx_id, IMPLICIT_VR_LE))
                        srv.received_files.append(path)
                        self._respond(s, ctx_id, 0x8001, cmd, status=0)
                        ds_buf = bytearray()
                        cmd = {}

    @staticmethod
    def _respond(s, ctx_id: int, field: int, cmd: Dict[str, object], status: int):
        def el(elem, payload_):
            return struct.pack("<HHI", 0x0000, elem, len(payload_)) + payload_

        body = b"".join([
            el(0x0002, _uid(str(cmd.get("sop_class") or VERIFICATION_SOP))),
            el(0x0100, struct.pack("<H", field)),
            el(0x0120, struct.pack("<H", int(cmd.get("msg_id") or 1))),
            el(0x0800, struct.pack("<H", 0x0101)),
            el(0x0900, struct.pack("<H", status)),
        ])
        full = el(0x0000, struct.pack("<I", len(body))) + body
        s.sendall(_pdu(0x04, struct.pack(">IB", len(full) + 2, ctx_id) + b"\x03" + full))


class _ThreadedTCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class StorageSCP:
    """Listen for incoming C-STORE associations and write each received
    instance as a Part-10 file into `folder` (what GDCM spawns internally
    during a MOVE; reference net/dicom.py:135 RunCMove)."""

    def __init__(self, folder, port: int = 0, aetitle: str = "INVESALIUS",
                 received_files: Optional[List[str]] = None):
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.aetitle = aetitle
        self.received_files: List[str] = (
            received_files if received_files is not None else [])
        self._server = _ThreadedTCP(("127.0.0.1", port), _StoreHandler)
        self._server.scp = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        # a short poll, so that stop() (a C-MOVE's end) waits 50 ms at most
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            name="storage-scp", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _write_instance(self, dataset: bytes, sop_class: str,
                        sop_instance: str, transfer_syntax: str) -> str:
        """Wrap the received dataset in a Part-10 header."""
        def meta_el(elem, vr, value):
            payload = value if isinstance(value, bytes) else _uid(str(value))
            return struct.pack("<HH2sH", 0x0002, elem, vr.encode(), len(payload)) + payload

        meta = (meta_el(0x0002, "UI", sop_class)
                + meta_el(0x0003, "UI", sop_instance)
                + meta_el(0x0010, "UI", transfer_syntax))
        meta = struct.pack("<HH2sHI", 0x0002, 0x0000, b"UL", 4, len(meta)) + meta
        name = sop_instance.replace(".", "_")[-48:] or f"img{len(self.received_files)}"
        path = self.folder / f"{name}.dcm"
        with open(path, "wb") as f:
            f.write(b"\x00" * 128 + b"DICM" + meta)
            f.write(dataset)
        return str(path)


# ---------------------------------------------------------------------------
# C-STORE SCU (send instances to a PACS / move destination)
# ---------------------------------------------------------------------------

def send_c_store(host: str, port: int, datasets, sop_class: str = CT_STORAGE,
                 transfer_syntax: str = IMPLICIT_VR_LE,
                 aetitle: str = "INVESALIUS", called: str = "ANYSCP",
                 timeout: float = 30.0) -> int:
    """Send [(sop_instance_uid, dataset_bytes)] over one association.
    dataset_bytes must already be encoded in `transfer_syntax`.  Returns
    the number of instances the SCP accepted."""
    accepted = 0
    with _connect(host, port, timeout) as s:
        app_context = _item(0x10, _uid("1.2.840.10008.3.1.1.1"))
        pres = _item(0x20, struct.pack(">BBBB", 1, 0, 0, 0)
                     + _item(0x30, _uid(sop_class))
                     + _item(0x40, _uid(transfer_syntax)))
        user_info = _item(0x50, _item(0x51, struct.pack(">I", 65536)))
        payload = (struct.pack(">HH", 1, 0) + called.ljust(16).encode()
                   + aetitle.ljust(16).encode() + b"\x00" * 32
                   + app_context + pres + user_info)
        s.sendall(_pdu(0x01, payload))
        head = _recv_exact(s, 6)
        if head is None or head[0] != 0x02:
            return 0
        (ln,) = struct.unpack(">I", head[2:6])
        _recv_exact(s, ln)

        def el(elem, payload_):
            return struct.pack("<HHI", 0x0000, elem, len(payload_)) + payload_

        for i, (sop_uid, ds) in enumerate(datasets):
            body = b"".join([
                el(0x0002, _uid(sop_class)),
                el(0x0100, struct.pack("<H", 0x0001)),  # C-STORE-RQ
                el(0x0110, struct.pack("<H", i + 1)),
                el(0x0700, struct.pack("<H", 0)),
                el(0x0800, struct.pack("<H", 0x0000)),
                el(0x1000, _uid(sop_uid)),
            ])
            body = el(0x0000, struct.pack("<I", len(body))) + body
            s.sendall(_pdu(0x04, struct.pack(">IB", len(body) + 2, 1) + b"\x03" + body))
            # dataset in <= 16k chunks
            max_chunk = 16000
            off = 0
            while off < len(ds):
                chunk = ds[off:off + max_chunk]
                off += len(chunk)
                last = 0x02 if off >= len(ds) else 0x00
                s.sendall(_pdu(0x04, struct.pack(">IB", len(chunk) + 2, 1)
                               + bytes([last]) + chunk))
            # await C-STORE-RSP
            head = _recv_exact(s, 6)
            if head is None or head[0] != 0x04:
                break
            (ln,) = struct.unpack(">I", head[2:6])
            rsp = _recv_exact(s, ln)
            if rsp is None:
                break
            status = _read_implicit_tag(rsp[6:], 0x0000, 0x0900)
            if status == 0:
                accepted += 1
        s.sendall(_pdu(0x05, b"\x00" * 4))
        _recv_exact(s, 6)
    return accepted

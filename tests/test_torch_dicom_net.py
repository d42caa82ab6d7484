"""The port's DICOM networking (``invesalius3_tpu_torch.net.dicom_net``) on
the JAX package's cases (tests/test_aux_subsystems.py: C-ECHO refused, C-FIND
against a fake SCP, a loopback C-STORE, C-MOVE against a mini-PACS), and
against the JAX module on the same exchanges: the bytes each client sends
and reads, recorded on its socket, are equal byte for byte; the
storage SCP writes byte-identical Part-10 files; C-FIND results are equal;
``/api/pacs/move`` with its import gives the JAX server's volume exactly.
Series are written with the port's ``write_dicom`` from seeded numpy
arrays.  Every socket and thread has a timeout and is closed or joined."""

import json
import socket
import struct
import threading
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
from invesalius3_tpu.core.slice import Slice as SliceJax
from invesalius3_tpu.core.volume import Volume as VolumeJax
from invesalius3_tpu.net import dicom_net as dn_jax
from invesalius3_tpu.server import ViewerServer as ServerJax
from invesalius3_tpu_torch.core.slice import Slice
from invesalius3_tpu_torch.core.volume import Volume
from invesalius3_tpu_torch.io import dicom
from invesalius3_tpu_torch.net import dicom_net as dn
from invesalius3_tpu_torch.server import ViewerServer

torch.set_num_threads(1)
STUDY = "1.2.826.0.1.3680043.8.498.77"


def _write_study(root, n=8, side=16, seed=0, uid="7.7.7", patient="PMOVE"):
    """A seeded int16 series of ``n`` slices of ``side``^2 (explicit VR LE);
    returns the paths and the [(SOP instance UID, dataset)] a C-STORE sends."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        px = rng.integers(-1000, 2000, (side, side)).astype(np.int16)
        p = root / f"src{i:03d}.dcm"
        dicom.write_dicom(p, px, {
            "PatientID": patient, "PatientName": "DOE^JANE", "Modality": "CT",
            "StudyInstanceUID": STUDY, "SeriesInstanceUID": uid,
            "SOPInstanceUID": f"{uid}.{i + 1}", "InstanceNumber": i + 1,
            "ImagePositionPatient": [0.0, 0.0, float(i)], "PixelSpacing": [1.0, 1.0],
            "StudyDate": "20260102"})
        paths.append(p)
    return paths, list(chip_smoke.pacs_instances(paths).items())


def _row(paths):
    f0 = dicom.read_dicom(paths[0])
    row = {k: f0.get(k) for k in ("StudyDate", "PatientName", "PatientID", "StudyInstanceUID")}
    row["StudyDescription"] = chip_smoke.NET_STUDY_DESCRIPTION
    return row


class _Recorded:
    """A client socket that keeps what it sends and what it reads."""

    def __init__(self, sock):
        self._s = sock
        self.sent, self.read = bytearray(), bytearray()

    def sendall(self, data):
        self.sent += data
        return self._s.sendall(data)

    def recv(self, n):
        data = self._s.recv(n)
        self.read += data
        return data

    def recv_into(self, buf, n=0):
        k = self._s.recv_into(buf, n)
        self.read += bytes(buf[:k])
        return k

    def __getattr__(self, name):
        return getattr(self._s, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._s.close()


@pytest.fixture
def recorded(monkeypatch):
    """Every client connection made through ``socket.create_connection``
    (both packages' DIMSE clients), recorded in order."""
    conns = []
    create = socket.create_connection

    def connect(*a, **kw):
        conns.append(_Recorded(create(*a, **kw)))
        return conns[-1]

    monkeypatch.setattr(socket, "create_connection", connect)
    return conns


# -- the JAX package's cases ----------------------------------------------------------

def test_dicom_net_cecho_refused():
    """No PACS: C-ECHO to a dead port returns False, not an exception."""
    net = dn.DicomNet("127.0.0.1", chip_smoke._free_port())
    assert net.RunCEcho(timeout=0.5) is False


def _fake_find_scp(srv, el):
    conn, _ = srv.accept()
    with conn:
        conn.settimeout(5.0)
        head = dn._recv_exact(conn, 6)
        dn._recv_exact(conn, struct.unpack(">I", head[2:6])[0])
        conn.sendall(dn._pdu(0x02, b"\x00" * 68))
        for _ in range(2):
            h = dn._recv_exact(conn, 6)
            dn._recv_exact(conn, struct.unpack(">I", h[2:6])[0])
        cmd = b"".join([el(0x0000, 0x0100, struct.pack("<H", 0x8020)),
                        el(0x0000, 0x0800, struct.pack("<H", 0x0000)),
                        el(0x0000, 0x0900, struct.pack("<H", 0xFF00))])
        cmd = el(0x0000, 0x0000, struct.pack("<I", len(cmd))) + cmd
        ident = b"".join([el(0x0010, 0x0010, b"DOE^JOHN"), el(0x0010, 0x0020, b"PAT1"),
                          el(0x0020, 0x000D, b"1.2.3.4 ")])
        conn.sendall(dn._pdu(0x04, struct.pack(">IB", len(cmd) + 2, 1) + b"\x03" + cmd)
                     + dn._pdu(0x04, struct.pack(">IB", len(ident) + 2, 1) + b"\x02" + ident))
        done = b"".join([el(0x0000, 0x0100, struct.pack("<H", 0x8020)),
                         el(0x0000, 0x0800, struct.pack("<H", 0x0101)),
                         el(0x0000, 0x0900, struct.pack("<H", 0x0000))])
        done = el(0x0000, 0x0000, struct.pack("<I", len(done))) + done
        conn.sendall(dn._pdu(0x04, struct.pack(">IB", len(done) + 2, 1) + b"\x03" + done))
        dn._recv_exact(conn, 10)  # the client's release


@pytest.mark.parametrize("module", [dn, dn_jax], ids=["port", "jax"])
def test_dicom_net_cfind_fake_scp(module):
    """C-FIND against a loopback fake SCP: association accepted, one pending
    match with an identifier dataset, then success; the port's result is
    the JAX module's."""
    def el(group, elem, payload):
        return struct.pack("<HHI", group, elem, len(payload)) + payload

    srv = socket.socket()
    srv.settimeout(5.0)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    th = threading.Thread(target=_fake_find_scp, args=(srv, el), daemon=True)
    th.start()
    try:
        results = module.DicomNet("127.0.0.1", srv.getsockname()[1]).RunCFind("DOE*",
                                                                              timeout=5.0)
    finally:
        th.join(timeout=5.0)
        srv.close()
    assert not th.is_alive()
    assert results == [{"PatientName": "DOE^JOHN", "PatientID": "PAT1",
                        "StudyInstanceUID": "1.2.3.4"}]


def test_storage_scp_receives_c_store(tmp_path):
    """Loopback C-STORE: SCU -> StorageSCP -> Part-10 files on disk."""
    _, datasets = _write_study(tmp_path / "src", n=3, side=8)
    scp = dn.StorageSCP(tmp_path / "received", port=0)
    scp.start()
    try:
        n = dn.send_c_store("127.0.0.1", scp.port, datasets, sop_class=dn.CT_STORAGE,
                            transfer_syntax=dn.EXPLICIT_VR_LE, timeout=10.0)
    finally:
        scp.stop()
    assert n == 3 and len(scp.received_files) == 3
    f = dicom.read_dicom(scp.received_files[0])
    assert f.get("PatientID") == "PMOVE"
    assert f.pixel_array().shape == (8, 8)


def test_run_cmove_against_mini_pacs(tmp_path):
    """Full C-MOVE loop: RunCMove drives a mini-PACS that C-STOREs the study
    back to the client's StorageSCP (reference net/dicom.py:135); the files
    hold the sent datasets byte for byte."""
    paths, datasets = _write_study(tmp_path / "src", n=2, side=8)
    store_port = chip_smoke._free_port()
    pacs = chip_smoke.MiniPACS(datasets, _row(paths), store_port, timeout=10.0).start()
    try:
        files = dn.DicomNet("127.0.0.1", pacs.port).RunCMove(
            STUDY, tmp_path / "moved", listen_port=store_port, timeout=10.0)
    finally:
        pacs.stop()
    assert len(files) == 2 and pacs.moved_bytes == sum(len(d) for _, d in datasets)
    assert chip_smoke.pacs_instances(files) == dict(datasets)
    vols = [dicom.read_dicom(f) for f in sorted(files)]
    assert all(v.get("PatientID") == "PMOVE" for v in vols)
    assert vols[0].pixel_array().shape == (8, 8)


def test_run_cmove_unknown_study_moves_nothing(tmp_path):
    paths, datasets = _write_study(tmp_path / "src", n=2, side=8)
    store_port = chip_smoke._free_port()
    pacs = chip_smoke.MiniPACS(datasets, _row(paths), store_port, timeout=10.0).start()
    try:
        files = dn.DicomNet("127.0.0.1", pacs.port).RunCMove(
            "9.9.9", tmp_path / "moved", listen_port=store_port, timeout=10.0)
    finally:
        pacs.stop()
    assert files == [] and pacs.moved_bytes == 0


# -- byte parity with the JAX module ----------------------------------------------------

def _exchange(module, op, tmp_path, datasets, row, conns):
    """Run ``op`` with ``module``'s client (and, for echo and store, its
    StorageSCP); returns (each client connection's sent and read bytes, the
    client's result, the bytes of the files the SCP wrote)."""
    tag = module.__name__.split(".")[0]
    store_port = chip_smoke._free_port()
    if op in ("echo", "store"):
        server = module.StorageSCP(tmp_path / f"scp_{tag}", port=0)
        server.start()
    else:
        server = chip_smoke.MiniPACS(datasets, row, store_port, timeout=10.0).start()
    first = len(conns)
    try:
        net = module.DicomNet("127.0.0.1", server.port)
        if op == "echo":
            result = net.RunCEcho(timeout=5.0)
        elif op == "find":
            result = net.RunCFind("DOE*", timeout=5.0)
        elif op == "move":
            result = net.RunCMove(STUDY, tmp_path / f"moved_{tag}", listen_port=store_port,
                                  timeout=10.0)
        else:
            result = module.send_c_store("127.0.0.1", server.port, datasets,
                                         sop_class=module.CT_STORAGE,
                                         transfer_syntax=module.EXPLICIT_VR_LE, timeout=10.0)
    finally:
        server.stop()
    files = (sorted(server.received_files) if op == "store" else
             sorted(result) if op == "move" else [])
    if op == "move":
        result = len(result)
    wire = [(bytes(c.sent), bytes(c.read)) for c in conns[first:]]
    return wire, result, [open(f, "rb").read() for f in files]


@pytest.mark.parametrize("op", ["echo", "find", "move", "store"])
def test_wire_bytes_equal_jax(op, tmp_path, recorded):
    """The PDUs the port's DicomNet / send_c_store send, and the answers
    they read from the port's StorageSCP (echo, store) or the mini-PACS,
    equal the JAX module's byte for byte, as do the results and the Part-10
    files written."""
    paths, datasets = _write_study(tmp_path / "src", n=3, side=16, seed=4)
    row = _row(paths)
    got = _exchange(dn, op, tmp_path, datasets, row, recorded)
    want = _exchange(dn_jax, op, tmp_path, datasets, row, recorded)
    assert got[0] and all(sent for sent, _ in got[0])
    assert got == want
    if op == "find":
        assert got[1] == [row]
    if op in ("move", "store"):
        assert len(got[2]) == 3


def test_storage_scp_files_equal_jax_from_one_stream(tmp_path, recorded):
    """One recorded client stream (an echo association, then three
    instances in several PDVs each) replayed into each package's SCP: the
    same answers and byte-identical Part-10 files."""
    _, datasets = _write_study(tmp_path / "src", n=3, side=96, seed=5)
    scp = dn.StorageSCP(tmp_path / "rec", port=0)
    scp.start()
    try:
        assert dn.DicomNet("127.0.0.1", scp.port).RunCEcho(timeout=5.0)
        assert dn.send_c_store("127.0.0.1", scp.port, datasets,
                               transfer_syntax=dn.EXPLICIT_VR_LE, timeout=10.0) == 3
    finally:
        scp.stop()
    streams = [bytes(c.sent) for c in recorded]
    assert len(streams) == 2 and len(streams[1]) > 3 * 96 * 96 * 2
    out = {}
    for module in (dn, dn_jax):
        tag = module.__name__.split(".")[0]
        server = module.StorageSCP(tmp_path / tag, port=0)
        server.start()
        answers = []
        try:
            for stream in streams:
                with socket.socket() as c:
                    c.settimeout(5.0)
                    c.connect(("127.0.0.1", server.port))
                    c.sendall(stream)
                    buf = bytearray()
                    while chunk := c.recv(65536):
                        buf += chunk
                    answers.append(bytes(buf))
        finally:
            server.stop()
        names = sorted(server.received_files)
        out[tag] = (answers, [p.rsplit("/", 1)[1] for p in names],
                    [open(p, "rb").read() for p in names])
    assert out["invesalius3_tpu_torch"] == out["invesalius3_tpu"]
    assert len(out["invesalius3_tpu"][2]) == 3 and all(out["invesalius3_tpu"][0])


def test_recv_exact_reads_across_chunks():
    a, b = socket.socketpair()
    try:
        b.sendall(b"abc")
        t = threading.Timer(0.05, lambda: b.sendall(b"defg"))
        t.start()
        assert dn._recv_exact(a, 7) == b"abcdefg"
        t.join()
        b.close()
        assert dn._recv_exact(a, 1) is None
    finally:
        a.close()
        b.close()


# -- the server's /api/pacs/move with its import -----------------------------------------

def _post(srv, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_pacs_move_import_equals_jax_server(tmp_path, monkeypatch):
    """``/api/pacs/move`` with import on an 8-slice 16^2 series beside a
    3-slice one of the same study: both servers answer alike and load the
    larger series, the port's volume equal to the JAX server's exactly."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    paths, datasets = _write_study(tmp_path / "src", n=8, side=16, seed=6)
    paths2, datasets2 = _write_study(tmp_path / "src2", n=3, side=16, seed=7, uid="7.7.8")
    row = _row(paths)
    base = np.zeros((4, 8, 8), np.int16)
    port = ViewerServer(Slice(Volume.from_numpy(base, device="cpu"))).start()
    jax_ = ServerJax(SliceJax(VolumeJax.from_numpy(base))).start()
    out = {}
    try:
        for name, srv in (("port", port), ("jax", jax_)):
            store_port = chip_smoke._free_port()
            pacs = chip_smoke.MiniPACS(datasets + datasets2, row, store_port,
                                       timeout=10.0).start()
            try:
                body = {"host": "127.0.0.1", "port": pacs.port}
                echo = _post(srv, "/api/pacs/echo", body)
                find = _post(srv, "/api/pacs/find", {**body, "patient_name": "DOE*"})
                code, moved = _post(srv, "/api/pacs/move", {
                    **body, "study_uid": STUDY, "dest": str(tmp_path / f"moved_{name}"),
                    "listen_port": store_port, "timeout": 10.0})
            finally:
                pacs.stop()
            moved["files"] = sorted(p.rsplit("/", 1)[1] for p in moved["files"])
            out[name] = (echo, find, code, moved)
        got = port.state.slice.matrix.numpy()
        want = np.asarray(jax_.state.slice.matrix)
    finally:
        port.stop()
        jax_.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0] == (200, {"ok": True}) and out["port"][1] == (200, [row])
    assert len(out["port"][3]["files"]) == 11 and out["port"][3]["shape"] == [8, 16, 16]
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert port.state.surfaces == {} and port.state.crop_box is None

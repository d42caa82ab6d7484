"""The port's DICOM reader and writer (``io/dicom.py``) against the JAX
package's, on the same seeded slices.

Compared: the bytes ``write_dicom`` writes for every transfer syntax; the
tags, pixel arrays and rescaled slices read back, bit for bit, for every
decodable syntax (the lossy ones equal the JAX decoder's output); implicit
VR and headerless files; grouping, sort order, z spacing, preview rows and
thumbnails; ``group_to_volume`` (data, spacing and affine) with
``device="cpu"``.  ``fix_gantry_tilt`` on the CPU equals the JAX function
on the CPU voxel for voxel on every case here: it follows the JAX
arithmetic step by step in float32 (the stated tolerance, which the card
run also holds, is equality on at least 99.9% of voxels and one grey level
everywhere).  A deflated dataset is read from its inflated bytes; the JAX
reader fails on it (see the module docstring).
"""

import struct
import zlib

import numpy as np
import pytest
import torch

from invesalius3_tpu.io import dicom as dicom_jax
from invesalius3_tpu_torch.io import dicom
from invesalius3_tpu_torch.io import dicom_codecs as codecs

torch.set_num_threads(1)


def _tags(i=0, series="1.2.3.4", **extra):
    tags = {
        "PatientID": "P1", "PatientName": "Test^Patient", "Modality": "CT",
        "StudyInstanceUID": "1.2.3", "SeriesInstanceUID": series,
        "SOPInstanceUID": f"{series}.{i + 1}", "SeriesDescription": "HEAD 0.5",
        "StudyDate": "20260101", "StudyTime": "120000",
        "InstanceNumber": i + 1, "ImagePositionPatient": [-64.0, -80.5, 2.0 * i],
        "ImageOrientationPatient": [1, 0, 0, 0, 1, 0], "PixelSpacing": [0.5, 0.625],
        "SliceThickness": 2.0, "RescaleSlope": 1.0, "RescaleIntercept": -1024.0,
        "WindowCenter": 40, "WindowWidth": 400,
    }
    tags.update(extra)
    return tags


# the slice each syntax is written with (a smooth image for the lossy ones)
def _pixels(syntax, seed=0, shape=(24, 20)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    smooth = 2048 + 700 * np.sin(yy / 6.0) * np.cos(xx / 9.0)
    if syntax == codecs.JPEG_BASELINE:
        return (128 + 60 * np.sin(yy / 5.0) * np.cos(xx / 7.0)).astype(np.uint8)
    if syntax == codecs.JPEG_EXTENDED:
        return smooth.astype(np.uint16)
    if syntax in (codecs.JPEG_LS_NEAR, codecs.J2K, codecs.J2K_LOSSLESS):
        return (smooth + rng.integers(0, 9, shape)).astype(np.uint16)
    return rng.integers(-1024, 3000, shape).astype(np.int16)


SYNTAXES = {
    "explicit": dicom.EXPLICIT_VR_LE, "rle": codecs.RLE_LOSSLESS,
    "jpegll-p14": codecs.JPEG_LOSSLESS_P14, "jpegll-sv1": codecs.JPEG_LOSSLESS_SV1,
    "j2k-lossless": codecs.J2K_LOSSLESS, "j2k": codecs.J2K,
    "jpeg-baseline": codecs.JPEG_BASELINE, "jpeg-extended": codecs.JPEG_EXTENDED,
    "jpegls": codecs.JPEG_LS_LOSSLESS, "jpegls-near": codecs.JPEG_LS_NEAR,
}
LOSSY = {codecs.J2K, codecs.JPEG_BASELINE, codecs.JPEG_EXTENDED, codecs.JPEG_LS_NEAR}


def _same_tags(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] and type(got[k]) is type(want[k]), k


@pytest.mark.parametrize("name", sorted(SYNTAXES))
def test_write_and_read_every_syntax(tmp_path, name):
    ts = SYNTAXES[name]
    px = _pixels(ts)
    dicom.write_dicom(tmp_path / "port.dcm", px, _tags(), transfer_syntax=ts)
    dicom_jax.write_dicom(tmp_path / "jax.dcm", px, _tags(), transfer_syntax=ts)
    data = (tmp_path / "port.dcm").read_bytes()
    assert data == (tmp_path / "jax.dcm").read_bytes()
    got, want = dicom.read_dicom(tmp_path / "port.dcm"), dicom_jax.read_dicom(tmp_path / "jax.dcm")
    _same_tags(got.tags, want.tags)
    assert (got.transfer_syntax, got.pixel_offset, got.pixel_length, got.fragments) == (
        want.transfer_syntax, want.pixel_offset, want.pixel_length, want.fragments)
    arr = got.pixel_array()
    assert arr.dtype == want.pixel_array().dtype
    assert np.array_equal(arr, want.pixel_array())
    if ts not in LOSSY:
        assert np.array_equal(arr, px)
    assert np.array_equal(got.rescaled_slice(), want.rescaled_slice())
    assert got.rescaled_slice().dtype == np.int16


def test_write_guards_as_the_jax_package(tmp_path):
    signed = np.full((8, 8), -1000, np.int16)
    for ts, match in ((codecs.JPEG_EXTENDED, "12-bit unsigned"),
                      (codecs.JPEG_LS_NEAR, "signed"),
                      ("1.2.3.4.5", "unsupported transfer syntax")):
        with pytest.raises(dicom.DicomError, match=match):
            dicom.write_dicom(tmp_path / "a.dcm", signed, _tags(), transfer_syntax=ts)
        with pytest.raises(dicom_jax.DicomError, match=match):
            dicom_jax.write_dicom(tmp_path / "b.dcm", signed, _tags(), transfer_syntax=ts)


def _implicit(explicit: bytes, headerless: bool) -> bytes:
    """The same dataset with implicit VR (4-byte lengths, no VR), under an
    implicit-VR file meta, or with no preamble and no meta at all."""
    pos = 132
    while struct.unpack_from("<H", explicit, pos)[0] == 0x0002:
        vr = explicit[pos + 4:pos + 6]
        n, head = ((struct.unpack_from("<I", explicit, pos + 8)[0], 12)
                   if vr in (b"OB", b"OW", b"UN") else
                   (struct.unpack_from("<H", explicit, pos + 6)[0], 8))
        pos += head + n
    out = b""
    while pos < len(explicit):
        group, elem = struct.unpack_from("<HH", explicit, pos)
        vr = explicit[pos + 4:pos + 6]
        if vr in (b"OB", b"OW"):
            n, head = struct.unpack_from("<I", explicit, pos + 8)[0], 12
        else:
            n, head = struct.unpack_from("<H", explicit, pos + 6)[0], 8
        out += struct.pack("<HHI", group, elem, n) + explicit[pos + head:pos + head + n]
        pos += head + n
    if headerless:
        return out
    ts = dicom.IMPLICIT_VR_LE.encode() + b"\x00"
    meta = struct.pack("<HH2sH", 0x0002, 0x0010, b"UI", len(ts)) + ts
    return (b"\x00" * 128 + b"DICM" + struct.pack("<HH2sHI", 0x0002, 0x0000, b"UL", 4,
                                                  len(meta)) + meta + out)


@pytest.mark.parametrize("form", ["implicit", "headerless-implicit", "headerless-explicit"])
def test_implicit_vr_and_headerless_files(tmp_path, form):
    px = _pixels(dicom.EXPLICIT_VR_LE, seed=3)
    dicom_jax.write_dicom(tmp_path / "e.dcm", px, _tags())
    explicit = (tmp_path / "e.dcm").read_bytes()
    if form == "headerless-explicit":
        body = explicit[132 + 12 + struct.unpack_from("<I", explicit, 140)[0]:]
    else:
        body = _implicit(explicit, form.startswith("headerless"))
    (tmp_path / "f.dcm").write_bytes(body)
    assert dicom.is_dicom(tmp_path / "f.dcm") and dicom_jax.is_dicom(tmp_path / "f.dcm")
    got, want = dicom.read_dicom(tmp_path / "f.dcm"), dicom_jax.read_dicom(tmp_path / "f.dcm")
    _same_tags(got.tags, want.tags)
    assert got.get("Rows") == 24 and got.get("PatientID") == "P1"
    assert got.transfer_syntax == want.transfer_syntax == (
        dicom.EXPLICIT_VR_LE if form.endswith("explicit") else dicom.IMPLICIT_VR_LE)
    assert np.array_equal(got.pixel_array(), px)
    assert np.array_equal(want.pixel_array(), px)


def test_garbage_and_small_files(tmp_path):
    (tmp_path / "not.dcm").write_bytes(b"hello world" * 20)
    (tmp_path / "tiny.dcm").write_bytes(b"\x08\x00" * 10)
    for p in ("not.dcm", "tiny.dcm"):
        assert dicom.is_dicom(tmp_path / p) == dicom_jax.is_dicom(tmp_path / p)
    with pytest.raises(dicom.DicomError, match="too small"):
        dicom.read_dicom(tmp_path / "tiny.dcm")
    assert dicom.load_dicom_dir(tmp_path) == [] == dicom_jax.load_dicom_dir(tmp_path)
    assert not dicom.is_dicom(tmp_path / "missing.dcm")


def _deflate(explicit: bytes) -> bytes:
    """An explicit-VR file rewritten as Deflated Explicit VR LE: the file
    meta names .1.2.1.99 and the dataset after it is raw-deflated."""
    meta_end = 132 + 12 + struct.unpack_from("<I", explicit, 140)[0]
    ts = dicom.DEFLATED_LE.encode()
    ts += b"\x00" * (len(ts) % 2)
    meta = struct.pack("<HH2sH", 0x0002, 0x0010, b"UI", len(ts)) + ts
    comp = zlib.compressobj(9, zlib.DEFLATED, -15)
    body = comp.compress(explicit[meta_end:]) + comp.flush()
    return (b"\x00" * 128 + b"DICM" + struct.pack("<HH2sHI", 0x0002, 0x0000, b"UL", 4,
                                                  len(meta)) + meta + body)


@pytest.mark.parametrize("dtype", [np.int16, np.uint16, np.uint8])
def test_deflated_dataset_reads_its_inflated_pixels(tmp_path, dtype):
    """The port reads a deflated file's pixels from the inflated dataset.
    The JAX reader parses the header but seeks the inflated pixel offset in
    the compressed file, and raises: a fault of the reference the port
    does not copy."""
    px = np.random.default_rng(0).integers(0, 200, (64, 64)).astype(dtype)
    dicom.write_dicom(tmp_path / "e.dcm", px, _tags())
    (tmp_path / "d.dcm").write_bytes(_deflate((tmp_path / "e.dcm").read_bytes()))
    got = dicom.read_dicom(tmp_path / "d.dcm")
    want = dicom_jax.read_dicom(tmp_path / "d.dcm")
    assert got.transfer_syntax == want.transfer_syntax == dicom.DEFLATED_LE
    _same_tags(got.tags, want.tags)
    assert np.array_equal(got.pixel_array(), px)
    with pytest.raises(ValueError):
        want.pixel_array()
    assert np.array_equal(got.rescaled_slice(),
                          dicom.read_dicom(tmp_path / "e.dcm").rescaled_slice())


def test_big_endian_and_unknown_syntaxes_are_refused(tmp_path):
    dicom.write_dicom(tmp_path / "e.dcm", _pixels(dicom.EXPLICIT_VR_LE), _tags())
    data = (tmp_path / "e.dcm").read_bytes()
    # UIDs of the written UID's padded length, so the meta lengths hold
    for ts, match in ((dicom.EXPLICIT_VR_BE + "\x00", "big-endian"),
                      ("1.2.840.10008.1.2.99", "not supported")):
        p = tmp_path / "x.dcm"
        p.write_bytes(data.replace(dicom.EXPLICIT_VR_LE.encode() + b"\x00", ts.encode()))
        for reader in (dicom.read_dicom, dicom_jax.read_dicom):
            with pytest.raises(ValueError, match=match):
                reader(p)


def test_monochrome1_multiframe_and_unsigned(tmp_path):
    """A MONOCHROME1 multi-frame file (three frames in one PixelData):
    pixels, the stored-bits pivot, and a single-file volume."""
    frames = np.random.default_rng(5).integers(0, 4096, (3, 10, 12)).astype(np.uint16)
    tags = _tags(PhotometricInterpretation="MONOCHROME1", NumberOfFrames=3, Rows=10,
                 BitsStored=12, RescaleSlope=2.0, RescaleIntercept=-1000.0)
    dicom.write_dicom(tmp_path / "mf.dcm", frames.reshape(30, 12), tags)
    got, want = dicom.read_dicom(tmp_path / "mf.dcm"), dicom_jax.read_dicom(tmp_path / "mf.dcm")
    assert np.array_equal(got.pixel_array(), frames)
    assert np.array_equal(got.rescaled_slice(), want.rescaled_slice())
    g, gj = dicom.load_dicom_dir(tmp_path)[0], dicom_jax.load_dicom_dir(tmp_path)[0]
    data, spacing, affine = dicom.group_to_volume(g, device="cpu")
    wd, ws, wa = dicom_jax.group_to_volume(gj)
    assert data.shape == (3, 10, 12) and np.array_equal(data.numpy(), wd)
    assert spacing == ws and np.array_equal(affine, wa)


def _series(root, n, series, seed=0, shape=(16, 16), syntax=dicom.EXPLICIT_VR_LE,
            writer=dicom.write_dicom, order=None, **extra):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in (order or range(n)):
        px = rng.integers(0, 1200, shape).astype(np.int16)
        px[0, 0] = i
        writer(root / f"{series}_{i:03d}.dcm", px, _tags(i, series, **extra),
               transfer_syntax=syntax)


def _mixed(tmp_path):
    """Three series in nested folders: one reversed on disk, one with a
    second orientation split out, one sorted by InstanceNumber."""
    _series(tmp_path, 5, "1.2.3.4", order=[4, 2, 0, 3, 1])
    _series(tmp_path / "b", 3, "9.9.9", seed=1, shape=(12, 16))
    _series(tmp_path / "b" / "c", 2, "9.9.9", seed=2, shape=(12, 16),
            ImageOrientationPatient=[1, 0, 0, 0, 0, -1])
    _series(tmp_path / "d", 4, "7.7", seed=3, ImagePositionPatient=None,
            order=[2, 0, 3, 1])
    (tmp_path / "d" / "notes.txt").write_text("not a dicom file")


def _group_key(g):
    return (str(g.key), [f.path for f in g.files])


def test_grouping_sorting_and_preview(tmp_path):
    _mixed(tmp_path)
    groups, want = dicom.load_dicom_dir(tmp_path), dicom_jax.load_dicom_dir(tmp_path)
    assert [_group_key(g) for g in groups] == [_group_key(g) for g in want]
    assert len(groups) == 4
    for g, w in zip(groups, want):
        assert [f.path for f in g.sorted_files()] == [f.path for f in w.sorted_files()]
        assert g.z_spacing() == w.z_spacing() and g.title == w.title
        assert g.preview_info() == w.preview_info()
        for kw in ({}, {"size": 8}, {"index": 0, "size": 4},
                   {"window": (1, -2000)}, {"window": (4000, 0), "size": 16}):
            th = g.thumbnail(**kw)
            assert th.dtype == np.uint8 and np.array_equal(th, w.thumbnail(**kw))
    g = next(g for g in groups if len(g.files) == 5)
    assert [f.get("InstanceNumber") for f in g.sorted_files()] == [1, 2, 3, 4, 5]
    assert g.preview_info()["z_spacing"] == 2.0


def test_equal_positions_keep_the_scan_order(tmp_path):
    """Ties along the normal sort stably, in scan order, in both packages."""
    _series(tmp_path, 4, "5.5", ImagePositionPatient=[0.0, 0.0, 7.0],
            order=[3, 1, 2, 0])
    g, w = dicom.load_dicom_dir(tmp_path)[0], dicom_jax.load_dicom_dir(tmp_path)[0]
    assert [f.path for f in g.sorted_files()] == [f.path for f in w.sorted_files()]
    assert g.z_spacing() == w.z_spacing() == 2.0  # SliceThickness


@pytest.mark.parametrize("syntax", ["explicit", "rle", "jpegll-sv1"])
def test_group_to_volume_equals_the_jax_package(tmp_path, syntax):
    _mixed(tmp_path / "mixed")
    _series(tmp_path / "comp", 4, "3.3", seed=4, syntax=SYNTAXES[syntax],
            writer=dicom_jax.write_dicom)
    for root in ("mixed", "comp"):
        for g, w in zip(dicom.load_dicom_dir(tmp_path / root),
                        dicom_jax.load_dicom_dir(tmp_path / root)):
            data, spacing, affine = dicom.group_to_volume(g, device="cpu")
            wd, ws, wa = dicom_jax.group_to_volume(w)
            assert isinstance(data, torch.Tensor) and data.dtype == torch.int16
            assert np.array_equal(data.numpy(), wd)
            assert spacing == ws and np.array_equal(affine, wa)


@pytest.mark.parametrize("tilt", [-12.0, 15.0, 30.0])
def test_group_to_volume_corrects_the_gantry_tilt(tmp_path, tilt):
    _series(tmp_path, 6, "4.4", shape=(32, 12), GantryDetectorTilt=tilt,
            writer=dicom_jax.write_dicom)
    g, w = dicom.load_dicom_dir(tmp_path)[0], dicom_jax.load_dicom_dir(tmp_path)[0]
    data, spacing, affine = dicom.group_to_volume(g, device="cpu")
    wd, ws, wa = dicom_jax.group_to_volume(w)
    assert np.array_equal(data.numpy(), wd)
    assert spacing == ws and np.array_equal(affine, wa)
    flat, _, _ = dicom.group_to_volume(g, correct_tilt=False, device="cpu")
    assert np.array_equal(flat.numpy(), dicom_jax.group_to_volume(w, correct_tilt=False)[0])
    assert not torch.equal(flat, data)


def _agree(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    assert np.array_equal(got, want)  # what the CPU gives: the tolerance holds trivially


def test_gantry_tilt_straightens_the_tilted_bar():
    """The JAX test's bar: row 16 + n in slice n, tan = 1 voxel a slice."""
    vol = np.full((8, 32, 8), -1000, np.int16)
    for n in range(8):
        vol[n, 16 + n, :] = 1000
    tilt = np.degrees(np.arctan(1.0))
    out = dicom.fix_gantry_tilt(vol, (1.0, 1.0, 1.0), tilt, device="cpu")
    assert out.dtype == torch.int16
    for n in range(1, 7):
        assert out[n, 16, 4] > 900
    _agree(out.numpy(), dicom_jax.fix_gantry_tilt(vol, (1.0, 1.0, 1.0), tilt))


@pytest.mark.parametrize("tilt", [-30.0, -7.5, 0.7, 15.0, 22.5, 40.0])
@pytest.mark.parametrize("spacing", [(0.5, 0.5, 1.0), (0.7, 0.45, 2.5), (1.0, 1.0, 0.625)])
def test_gantry_tilt_on_a_seeded_volume(tilt, spacing):
    vol = np.random.default_rng(0).integers(-1024, 3000, (32, 48, 40)).astype(np.int16)
    out = dicom.fix_gantry_tilt(vol, spacing, tilt, device="cpu")
    _agree(out.numpy(), dicom_jax.fix_gantry_tilt(vol, spacing, tilt))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int32])
def test_gantry_tilt_other_dtypes_and_tensor_input(dtype):
    """Float volumes compare every float32 rounding bit for bit (no cast
    hides a difference); a tensor input gives the array input's result."""
    rng = np.random.default_rng(1)
    vol = (rng.random((9, 20, 7)) * 250).astype(dtype)
    want = dicom_jax.fix_gantry_tilt(vol, (0.8, 0.6, 1.25), 17.0)
    got = dicom.fix_gantry_tilt(torch.from_numpy(vol), (0.8, 0.6, 1.25), 17.0, device="cpu")
    assert got.dtype == torch.from_numpy(vol).dtype
    assert np.array_equal(got.numpy(), want)


def test_write_dicom_round_trips_spacing_and_affine(tmp_path):
    """Affine columns are the orientation vectors times the spacing, the
    last column the first slice's position (slices step along the normal,
    here -x)."""
    iop = [0.0, 1.0, 0.0, 0.0, 0.0, -1.0]
    for i in range(3):
        dicom.write_dicom(tmp_path / f"s{i}.dcm", np.zeros((6, 5), np.int16),
                          _tags(i, ImageOrientationPatient=iop,
                                ImagePositionPatient=[-1.5 * i, 2.0, 3.0]))
    g = dicom.load_dicom_dir(tmp_path)[0]
    data, spacing, affine = dicom.group_to_volume(g, device="cpu")
    assert spacing == (0.625, 0.5, 1.5)
    want = np.eye(4)
    want[:3, 0] = np.array(iop[:3]) * 0.625
    want[:3, 1] = np.array(iop[3:]) * 0.5
    want[:3, 2] = np.cross(iop[:3], iop[3:]) * 1.5
    want[:3, 3] = [0.0, 2.0, 3.0]
    assert np.array_equal(affine, want)

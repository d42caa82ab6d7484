"""The port's bitmap-stack and PAR/REC readers (``io/bitmap.py``,
``io/parrec.py``) against the JAX package's, on the same seeded files:
volumes, dtypes and spacings equal, and the same errors.

One difference: without Pillow the port's ``load_bitmap_dir`` raises an
ImportError that names Pillow; the JAX reader skips every file and reports
that none was readable.
"""

import sys

import numpy as np
import pytest
from PIL import Image

from invesalius3_tpu.io import bitmap as bitmap_jax
from invesalius3_tpu.io import parrec as parrec_jax
from invesalius3_tpu_torch.io import bitmap, parrec


def _same(got, want):
    (gv, gs), (wv, ws) = got, want
    assert gv.dtype == wv.dtype and np.array_equal(gv, wv)
    assert tuple(gs) == tuple(ws)


def _both_bitmap(d, *a):
    return bitmap.load_bitmap_dir(d, *a), bitmap_jax.load_bitmap_dir(d, *a)


def test_bitmap_stack(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(4):
        arr = (rng.random((10, 12)) * 255).astype(np.uint8)
        arr[0, 0] = i
        Image.fromarray(arr, "L").save(tmp_path / f"s{i}.png")
    got, want = _both_bitmap(tmp_path, (0.5, 0.5, 2.0))
    _same(got, want)
    assert got[0].shape == (4, 10, 12) and got[0].dtype == np.int16
    assert np.array_equal(got[0][:, 0, 0], np.arange(4)) and got[1] == (0.5, 0.5, 2.0)


def test_bitmap_natural_sort_and_listing(tmp_path):
    for name, val in (("s2.png", 2), ("s10.png", 10), ("S1.PNG", 1), ("notes.txt", 0)):
        if name.endswith("txt"):
            (tmp_path / name).write_text("x")
            continue
        Image.fromarray(np.full((4, 4), val, np.uint8), "L").save(tmp_path / name, "PNG")
    assert bitmap.list_bitmap_files(tmp_path) == bitmap_jax.list_bitmap_files(tmp_path)
    got, want = _both_bitmap(tmp_path)
    _same(got, want)
    assert np.array_equal(got[0][:, 0, 0], [1, 2, 10])


def test_bitmap_shape_mismatch_and_unreadable_files_are_skipped(tmp_path):
    Image.fromarray(np.full((6, 8), 1, np.uint8), "L").save(tmp_path / "a1.png")
    Image.fromarray(np.full((7, 8), 2, np.uint8), "L").save(tmp_path / "a2.png")
    (tmp_path / "a3.png").write_bytes(b"not an image")
    Image.fromarray(np.full((6, 8), 4, np.uint8), "L").save(tmp_path / "a4.bmp")
    got, want = _both_bitmap(tmp_path)
    _same(got, want)
    assert np.array_equal(got[0][:, 0, 0], [1, 4])


@pytest.mark.parametrize("kind", ["16-bit", "rgb", "float", "tiff16"])
def test_bitmap_modes(tmp_path, kind):
    rng = np.random.default_rng(1)
    for i in range(3):
        if kind in ("16-bit", "tiff16"):
            arr = rng.integers(0, 40000, (9, 11)).astype(np.uint16)
            img = Image.fromarray(arr)  # mode I;16
        elif kind == "rgb":
            img = Image.fromarray(rng.integers(0, 255, (9, 11, 3)).astype(np.uint8), "RGB")
        else:
            img = Image.fromarray(rng.random((9, 11)).astype(np.float32), "F")
        img.save(tmp_path / f"s{i}.{'tif' if kind in ('tiff16', 'float') else 'png'}")
    got, want = _both_bitmap(tmp_path)
    _same(got, want)
    if kind == "16-bit":  # above 32767 saturates, as the JAX reader does
        assert got[0].dtype == np.int16 and got[0].max() == 32767


def test_bitmap_errors(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="no bitmap slices"):
        bitmap.load_bitmap_dir(tmp_path)
    (tmp_path / "x.png").write_bytes(b"broken")
    with pytest.raises(ValueError, match="no readable bitmap"):
        bitmap.load_bitmap_dir(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        bitmap.load_bitmap_dir(tmp_path)


def _write_parrec(tmp_path, vol_pv, rs=2.0, ri=-100.0, ss=1.0,
                  spacing=(0.9, 1.1), thick=2.0, gap=0.5, name="phantom"):
    """A V4.2 PAR/REC pair in the layout of the JAX tests' helper."""
    nz, ny, nx = vol_pv.shape
    hdr = [
        "# === DATA DESCRIPTION FILE ===",
        ".    Patient name                       :   PHANTOM",
        f".    Max. number of slices/locations    :   {nz}",
        ".    Max. number of dynamics             :   1",
        f".    FOV (ap,fh,rl) [mm]                :   {ny * spacing[1]:.3f}  90.000  {nx * spacing[0]:.3f}",
        f".    Recon resolution (x, y)            :   {nx}  {ny}",
        f".    Slice thickness [mm]               :   {thick:.3f}",
        f".    Slice gap [mm]                     :   {gap:.3f}",
        "# === IMAGE INFORMATION ==",
    ]
    rows = []
    for sl in range(1, nz + 1):
        row = ([sl, 1, 1, 1, 0, 0, sl - 1, 16, 100, nx, ny, ri, rs, ss,
                50, 100] + [0.0] * 12 + [spacing[0], spacing[1]] + [0.0] * 3)
        rows.append(" ".join(f"{v:g}" for v in row))
    (tmp_path / f"{name}.PAR").write_text("\n".join(hdr + rows) + "\n")
    vol_pv.astype("<i2").tofile(tmp_path / f"{name}.REC")
    return tmp_path / f"{name}.PAR"


def _both_parrec(path, **kw):
    return parrec.read_par_rec(path, **kw), parrec_jax.read_par_rec(path, **kw)


@pytest.mark.parametrize("rs,ri", [(2.0, -100.0), (1.0, 0.0)])
def test_parrec_round_trip(tmp_path, rs, ri):
    pv = np.random.default_rng(3).integers(0, 1000, (5, 8, 6)).astype(np.int16)
    par = _write_parrec(tmp_path, pv, rs=rs, ri=ri)
    got, want = _both_parrec(par)
    _same(got, want)
    np.testing.assert_allclose(got[0], pv.astype(np.float32) * rs + ri)
    assert got[0].dtype == (np.int16 if rs == 1.0 and ri == 0.0 else np.float32)
    np.testing.assert_allclose(got[1], (0.9, 1.1, 2.5))
    _same(parrec.read_par_rec(tmp_path / "phantom.REC"), want)  # either file of the pair


def test_parrec_fov_spacing_without_the_spacing_columns(tmp_path):
    pv = np.zeros((2, 4, 6), np.int16)
    par = _write_parrec(tmp_path, pv, spacing=(0.0, 0.0))
    lines = par.read_text().replace("FOV (ap,fh,rl) [mm]                :   0.000  90.000  0.000",
                                    "FOV (ap,fh,rl) [mm]                :   8.000  90.000  9.000")
    par.write_text(lines)
    got, want = _both_parrec(par)
    _same(got, want)
    np.testing.assert_allclose(got[1], (1.5, 2.0, 2.5))


def test_parrec_interleaved_multiecho(tmp_path):
    """Rows out of REC order with a second echo interleaved: slices come
    from the 'index in REC file' column and echo 2 is not stacked."""
    nz, ny, nx = 3, 4, 4
    blocks = [(1, 2), (2, 1), (1, 1), (2, 2), (1, 3), (2, 3)]
    rng = np.random.default_rng(7)
    data = {b: rng.integers(0, 500, (ny, nx)).astype(np.int16) for b in blocks}
    hdr = [
        f".    Max. number of slices/locations    :   {nz}",
        ".    Max. number of dynamics             :   1",
        f".    Recon resolution (x, y)            :   {nx}  {ny}",
        ".    Slice thickness [mm]               :   1.0",
        ".    Slice gap [mm]                     :   0.0",
    ]
    rows = []
    for idx, (ec, sl) in enumerate(blocks):
        row = ([sl, ec, 1, 1, 0, 0, idx, 16, 100, nx, ny, 0.0, 1.0, 1.0,
                50, 100] + [0.0] * 12 + [1.0, 1.0] + [0.0] * 3)
        rows.append(" ".join(f"{v:g}" for v in row))
    (tmp_path / "m.PAR").write_text("\n".join(hdr + rows) + "\n")
    np.concatenate([data[b].ravel() for b in blocks]).astype("<i2").tofile(tmp_path / "m.REC")
    got, want = _both_parrec(tmp_path / "m.PAR")
    _same(got, want)
    for sl in range(1, nz + 1):
        np.testing.assert_allclose(got[0][sl - 1], data[(1, sl)].astype(np.float32))
    _same(*_both_parrec(tmp_path / "m.PAR", echo=2))


def _multi(tmp_path, version="V4.2", name="multi"):
    nz, ny, nx = 3, 4, 4
    header = [
        "# === GENERAL INFORMATION ===",
        f"# Research image export tool     {version}",
        ".    Max. number of slices/locations   :   3",
        ".    Max. number of dynamics           :   2",
        ".    FOV (ap,fh,rl) [mm]               :   16.0 12.0 16.0",
        ".    Recon resolution (x, y)           :   4   4",
        ".    Slice thickness [mm]              :   2.0",
        ".    Slice gap [mm]                    :   0.0",
    ]
    rows, blocks, idx = [], [], 0
    for dyn in (1, 2):
        for sl in range(1, nz + 1):
            for ec in (1, 2):
                row = [sl, ec, dyn, 1, 0, 0, idx, 16, 100, nx, ny, 0.0, 1.0, 1.0]
                row += [0.0] * 14 + [4.0, 3.0]
                rows.append(" ".join(str(v) for v in row))
                blocks.append(np.full((ny, nx), 1000 * dyn + 100 * sl + ec, np.int16))
                idx += 1
    (tmp_path / f"{name}.PAR").write_text("\n".join(header + rows) + "\n")
    np.concatenate([b.ravel() for b in blocks]).astype("<i2").tofile(tmp_path / f"{name}.REC")
    return tmp_path / f"{name}.PAR"


@pytest.mark.parametrize("select", [{}, {"echo": 2}, {"dynamic": 2}, {"dynamic": 2, "echo": 2},
                                    {"phase": 1}])
def test_parrec_volume_selection(tmp_path, select):
    par = _multi(tmp_path)
    assert parrec.list_par_volumes(par) == parrec_jax.list_par_volumes(par)
    assert {v["echo"] for v in parrec.list_par_volumes(par)} == {1, 2}
    got, want = _both_parrec(par, **select)
    _same(got, want)
    dyn, ec = select.get("dynamic", 1), select.get("echo", 1)
    assert np.array_equal(np.unique(got[0]), [1000 * dyn + 100 * s + ec for s in (1, 2, 3)])


def test_parrec_v3_rejection_and_errors(tmp_path):
    par = _multi(tmp_path)
    for reader in (parrec.read_par_rec, parrec_jax.read_par_rec):
        with pytest.raises(ValueError, match="echo"):
            reader(par, echo=9)
    v3 = _multi(tmp_path, version="V3", name="old")
    for reader in (parrec.read_par_rec, parrec_jax.read_par_rec):
        with pytest.raises(ValueError, match="V3"):
            reader(v3)
    with pytest.raises(FileNotFoundError):
        parrec.read_par_rec(tmp_path / "missing.PAR")
    pv = np.zeros((4, 4, 4), np.int16)
    small = _write_parrec(tmp_path, pv, name="small")
    (tmp_path / "small.REC").write_bytes(b"\x00" * 10)  # truncated
    with pytest.raises(ValueError, match="REC too small"):
        parrec.read_par_rec(small)
    (tmp_path / "empty.PAR").write_text("# header only\n")
    (tmp_path / "empty.REC").write_bytes(b"")
    with pytest.raises(ValueError, match="no image-information rows"):
        parrec.read_par_rec(tmp_path / "empty.PAR")


@pytest.mark.parametrize("pillow", [True, False])
def test_chip_smoke_phase_13_on_the_cpu(tmp_path, monkeypatch, pillow):
    """The card's importer phase at 32^3 on the CPU: every check it makes
    holds, with Pillow and without (then its paths must name Pillow)."""
    import torch

    import chip_smoke

    if not pillow:
        monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    out = chip_smoke.study_importers(torch.device("cpu"), tmp_path, n=32, second=8,
                                     codec_slices={"jpegls": 1, "jpegls-near": 1,
                                                   "jpeg12": 1})
    assert ("app_bitmap" in out["times"]) == pillow
    assert ("j2k" in out["decode"]) == pillow and "rle" in out["decode"]

"""The port's DICOM pixel codecs (``io/dicom_codecs.py``, ``io/jpeg12.py``,
``io/jpegls.py`` and the native ``csrc/codecs.cpp``) against the JAX
package's, on the same seeded frames.

Encoders give the same bytes in both packages.  The native decoders
(``packbits_decode``, ``jpegll_decode``) equal their plain Python versions
and the JAX package's decoders, bit for bit; the lossy decoders equal the
JAX package's output bit for bit too.  Pillow's routes go through the same
Pillow, so their bytes and pixels are equal as well.
"""

import struct
import sys

import numpy as np
import pytest

from invesalius3_tpu.io import dicom_codecs as codecs_jax
from invesalius3_tpu.io import jpeg12 as jpeg12_jax
from invesalius3_tpu.io import jpegls as jpegls_jax
from invesalius3_tpu_torch import _build, native
from invesalius3_tpu_torch.io import dicom_codecs as codecs
from invesalius3_tpu_torch.io import jpeg12, jpegls


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_codecs_library_is_registered_and_builds_with_gxx():
    spec = _build.LIBS["codecs"]
    assert spec.compiler is _build._gxx and spec.flags == _build.GXX_FLAGS
    lib = _build.codecs_lib()
    assert hasattr(lib, "jpegll_decode") and hasattr(lib, "packbits_decode")


def test_a_failed_codecs_build_raises(monkeypatch):
    """No fallback: the decoders raise when the library cannot be built."""
    def fail():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(_build, "codecs_lib", fail)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        codecs.packbits_decode(b"\x00a", 1)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        codecs.jpegll_decode(codecs.jpegll_encode(np.zeros((2, 2), np.uint16)))


PACKBITS_CASES = {
    "empty": b"",
    "zeros": b"\x00" * 1000,
    "random": bytes(_rng(1).integers(0, 256, 333).astype(np.uint8)),
    "mixed": b"ABABAB" + b"\xff" * 200 + b"Z",
    "runs": bytes(np.repeat(_rng(2).integers(0, 4, 90), _rng(3).integers(1, 200, 90))
                  .astype(np.uint8)),
}


@pytest.mark.parametrize("name", sorted(PACKBITS_CASES))
def test_packbits_encode_and_decode(name):
    data = PACKBITS_CASES[name]
    enc = codecs.packbits_encode(data)
    assert enc == codecs_jax.packbits_encode(data)
    assert codecs.packbits_decode(enc, len(data)) == data
    assert codecs.packbits_decode_ref(enc, len(data)) == data


@pytest.mark.parametrize("name", sorted(PACKBITS_CASES))
@pytest.mark.parametrize("edit", ["pad", "cut", "extra", "no-op"])
@pytest.mark.parametrize("expected", ["exact", "short", "long"])
def test_packbits_decode_ends_a_segment_as_python_does(name, edit, expected):
    """A segment padded to even length, cut short, with bytes past the
    expected length, or with the 128 no-op header: the native decoder gives
    the plain Python version's bytes, which are the JAX package's (its
    native decoder rejects such segments and falls back to Python)."""
    data = PACKBITS_CASES[name]
    enc = codecs.packbits_encode(data)
    enc = {"pad": enc + b"\x00", "cut": enc[:max(len(enc) - 3, 0)],
           "extra": enc + b"\x05abcdef" + b"\xfdq",
           "no-op": b"\x80" + enc + b"\x80"}[edit]
    n = {"exact": len(data), "short": len(data) // 2, "long": len(data) + 9}[expected]
    want = codecs_jax.packbits_decode(enc, n)
    assert codecs.packbits_decode_ref(enc, n) == want
    assert native.packbits_decode(enc, n) == want


RLE_FRAMES = {
    "int16": lambda: _rng(4).integers(-1024, 3000, (32, 24)).astype(np.int16),
    "uint16": lambda: _rng(5).integers(0, 65535, (17, 9)).astype(np.uint16),
    "uint8": lambda: _rng(6).integers(0, 255, (8, 8)).astype(np.uint8),
    "int16-flat": lambda: np.full((33, 31), -1000, np.int16),
    "uint16-odd": lambda: (np.arange(7 * 13).reshape(7, 13) * 517 % 65536).astype(np.uint16),
}


@pytest.mark.parametrize("name", sorted(RLE_FRAMES))
def test_rle_frame(name):
    arr = RLE_FRAMES[name]()
    frame = codecs.rle_encode_frame(arr)
    assert frame == codecs_jax.rle_encode_frame(arr)
    bits = arr.dtype.itemsize * 8
    got = codecs.rle_decode_frame(frame, *arr.shape, bits)
    plain = codecs.rle_decode_frame(frame, *arr.shape, bits,
                                    packbits=codecs.packbits_decode_ref)
    want = codecs_jax.rle_decode_frame(frame, *arr.shape, bits)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(plain, want)
    view = {2: np.uint16, 1: np.uint8}[arr.dtype.itemsize]
    assert np.array_equal(got, arr.view(view))


def test_rle_frame_with_three_samples():
    rgb = _rng(7).integers(0, 255, (6, 5, 3)).astype(np.uint8)
    planes = [codecs.packbits_encode(rgb[..., s].tobytes()) for s in range(3)]
    planes = [p + b"\x00" if len(p) % 2 else p for p in planes]
    offs = np.cumsum([64] + [len(p) for p in planes])[:3]
    frame = struct.pack("<16I", 3, *offs, *([0] * 12)) + b"".join(planes)
    got = codecs.rle_decode_frame(frame, 6, 5, 8, samples=3)
    assert np.array_equal(got, rgb)
    assert np.array_equal(got, codecs_jax.rle_decode_frame(frame, 6, 5, 8, samples=3))
    with pytest.raises(ValueError, match="segment count"):
        codecs.rle_decode_frame(frame, 6, 5, 16)


JPEGLL_FRAMES = {
    "random12": lambda: _rng(8).integers(0, 4096, (24, 31)).astype(np.uint16),
    "random16": lambda: _rng(9).integers(0, 65536, (19, 23)).astype(np.uint16),
    "extreme": lambda: np.array([[0, 32768, 0, 65535], [65535, 0, 32768, 1]], np.uint16),
    "ramp": lambda: (np.arange(40)[:, None] * 97 + np.arange(33)[None] * 13).astype(np.uint16),
    "one-pixel": lambda: np.array([[12345]], np.uint16),
}


@pytest.mark.parametrize("predictor", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("name", sorted(JPEGLL_FRAMES))
def test_jpegll_every_predictor(name, predictor):
    arr = JPEGLL_FRAMES[name]()
    enc = codecs.jpegll_encode(arr, precision=16, predictor=predictor)
    assert enc == codecs_jax.jpegll_encode(arr, precision=16, predictor=predictor)
    got = codecs.jpegll_decode(enc)
    assert got.dtype == np.uint16 and np.array_equal(got, arr)
    assert np.array_equal(codecs.jpegll_decode_ref(enc), arr)
    assert np.array_equal(codecs_jax.jpegll_decode(enc), got)


@pytest.mark.parametrize("pt", [1, 3])
def test_jpegll_point_transform_and_8_bit(pt):
    arr = _rng(10).integers(0, 4096, (11, 14)).astype(np.uint16)
    enc = codecs.jpegll_encode(arr, precision=12, predictor=1, point_transform=pt)
    assert enc == codecs_jax.jpegll_encode(arr, precision=12, predictor=1,
                                           point_transform=pt)
    want = (arr >> pt) << pt
    assert np.array_equal(codecs.jpegll_decode(enc), want)
    assert np.array_equal(codecs.jpegll_decode_ref(enc), want)
    a8 = _rng(11).integers(0, 256, (9, 10)).astype(np.uint8)
    enc8 = codecs.jpegll_encode(a8, precision=8)
    assert np.array_equal(codecs.jpegll_decode(enc8), a8)


def test_jpegll_rejects_non_lossless_streams():
    with pytest.raises(RuntimeError):
        codecs.jpegll_decode(b"not a jpeg stream")
    with pytest.raises(ValueError):
        codecs.jpegll_decode_ref(b"not a jpeg stream")


def _fragment_buffer(frames, bot: bool, split: int = 1):
    """An encapsulated PixelData item sequence: a BOT (with offsets or
    empty) and each frame in ``split`` fragments."""
    items, offsets, pos = [], [], 0
    for f in frames:
        offsets.append(pos)
        step = -(-len(f) // split)
        for i in range(0, len(f), step):
            part = f[i:i + step]
            items.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(part)) + part)
            pos += 8 + len(part)
    bot_payload = struct.pack(f"<{len(offsets)}I", *offsets) if bot else b""
    return (b"JUNK" + struct.pack("<HHI", 0xFFFE, 0xE000, len(bot_payload)) + bot_payload
            + b"".join(items) + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))


@pytest.mark.parametrize("bot,split", [(True, 1), (True, 3), (False, 1), (False, 2)])
def test_fragments_to_frames(bot, split):
    frames = [bytes(_rng(i).integers(0, 256, 10 + 4 * i).astype(np.uint8)) for i in range(3)]
    buf = _fragment_buffer(frames, bot, split)
    frags, end = codecs.parse_fragments(buf, 4)
    assert (frags, end) == codecs_jax.parse_fragments(buf, 4) and end == len(buf)
    got = codecs.fragments_to_frames(buf, frags, 3)
    assert got == codecs_jax.fragments_to_frames(buf, frags, 3) == frames
    assert codecs.fragments_to_frames(buf, frags, 1) == [b"".join(frames)]


def test_parse_fragments_rejects_a_bad_item():
    with pytest.raises(ValueError, match="bad encapsulated item"):
        codecs.parse_fragments(struct.pack("<HHI", 0x0008, 0x0010, 0), 0)


JPEG12_IMAGES = {
    "smooth12": lambda: (2048 + 700 * np.sin(np.mgrid[:48, :40][0] / 6.0)
                         * np.cos(np.mgrid[:48, :40][1] / 9.0)).astype(np.uint16),
    "noisy12": lambda: (1000 + 40 * np.arange(24)[:, None]
                        + _rng(9).integers(0, 50, (24, 36))).astype(np.uint16),
    "odd12": lambda: _rng(12).integers(0, 4096, (13, 19)).astype(np.uint16),
}


@pytest.mark.parametrize("restart", [0, 5])
@pytest.mark.parametrize("name", sorted(JPEG12_IMAGES))
def test_jpeg12_streams_and_pixels(name, restart):
    img = JPEG12_IMAGES[name]()
    enc = jpeg12.encode(img, precision=12, restart_interval=restart)
    assert enc == jpeg12_jax.encode(img, precision=12, restart_interval=restart)
    got = jpeg12.decode(enc)
    assert got.dtype == jpeg12_jax.decode(enc).dtype
    assert np.array_equal(got, jpeg12_jax.decode(enc))
    err = np.abs(got.astype(np.int32) - img.astype(np.int32))
    assert err.mean() < 6.0 and err.max() < 64  # the JAX tests' 12-bit lossy bound


def test_jpeg12_8_bit_against_pillow():
    from PIL import Image
    import io

    img = (120 + 60 * np.sin(np.arange(40)[:, None] / 5.0)
           * np.cos(np.arange(56)[None, :] / 7.0)).astype(np.uint8)
    img = (img + _rng(3).integers(0, 8, img.shape)).astype(np.uint8)
    enc = jpeg12.encode(img, precision=8)
    assert enc == jpeg12_jax.encode(img, precision=8)
    pil = np.asarray(Image.open(io.BytesIO(enc)))
    assert np.abs(pil.astype(int) - jpeg12.decode(enc).astype(int)).max() <= 1


JPEGLS_IMAGES = {
    "ramp-flat": lambda: np.where(
        (np.mgrid[:40, :48][0] > 10) & (np.mgrid[:40, :48][1] > 12), 3000,
        np.mgrid[:40, :48][0] * 25 + np.mgrid[:40, :48][1] * 3).astype(np.uint16)
    + _rng(5).integers(0, 9, (40, 48)).astype(np.uint16),
    "random16": lambda: _rng(0).integers(0, 65535, (9, 13)).astype(np.uint16),
    "flat": lambda: np.full((16, 20), 1000, np.uint16),
    "u8": lambda: _rng(13).integers(0, 256, (12, 17)).astype(np.uint8),
}


@pytest.mark.parametrize("near", [0, 2])
@pytest.mark.parametrize("name", sorted(JPEGLS_IMAGES))
def test_jpegls_streams_and_pixels(name, near):
    img = JPEGLS_IMAGES[name]()
    maxval = (1 << (img.dtype.itemsize * 8)) - 1
    enc = jpegls.encode(img, near=near, maxval=maxval)
    assert enc == jpegls_jax.encode(img, near=near, maxval=maxval)
    got = jpegls.decode(enc)
    assert np.array_equal(got, jpegls_jax.decode(enc))
    err = np.abs(got.astype(np.int64) - img.astype(np.int64)).max()
    assert err <= near


def test_jpegls_trailing_ff_bytes():
    rng = _rng(0)
    for seed in range(30):  # many streams: some end on 0xFF
        img = rng.integers(0, 65535, (9, 13)).astype(np.uint16)
        assert np.array_equal(jpegls.decode(jpegls.encode(img)), img), seed


@pytest.mark.parametrize("route", ["baseline", "j2k-lossless", "j2k"])
def test_pillow_routes(route):
    if route == "baseline":
        yy, xx = np.mgrid[:32, :32]
        px = (128 + 60 * np.sin(yy / 5.0) * np.cos(xx / 7.0)).astype(np.uint8)
        enc, enc_jax = codecs.jpeg_baseline_encode(px), codecs_jax.jpeg_baseline_encode(px)
        got, want = codecs.jpeg_baseline_decode(enc), codecs_jax.jpeg_baseline_decode(enc)
        assert np.abs(got.astype(np.int16) - px.astype(np.int16)).mean() < 3.0
    else:
        px = _rng(4).integers(0, 4000, (16, 16)).astype(np.uint16)
        lossless = route == "j2k-lossless"
        enc = codecs.j2k_encode(px, lossless=lossless)
        enc_jax = codecs_jax.j2k_encode(px, lossless=lossless)
        got, want = codecs.j2k_decode(enc), codecs_jax.j2k_decode(enc)
        err = np.abs(got.astype(np.int32) - px.astype(np.int32)).max()
        assert err <= (0 if lossless else 4)  # the irreversible transform rounds
    assert enc == enc_jax
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_without_pillow_its_routes_name_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    px = np.zeros((4, 4), np.uint8)
    for call in (lambda: codecs.jpeg_baseline_encode(px),
                 lambda: codecs.jpeg_baseline_decode(b"\xff\xd8"),
                 lambda: codecs.j2k_encode(px),
                 lambda: codecs.j2k_decode(b"\x00")):
        with pytest.raises(ImportError, match="Pillow"):
            call()
    with pytest.raises(ValueError, match="8-bit"):
        monkeypatch.delitem(sys.modules, "PIL")
        codecs.jpeg_baseline_encode(np.zeros((4, 4), np.uint16))


def test_syntax_constants_are_the_jax_packages():
    names = [n for n in dir(codecs_jax) if n.isupper()]
    assert names and all(getattr(codecs, n) == getattr(codecs_jax, n) for n in names)
    assert codecs.DECODABLE_SYNTAXES == codecs_jax.DECODABLE_SYNTAXES

"""Encapsulated DICOM pixel-data codecs (port of
invesalius3_tpu/io/dicom_codecs.py): fragment framing, RLE Lossless, JPEG
Lossless process 14, and Pillow's baseline JPEG and JPEG 2000.

The reference hands every compressed transfer syntax to GDCM
(reference invesalius/reader/dicom_reader.py:86-140); this module decodes
the two losslessly-compressed syntaxes that dominate real PACS exports
without any external library:

  1.2.840.10008.1.2.5       RLE Lossless (PS3.5 Annex G: PackBits planes)
  1.2.840.10008.1.2.4.57    JPEG Lossless, Non-Hierarchical (Process 14)
  1.2.840.10008.1.2.4.70    JPEG Lossless, Process 14, SV1 (the common one)

``packbits_decode`` and ``jpegll_decode`` call the port's native library
(``csrc/codecs.cpp``, built by g++ at first use); a failed build raises, and
nothing falls back to Python.  The Python decoders ``packbits_decode_ref``
and ``jpegll_decode_ref`` are their plain versions, for the tests and the
card's smoke run.  Baseline JPEG (.4.50) and JPEG 2000 (.4.90/.4.91) go
through Pillow, imported when a frame needs it; without Pillow they raise an
ImportError that names it.  Encoders exist for test fixtures and for
writing compressed exports.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from invesalius3_tpu_torch import native

RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"  # 8-bit lossy (PIL codec)
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"  # 12-bit lossy (io/jpeg12.py)
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"  # JPEG-LS (io/jpegls.py)
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"      # JPEG-LS near-lossless
J2K_LOSSLESS = "1.2.840.10008.1.2.4.90"   # JPEG 2000 lossless (PIL/openjpeg)
J2K = "1.2.840.10008.1.2.4.91"            # JPEG 2000 (PIL/openjpeg)
DECODABLE_SYNTAXES = (RLE_LOSSLESS, JPEG_LOSSLESS_P14, JPEG_LOSSLESS_SV1,
                      J2K_LOSSLESS, J2K,
                      JPEG_BASELINE, JPEG_EXTENDED,
                      JPEG_LS_LOSSLESS, JPEG_LS_NEAR)


def pil_image():
    """Pillow's ``Image`` module; an ImportError naming Pillow without it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("Pillow is not installed: baseline JPEG, JPEG 2000 "
                          "and bitmap stacks need Pillow (the PIL package)") from e
    return Image


def jpeg_baseline_decode(data: bytes) -> "np.ndarray":
    """Decode an 8-bit baseline JPEG frame (transfer syntax .4.50) via
    PIL — the one lossy syntax common enough to matter (ultrasound /
    secondary capture); 12-bit extended (.4.51) is io/jpeg12.py's."""
    import io as _io

    Image = pil_image()

    return np.asarray(Image.open(_io.BytesIO(data)))


def j2k_decode(data: bytes) -> "np.ndarray":
    """Decode a JPEG 2000 codestream/JP2 frame (transfer syntaxes .4.90
    lossless and .4.91) via PIL's openjpeg codec — the syntaxes the
    reference routes through GDCM (dicom_reader.py:86-140)."""
    import io as _io

    Image = pil_image()

    return np.asarray(Image.open(_io.BytesIO(data)))


def j2k_encode(arr: "np.ndarray", lossless: bool = True) -> bytes:
    """Encode a frame as a raw JPEG 2000 codestream (fixtures)."""
    import io as _io

    Image = pil_image()

    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG2000",
                              irreversible=not lossless, no_jp2=True)
    return buf.getvalue()


def jpeg_baseline_encode(arr: "np.ndarray", quality: int = 95) -> bytes:
    """Encode an (rows, cols) uint8 frame as baseline JPEG (fixtures)."""
    import io as _io

    Image = pil_image()

    if arr.dtype != np.uint8:
        raise ValueError("baseline JPEG is 8-bit only")
    b = _io.BytesIO()
    Image.fromarray(arr).save(b, "JPEG", quality=quality)
    return b.getvalue()


# ---------------------------------------------------------------------------
# Encapsulated pixel-data framing (PS3.5 A.4): item sequence of fragments
# ---------------------------------------------------------------------------
def parse_fragments(buf: bytes, pos: int) -> Tuple[List[Tuple[int, int]], int]:
    """Walk the encapsulated-PixelData item sequence starting right after
    the undefined-length PixelData element header.  Returns
    ([(offset, length)] including the leading Basic Offset Table item,
    position after the sequence delimiter)."""
    frags: List[Tuple[int, int]] = []
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        (length,) = struct.unpack_from("<I", buf, pos + 4)
        pos += 8
        if (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimiter
            break
        if (group, elem) != (0xFFFE, 0xE000):
            raise ValueError(f"bad encapsulated item tag {group:04x},{elem:04x}")
        frags.append((pos, length))
        pos += length
    return frags, pos


def fragments_to_frames(buf: bytes, frags: List[Tuple[int, int]],
                        n_frames: int) -> List[bytes]:
    """Group fragments into per-frame byte strings using the Basic Offset
    Table when present, else 1:1 / concatenate heuristics (PS3.5 A.4)."""
    if not frags:
        return []
    bot_off, bot_len = frags[0]
    data_frags = frags[1:]
    if bot_len >= 4 * n_frames and n_frames > 1:
        offsets = struct.unpack_from(f"<{n_frames}I", buf, bot_off)
        # offsets are byte positions of each frame's first fragment item
        # header, relative to the first byte after the BOT item
        base = bot_off + bot_len
        starts = []
        for off in offsets:
            for i, (fo, _) in enumerate(data_frags):
                if fo - 8 - base == off:
                    starts.append(i)
                    break
        if len(starts) == n_frames:
            starts.append(len(data_frags))
            return [
                b"".join(buf[fo:fo + fl] for fo, fl in data_frags[starts[i]:starts[i + 1]])
                for i in range(n_frames)
            ]
    if len(data_frags) == n_frames:
        return [buf[fo:fo + fl] for fo, fl in data_frags]
    if n_frames == 1:
        return [b"".join(buf[fo:fo + fl] for fo, fl in data_frags)]
    if len(data_frags) % n_frames == 0:
        per = len(data_frags) // n_frames
        return [
            b"".join(buf[fo:fo + fl] for fo, fl in data_frags[i * per:(i + 1) * per])
            for i in range(n_frames)
        ]
    raise ValueError(
        f"cannot map {len(data_frags)} fragments to {n_frames} frames")


# ---------------------------------------------------------------------------
# PackBits (RLE segment) codec
# ---------------------------------------------------------------------------
def packbits_decode(data: bytes, expected: int) -> bytes:
    """One PackBits segment to at most ``expected`` bytes, by the native
    library."""
    return native.packbits_decode(data, expected)


def packbits_decode_ref(data: bytes, expected: int) -> bytes:
    """The plain Python version of ``packbits_decode`` (the JAX package's
    fallback loop)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:  # literal run of h+1 bytes
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:  # replicate next byte 257-h times
            out += data[i:i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    return bytes(out[:expected])


def packbits_encode(data: bytes) -> bytes:
    """PackBits encode (PS3.5 G.3.1) — used for RLE test fixtures/export."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # find replicate run
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
            continue
        # literal run: until a 3+ replicate starts or 128 bytes
        j = i + 1
        while j < n and j - i < 128:
            if j + 2 < n and data[j] == data[j + 1] == data[j + 2]:
                break
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def rle_decode_frame(frame: bytes, rows: int, cols: int,
                     bits_allocated: int, samples: int = 1,
                     packbits=packbits_decode) -> np.ndarray:
    """DICOM RLE Lossless frame -> (rows, cols[, samples]) array.  The
    frame is a 64-byte header (number of segments + 15 offsets, uint32 LE)
    followed by PackBits-compressed byte segments; segment k holds byte k
    (MSB first) of every composite pixel (PS3.5 Annex G).  ``packbits``
    decodes a segment (``packbits_decode_ref`` gives the plain version)."""
    if len(frame) < 64:
        raise ValueError("RLE frame shorter than its 64-byte header")
    header = struct.unpack_from("<16I", frame, 0)
    nseg = header[0]
    bytes_per_sample = bits_allocated // 8
    if nseg != bytes_per_sample * samples:
        raise ValueError(
            f"RLE segment count {nseg} != {bytes_per_sample * samples} "
            f"(bits={bits_allocated}, samples={samples})")
    offsets = list(header[1:1 + nseg]) + [len(frame)]
    npix = rows * cols
    planes = []
    for k in range(nseg):
        seg = frame[offsets[k]:offsets[k + 1]]
        planes.append(np.frombuffer(packbits(seg, npix), np.uint8))
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[bytes_per_sample]
    out = np.zeros((samples, npix), dtype)
    for s in range(samples):
        for b in range(bytes_per_sample):  # segments are MSB-first
            shift = 8 * (bytes_per_sample - 1 - b)
            out[s] |= planes[s * bytes_per_sample + b].astype(dtype) << shift
    if samples == 1:
        return out[0].reshape(rows, cols)
    return out.reshape(samples, rows, cols).transpose(1, 2, 0)


def rle_encode_frame(arr: np.ndarray) -> bytes:
    """Encode one (rows, cols) frame as a DICOM RLE Lossless frame."""
    arr = np.ascontiguousarray(arr)
    bps = arr.dtype.itemsize
    flat = arr.reshape(-1)
    segments = []
    for b in range(bps):  # MSB first
        shift = 8 * (bps - 1 - b)
        plane = ((flat.astype(np.uint64) >> shift) & 0xFF).astype(np.uint8)
        seg = packbits_encode(plane.tobytes())
        if len(seg) % 2:
            seg += b"\x00"  # segments are padded to even length
        segments.append(seg)
    header = [len(segments)]
    off = 64
    for seg in segments:
        header.append(off)
        off += len(seg)
    header += [0] * (16 - len(header))
    return struct.pack("<16I", *header) + b"".join(segments)


# ---------------------------------------------------------------------------
# JPEG Lossless (process 14) codec
# ---------------------------------------------------------------------------
def jpegll_decode(data: bytes) -> np.ndarray:
    """One lossless-JPEG frame -> uint16 samples, by the native library."""
    return native.jpegll_decode(data)


# default Huffman code lengths for difference categories 0..16: the classic
# lossless-JPEG table (category k gets a short code; Kraft-complete)
_DEFAULT_LENGTHS = [2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


def _canonical_codes(lengths):
    """(code, length) per symbol index from canonical Huffman lengths."""
    order = sorted(range(len(lengths)), key=lambda i: (lengths[i], i))
    codes = [0] * len(lengths)
    code, prev_len = 0, 0
    for sym in order:
        L = lengths[sym]
        code <<= (L - prev_len)
        codes[sym] = code
        code += 1
        prev_len = L
    return codes


def jpegll_encode(arr: np.ndarray, precision: int = 16,
                  predictor: int = 1, point_transform: int = 0) -> bytes:
    """Encode a (rows, cols) unsigned array as lossless JPEG process 14
    (SV1 when predictor=1) — used to build test fixtures and to produce
    compressed DICOM output."""
    a = np.asarray(arr).astype(np.int64) >> point_transform
    rows, cols = a.shape
    # difference image per the selected predictor
    px = np.empty_like(a)
    px[0, 0] = 1 << (precision - point_transform - 1)
    px[0, 1:] = a[0, :-1]
    px[1:, 0] = a[:-1, 0]
    ra, rb, rc = a[1:, :-1], a[:-1, 1:], a[:-1, :-1]
    inner = {
        1: ra,
        2: rb,
        3: rc,
        4: ra + rb - rc,
        5: ra + ((rb - rc) >> 1),
        6: rb + ((ra - rc) >> 1),
        7: (ra + rb) >> 1,
    }[predictor]
    px[1:, 1:] = inner
    diff = ((a - px) & 0xFFFF).astype(np.int64)
    diff = np.where(diff >= 32768, diff - 65536, diff)  # mod-2^16 signed

    lengths = _DEFAULT_LENGTHS
    codes = _canonical_codes(lengths)

    bits = bytearray()
    acc, nacc = 0, 0
    out = bytearray()

    def put(code, nbits_):
        nonlocal acc, nacc
        acc = (acc << nbits_) | code
        nacc += nbits_
        while nacc >= 8:
            byte = (acc >> (nacc - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0x00)  # byte stuffing
            nacc -= 8
        acc &= (1 << nacc) - 1

    flat = diff.reshape(-1)
    for d in flat:
        d = int(d)
        if d == 32768 or d == -32768:
            put(codes[16], lengths[16])
            continue
        mag = abs(d)
        ssss = mag.bit_length()
        put(codes[ssss], lengths[ssss])
        if ssss:
            v = d if d >= 0 else d + (1 << ssss) - 1
            put(v & ((1 << ssss) - 1), ssss)
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)  # pad with 1s

    # assemble markers
    counts = [0] * 16
    for L in lengths:
        counts[L - 1] += 1
    vals = bytes(sorted(range(17), key=lambda i: (lengths[i], i)))
    dht = bytes([0x00]) + bytes(counts) + vals
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0])
    sos = bytes([1, 1, 0x00, predictor, 0, point_transform])

    def seg(marker, payload):
        return struct.pack(">HH", marker, len(payload) + 2) + payload

    return (b"\xff\xd8" + seg(0xFFC4, dht) + seg(0xFFC3, sof)
            + seg(0xFFDA, sos) + bytes(out) + b"\xff\xd9")


def jpegll_decode_ref(data: bytes) -> np.ndarray:
    """The plain Python version of ``jpegll_decode`` (the JAX package's
    ``_jpegll_decode_py``): the same subset as csrc/codecs.cpp, one scan."""
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise ValueError("not a JPEG stream")
    pos = 2
    precision = rows = cols = ncomp = 0
    tables = {}
    comp_tbl = [0, 0, 0, 0]
    predictor, pt = 1, 0
    scan_start = -1
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        pos += 2
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        if m == 0xD9:
            break
        (seglen,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2:pos + seglen]
        if m in (0xC3, 0xC7, 0xCB):  # SOF3 family
            precision = seg[0]
            rows, cols = struct.unpack_from(">HH", seg, 1)
            ncomp = seg[5]
        elif m in (0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC9, 0xCA, 0xCD, 0xCE, 0xCF):
            raise ValueError("not a lossless (SOF3) JPEG")
        elif m == 0xC4:  # DHT
            off = 0
            while off + 17 <= len(seg):
                tc, th = seg[off] >> 4, seg[off] & 0xF
                counts = seg[off + 1:off + 17]
                nvals = sum(counts)
                vals = seg[off + 17:off + 17 + nvals]
                if tc == 0:
                    lengths, syms = [], []
                    k = 0
                    for L in range(1, 17):
                        for _ in range(counts[L - 1]):
                            syms.append(vals[k])
                            lengths.append(L)
                            k += 1
                    codes = {}
                    code, prev = 0, 0
                    for L, s in zip(lengths, syms):
                        code <<= (L - prev)
                        codes[(L, code)] = s
                        code += 1
                        prev = L
                    tables[th] = codes
                off += 17 + nvals
        elif m == 0xDA:  # SOS
            ns = seg[0]
            for i in range(ns):
                comp_tbl[i] = seg[2 + 2 * i] >> 4
            predictor = seg[1 + 2 * ns]
            pt = seg[3 + 2 * ns] & 0xF
            scan_start = pos + seglen
            break
        pos += seglen
    if scan_start < 0 or not rows:
        raise ValueError("truncated JPEG")

    # destuff entropy bytes, stop at any real marker
    raw = bytearray()
    i = scan_start
    while i < n:
        b = data[i]
        if b == 0xFF:
            if i + 1 < n and data[i + 1] == 0x00:
                raw.append(0xFF)
                i += 2
                continue
            break
        raw.append(b)
        i += 1
    bitstream = np.unpackbits(np.frombuffer(bytes(raw), np.uint8))
    bp = 0

    def read_bits(k):
        nonlocal bp
        v = 0
        for _ in range(k):
            v = (v << 1) | int(bitstream[bp])
            bp += 1
        return v

    codes0 = tables[comp_tbl[0]]

    def decode_sym():
        nonlocal bp
        code, L = 0, 0
        while L < 17:
            code = (code << 1) | int(bitstream[bp])
            bp += 1
            L += 1
            if (L, code) in codes0:
                return codes0[(L, code)]
        raise ValueError("bad Huffman code")

    out = np.zeros((rows, cols), np.int64)
    default = 1 << (precision - pt - 1)
    for y in range(rows):
        for x in range(cols):
            ssss = decode_sym()
            if ssss == 16:
                d = 32768
            elif ssss == 0:
                d = 0
            else:
                v = read_bits(ssss)
                d = v if v >= (1 << (ssss - 1)) else v - (1 << ssss) + 1
            if y == 0:
                p = default if x == 0 else out[0, x - 1]
            elif x == 0:
                p = out[y - 1, 0]
            else:
                ra, rb, rc = out[y, x - 1], out[y - 1, x], out[y - 1, x - 1]
                p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                     5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                     7: (ra + rb) >> 1}[predictor]
            out[y, x] = (p + d) & 0xFFFF
    return (out << pt).astype(np.uint16)

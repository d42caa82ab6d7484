"""Extended sequential DCT JPEG (ITU T.81 SOF1), 8/12-bit, single component.

The port's copy of invesalius3_tpu/io/jpeg12.py: numpy and the standard
library only, the arithmetic unchanged, so its streams and pixels are the
JAX package's.

Covers DICOM transfer syntax 1.2.840.10008.1.2.4.51 (JPEG Extended
Process 2 & 4 — the lossy 12-bit syntax the reference decodes through GDCM
and this repo previously rejected, reference dicom_reader.py:86-140,
io/dicom.py:17).

PIL only decodes 8-bit baseline, so 12-bit gets a from-scratch path:
Huffman entropy decode (tables from the stream's DHT — 12-bit streams
ship their own), dequantize (8- or 16-bit DQT), 8x8 IDCT as two dense
matrix products, level shift.  The encoder (fixtures + write_dicom
symmetry) builds canonical Huffman tables that cover the 12-bit category
range.  Grayscale, non-interleaved, no subsampling — the medical case.
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K luminance table, scaled down (quality ~ 90) — fixture encoder
QTABLE = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int32) + 2) // 4


def _dct_matrix():
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    c[0] *= 1 / np.sqrt(2)
    return c * 0.5  # orthonormal DCT-II rows


_C = _dct_matrix()


def _canonical(counts, symbols):
    """BITS/HUFFVAL -> {(length, code): symbol} and the reverse map."""
    dec, enc = {}, {}
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            dec[(length, code)] = symbols[k]
            enc[symbols[k]] = (length, code)
            code += 1
            k += 1
        code <<= 1
    return dec, enc


def _build_table(freqs):
    """Canonical Huffman (BITS, HUFFVAL) from symbol frequencies — T.81
    K.2/K.3: true Huffman lengths, the >16-bit adjustment, and one
    reserved code point (the all-ones code must stay unused)."""
    import heapq

    RESERVED = -1  # dummy symbol reserving the all-ones code (K.2)
    items = dict(freqs)
    items[RESERVED] = 0  # lowest frequency: gets the longest code
    heap = [(max(f, 1) if s != RESERVED else 0, i, [s])
            for i, (s, f) in enumerate(sorted(items.items()))]
    lengths = {s: 0 for s in items}
    heapq.heapify(heap)
    tie = len(heap)
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        for s in sa + sb:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, tie, sa + sb))
        tie += 1
    bits = [0] * 33
    for s, length in lengths.items():
        bits[min(length, 32)] += 1
    # K.3 Adjust_BITS: fold lengths > 16 upward
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    # drop the reserved symbol from the longest used length
    for i in range(16, 0, -1):
        if bits[i]:
            bits[i] -= 1
            break
    counts = bits[1:17]
    ordered = [s for s in sorted(lengths, key=lambda s: (lengths[s], s))
               if s != RESERVED]
    # HUFFVAL order: by (code length, symbol); counts already exclude the
    # reserved slot so sum(counts) == len(ordered)
    assert sum(counts) == len(ordered)
    return counts, ordered


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, val, bits):
        for i in range(bits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((val >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)  # byte stuffing
                self.acc, self.n = 0, 0

    def flush(self):
        while self.n:
            self.put(1, 1)  # pad with 1s

    def marker(self, m):
        """Byte-align (1-padding) and emit a raw marker (RSTn)."""
        self.flush()
        self.out += bytes((0xFF, m))


class _BitReader:
    def __init__(self, data, pos):
        self.d = data
        self.pos = pos
        self.acc = 0
        self.n = 0

    def bit(self):
        if self.n == 0:
            b = self.d[self.pos]
            self.pos += 1
            if b == 0xFF:
                nxt = self.d[self.pos]
                if nxt == 0x00:
                    self.pos += 1
                else:
                    raise StopIteration  # real marker: scan over
            self.acc, self.n = b, 8
        self.n -= 1
        return (self.acc >> self.n) & 1

    def bits(self, k):
        v = 0
        for _ in range(k):
            v = (v << 1) | self.bit()
        return v

    def restart(self):
        """T.81 restart-interval boundary: drop the pad bits of the
        current byte, consume the RSTn marker (tolerating 0xFF fill)."""
        self.n = 0
        if self.pos < len(self.d) and self.d[self.pos] == 0x00:
            self.pos += 1  # stuffed byte of an all-ones 0xFF pad byte
        while self.pos + 1 < len(self.d) and self.d[self.pos] == 0xFF:
            nxt = self.d[self.pos + 1]
            if 0xD0 <= nxt <= 0xD7:
                self.pos += 2
                return
            if nxt == 0xFF:  # fill byte
                self.pos += 1
                continue
            break
        raise StopIteration  # no restart marker where one was expected


def _receive_extend(br, ssss):
    if ssss == 0:
        return 0
    v = br.bits(ssss)
    return v if v >= (1 << (ssss - 1)) else v - (1 << ssss) + 1


def encode(arr: np.ndarray, precision: int = 12,
           restart_interval: int = 0) -> bytes:
    """Encode (rows, cols) unsigned as extended sequential JPEG (SOF1).
    ``restart_interval`` > 0 emits DRI + RSTn markers every N blocks
    (hardware-encoder style; exercises the decoder's resync path)."""
    arr = np.asarray(arr)
    rows, cols = arr.shape
    shift = 1 << (precision - 1)
    q = QTABLE.reshape(8, 8)
    by, bx = -(-rows // 8), -(-cols // 8)
    padded = np.zeros((by * 8, bx * 8), np.float64)
    padded[:rows, :cols] = arr
    padded[rows:, :cols] = arr[-1:, :]
    padded[:, cols:] = padded[:, cols - 1:cols]
    padded -= shift

    # pass 1: coefficients + symbol frequencies
    blocks = []
    dc_freq, ac_freq = {}, {}
    prev_dc = 0
    for y in range(by):
        for x in range(bx):
            blk = padded[8 * y:8 * y + 8, 8 * x:8 * x + 8]
            coef = _C @ blk @ _C.T
            qc = np.round(coef / q).astype(np.int32).reshape(64)[ZIGZAG]
            bi = len(blocks)
            blocks.append(qc)
            if restart_interval and bi and bi % restart_interval == 0:
                prev_dc = 0  # mirror pass 2's per-interval DC reset
            diff = int(qc[0]) - prev_dc
            prev_dc = int(qc[0])
            cat = abs(diff).bit_length()
            dc_freq[cat] = dc_freq.get(cat, 0) + 1
            run = 0
            for k in range(1, 64):
                if qc[k] == 0:
                    run += 1
                    continue
                while run > 15:
                    ac_freq[0xF0] = ac_freq.get(0xF0, 0) + 1
                    run -= 16
                s = (run << 4) | abs(int(qc[k])).bit_length()
                ac_freq[s] = ac_freq.get(s, 0) + 1
                run = 0
            if run:
                ac_freq[0x00] = ac_freq.get(0x00, 0) + 1  # EOB
    ac_freq.setdefault(0x00, 1)
    dc_counts, dc_syms = _build_table(dc_freq)
    ac_counts, ac_syms = _build_table(ac_freq)
    _, dc_enc = _canonical(dc_counts, dc_syms)
    _, ac_enc = _canonical(ac_counts, ac_syms)

    # pass 2: entropy coding
    bw = _BitWriter()
    prev_dc = 0
    for bi, qc in enumerate(blocks):
        if restart_interval and bi and bi % restart_interval == 0:
            bw.marker(0xD0 + ((bi // restart_interval - 1) % 8))
            prev_dc = 0
        diff = int(qc[0]) - prev_dc
        prev_dc = int(qc[0])
        cat = abs(diff).bit_length()
        L, code = dc_enc[cat]
        bw.put(code, L)
        if cat:
            bw.put(diff if diff >= 0 else diff + (1 << cat) - 1, cat)
        run = 0
        for k in range(1, 64):
            v = int(qc[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                L, code = ac_enc[0xF0]
                bw.put(code, L)
                run -= 16
            ssss = abs(v).bit_length()
            L, code = ac_enc[(run << 4) | ssss]
            bw.put(code, L)
            bw.put(v if v >= 0 else v + (1 << ssss) - 1, ssss)
            run = 0
        if run:
            L, code = ac_enc[0x00]
            bw.put(code, L)
    bw.flush()

    def seg(marker, payload):
        return struct.pack(">HH", marker, len(payload) + 2) + payload

    out = struct.pack(">H", 0xFFD8)
    # 16-bit DQT entries (Pq=1) — required for 12-bit; zigzag order
    qz = QTABLE.reshape(64)[ZIGZAG]
    out += seg(0xFFDB, bytes([0x10]) + b"".join(
        struct.pack(">H", int(v)) for v in qz))
    out += seg(0xFFC1, struct.pack(">BHHB", precision, rows, cols, 1)
               + bytes([1, 0x11, 0]))  # SOF1
    out += seg(0xFFC4, bytes([0x00]) + bytes(dc_counts) + bytes(dc_syms))
    out += seg(0xFFC4, bytes([0x10]) + bytes(ac_counts) + bytes(ac_syms))
    if restart_interval:
        out += seg(0xFFDD, struct.pack(">H", restart_interval))
    out += seg(0xFFDA, bytes([1, 1, 0x00, 0, 63, 0]))
    return out + bytes(bw.out) + struct.pack(">H", 0xFFD9)


def decode(data: bytes) -> np.ndarray:
    """Decode a single-component sequential-DCT JPEG (SOF0/SOF1, 8/12-bit)."""
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise ValueError("not a JPEG stream")
    pos = 2
    precision = rows = cols = 0
    qtables, dc_tables, ac_tables = {}, {}, {}
    comp_q = 0
    dc_id = ac_id = 0
    restart_interval = 0
    scan_start = -1
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xFF:  # 0xFF fill byte before a marker (T.81 B.1.1.2)
            pos += 1
            continue
        pos += 2
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        if m == 0xD9:
            break
        (seglen,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2:pos + seglen]
        if m in (0xC0, 0xC1):  # baseline / extended sequential
            precision = seg[0]
            rows, cols = struct.unpack_from(">HH", seg, 1)
            if seg[5] != 1:
                raise ValueError("single-component JPEG only")
            comp_q = seg[8]
        elif m in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB):
            raise ValueError("progressive/lossless JPEG not handled here")
        elif m == 0xDB:  # DQT
            off = 0
            while off < len(seg):
                pq, tq = seg[off] >> 4, seg[off] & 0xF
                off += 1
                if pq:
                    vals = np.frombuffer(seg, ">u2", 64, off).astype(np.int32)
                    off += 128
                else:
                    vals = np.frombuffer(seg, np.uint8, 64,
                                         off).astype(np.int32)
                    off += 64
                tbl = np.zeros(64, np.int32)
                tbl[ZIGZAG] = vals
                qtables[tq] = tbl.reshape(8, 8)
        elif m == 0xC4:  # DHT
            off = 0
            while off + 17 <= len(seg):
                tc, th = seg[off] >> 4, seg[off] & 0xF
                counts = list(seg[off + 1:off + 17])
                nv = sum(counts)
                vals = list(seg[off + 17:off + 17 + nv])
                dec, _ = _canonical(counts, vals)
                (ac_tables if tc else dc_tables)[th] = dec
                off += 17 + nv
        elif m == 0xDD:  # DRI
            (restart_interval,) = struct.unpack_from(">H", seg, 0)
        elif m == 0xDA:  # SOS
            dc_id = seg[2] >> 4
            ac_id = seg[2] & 0xF
            scan_start = pos + seglen
            break
        pos += seglen
    if scan_start < 0 or not rows:
        raise ValueError("truncated JPEG")
    q = qtables[comp_q].astype(np.float64)
    dc_t, ac_t = dc_tables[dc_id], ac_tables[ac_id]

    def huff(br, table):
        code, L = 0, 0
        while L < 17:
            code = (code << 1) | br.bit()
            L += 1
            sym = table.get((L, code))
            if sym is not None:
                return sym
        raise ValueError("bad Huffman code")

    by, bx = -(-rows // 8), -(-cols // 8)
    out = np.zeros((by * 8, bx * 8), np.float64)
    br = _BitReader(data, scan_start)
    prev_dc = 0
    shift = 1 << (precision - 1)
    maxv = (1 << precision) - 1
    n_blocks = 0
    try:
        for y in range(by):
            for x in range(bx):
                if restart_interval and n_blocks and \
                        n_blocks % restart_interval == 0:
                    br.restart()   # byte-align + consume RSTn
                    prev_dc = 0    # DC predictor resets per interval
                n_blocks += 1
                zz = np.zeros(64, np.int32)
                cat = huff(br, dc_t)
                prev_dc += _receive_extend(br, cat)
                zz[0] = prev_dc
                k = 1
                while k < 64:
                    rs = huff(br, ac_t)
                    r, s = rs >> 4, rs & 0xF
                    if s == 0:
                        if r == 15:
                            k += 16
                            continue
                        break  # EOB
                    k += r
                    if k > 63:
                        break
                    zz[k] = _receive_extend(br, s)
                    k += 1
                coef = np.zeros(64, np.float64)
                coef[ZIGZAG] = zz
                blk = _C.T @ (coef.reshape(8, 8) * q) @ _C
                out[8 * y:8 * y + 8, 8 * x:8 * x + 8] = blk
    except (StopIteration, IndexError):
        pass  # truncated entropy data: keep decoded blocks
    img = np.clip(np.round(out + shift), 0, maxv)
    return img[:rows, :cols].astype(np.uint16 if precision > 8 else np.uint8)

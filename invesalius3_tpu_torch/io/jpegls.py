"""JPEG-LS (ITU-T T.87 / LOCO-I) codec — pure Python, single component.

The port's copy of invesalius3_tpu/io/jpegls.py: numpy and the standard
library only, the arithmetic unchanged, so its streams and pixels are the
JAX package's.

Covers the DICOM transfer syntaxes the reference decodes through GDCM's
CharLS (reference dicom_reader.py:86-140):

  1.2.840.10008.1.2.4.80  JPEG-LS Lossless
  1.2.840.10008.1.2.4.81  JPEG-LS Near-Lossless (|error| <= NEAR)

Scope: one component (medical grayscale), 2-16 bpp, default or LSE-
override coding parameters, run + regular modes, bit stuffing after 0xFF.
The encoder exists for fixtures and write_dicom symmetry; decode(encode(x))
is exact for NEAR=0 and bounded by NEAR otherwise (tested in
tests/test_io.py and tests/test_torch_codecs.py).
"""

from __future__ import annotations

import struct

import numpy as np

# run-length code order (T.87 A.2.1)
J = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
     4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def _default_thresholds(maxval: int, near: int):
    """C.2.4.1.1.1 default T1/T2/T3."""
    def clamp(x, lo):
        return lo if (x < lo or x > maxval) else x

    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) // 256
        t1 = clamp(factor + 2 + 3 * near, near + 1)
        t2 = clamp(4 * factor + 3 + 5 * near, t1)
        t3 = clamp(17 * factor + 4 + 7 * near, t2)
    else:
        factor = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // factor + 3 * near), near + 1)
        t2 = clamp(max(3, 7 // factor + 5 * near), t1)
        t3 = clamp(max(4, 21 // factor + 7 * near), t2)
    return t1, t2, t3


class _Params:
    def __init__(self, maxval, near, t1, t2, t3, reset):
        self.maxval, self.near = maxval, near
        self.t1, self.t2, self.t3, self.reset = t1, t2, t3, reset
        self.range = (maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = max(1, (self.range - 1).bit_length())
        bpp = max(2, (maxval).bit_length())
        self.limit = 2 * (bpp + max(8, bpp))

    def quantize_gradient(self, d):
        if d <= -self.t3:
            return -4
        if d <= -self.t2:
            return -3
        if d <= -self.t1:
            return -2
        if d < -self.near:
            return -1
        if d <= self.near:
            return 0
        if d < self.t1:
            return 1
        if d < self.t2:
            return 2
        if d < self.t3:
            return 3
        return 4


class _Stats:
    def __init__(self, p: _Params):
        a_init = max(2, (p.range + 2 ** 5) // 2 ** 6)
        self.A = [a_init] * 367
        self.B = [0] * 365
        self.C = [0] * 365
        self.N = [1] * 367
        self.Nn = [0, 0]  # contexts 365, 366


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0  # bits pending; 8 normally, 7 after an 0xFF byte

    def _cap(self):
        return 7 if (self.out and self.out[-1] == 0xFF) else 8

    def put(self, value, n):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == self._cap():
                self.out.append(self.acc)
                self.acc = 0
                self.nbits = 0

    def flush(self):
        cap = self._cap()
        if self.nbits:
            self.out.append(self.acc << (cap - self.nbits))
            self.acc = 0
            self.nbits = 0
        if self.out and self.out[-1] == 0xFF:
            # a trailing 0xFF data byte would read as part of the EOI
            # marker; emit the mandatory stuffed (0-MSB) follow-up byte
            self.out.append(0x00)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0
        self.prev_ff = False
        self.overrun = 0

    def bit(self):
        if self.nbits == 0:
            if self.pos >= len(self.data):
                # zero padding past the end is legal for the final few
                # samples, but a desynced stream would spin here forever
                self.overrun += 1
                if self.overrun > 64:
                    raise ValueError("JPEG-LS bitstream exhausted")
                self.acc, self.nbits = 0, 8
            else:
                b = self.data[self.pos]
                self.pos += 1
                if self.prev_ff:
                    self.acc, self.nbits = b & 0x7F, 7
                else:
                    self.acc, self.nbits = b, 8
                self.prev_ff = b == 0xFF
        self.nbits -= 1
        return (self.acc >> self.nbits) & 1

    def bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


def _golomb_encode(bw, val, k, glimit, qbpp):
    q = val >> k
    if q < glimit - qbpp - 1:
        bw.put(1, q + 1)            # q zeros then a 1
        if k:
            bw.put(val & ((1 << k) - 1), k)
    else:
        bw.put(1, glimit - qbpp)    # (glimit-qbpp-1) zeros then a 1
        bw.put(val - 1, qbpp)


def _golomb_decode(br, k, glimit, qbpp):
    q = 0
    while br.bit() == 0:
        q += 1
    if q < glimit - qbpp - 1:
        return (q << k) + (br.bits(k) if k else 0)
    return br.bits(qbpp) + 1


def _context_and_sign(p, d1, d2, d3):
    q1 = p.quantize_gradient(d1)
    q2 = p.quantize_gradient(d2)
    q3 = p.quantize_gradient(d3)
    if q1 < 0 or (q1 == 0 and (q2 < 0 or (q2 == 0 and q3 < 0))):
        return (-q1) * 81 + (-q2) * 9 + (-q3), -1
    return q1 * 81 + q2 * 9 + q3, 1


def _k_of(a, n):
    k = 0
    while (n << k) < a:
        k += 1
    return k


def _update(st, q, errval, p):
    st.B[q] += errval * (2 * p.near + 1)
    st.A[q] += abs(errval)
    if st.N[q] == p.reset:
        st.A[q] >>= 1
        st.B[q] = st.B[q] // 2 if st.B[q] >= 0 else -((1 - st.B[q]) // 2)
        st.N[q] >>= 1
    st.N[q] += 1
    if st.B[q] <= -st.N[q]:
        if st.C[q] > -128:
            st.C[q] -= 1
        st.B[q] += st.N[q]
        if st.B[q] <= -st.N[q]:
            st.B[q] = -st.N[q] + 1
    elif st.B[q] > 0:
        if st.C[q] < 127:
            st.C[q] += 1
        st.B[q] -= st.N[q]
        if st.B[q] > 0:
            st.B[q] = 0


def _predict(a, b, c):
    if c >= max(a, b):
        return min(a, b)
    if c <= min(a, b):
        return max(a, b)
    return a + b - c


def _ri_stats_k(st, ritype):
    q = 365 + ritype
    temp = st.A[q] + ((st.N[q] >> 1) if ritype else 0)
    return q, _k_of(temp, st.N[q])


def encode(arr: np.ndarray, near: int = 0, maxval: int | None = None) -> bytes:
    """Encode a (rows, cols) unsigned array as a JPEG-LS stream."""
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError("single-component 2-D only")
    rows, cols = arr.shape
    if maxval is None:
        maxval = max(1, int(arr.max()))
    precision = max(2, maxval.bit_length())
    maxval = min(maxval, (1 << precision) - 1)
    p = _Params(maxval, near, *_default_thresholds(maxval, near), 64)
    st = _Stats(p)
    bw = _BitWriter()
    x = arr.astype(np.int64)
    prev = np.zeros(cols + 2, np.int64)
    cur = np.zeros(cols + 2, np.int64)
    mod = p.range * (2 * near + 1)
    for y in range(rows):
        prev, cur = cur, prev
        cur[0] = prev[1]
        prev[cols + 1] = prev[cols]
        xi = 1
        while xi <= cols:
            a = int(cur[xi - 1])
            b = int(prev[xi])
            c = int(prev[xi - 1])
            d = int(prev[xi + 1])
            sample = int(x[y, xi - 1])
            if (abs(d - b) <= near and abs(b - c) <= near
                    and abs(c - a) <= near):
                # --- run mode (A.7) --------------------------------------
                runcnt = 0
                while xi <= cols and abs(int(x[y, xi - 1]) - a) <= near:
                    cur[xi] = a if near else int(x[y, xi - 1])
                    runcnt += 1
                    xi += 1
                runindex = getattr(st, "runindex", 0)
                while runcnt >= (1 << J[runindex]):
                    bw.put(1, 1)
                    runcnt -= 1 << J[runindex]
                    if runindex < 31:
                        runindex += 1
                if xi > cols:  # run broken by end of line
                    if runcnt > 0:
                        bw.put(1, 1)
                    st.runindex = runindex
                    continue
                bw.put(0, 1)
                if J[runindex]:
                    bw.put(runcnt, J[runindex])
                # run-interruption sample (A.7.2)
                sample = int(x[y, xi - 1])
                b = int(prev[xi])
                ritype = 1 if abs(a - b) <= near else 0
                px = a if ritype else b
                sign = -1 if (ritype == 0 and a > b) else 1
                errval = sample - px
                if sign < 0:
                    errval = -errval
                if near:
                    errval = ((near + errval) // (2 * near + 1) if errval > 0
                              else -((near - errval) // (2 * near + 1)))
                if errval < 0:
                    errval += p.range
                if errval >= (p.range + 1) // 2:
                    errval -= p.range
                q, k = _ri_stats_k(st, ritype)
                s_flag = 2 * st.Nn[q - 365] < st.N[q]
                if errval > 0:
                    emap = 1 if (k == 0 and s_flag) else 0
                elif errval < 0:
                    emap = 0 if (k == 0 and s_flag) else 1
                else:
                    emap = 0
                emerr = 2 * abs(errval) - ritype - emap
                glimit = p.limit - J[runindex] - 1
                _golomb_encode(bw, emerr, k, glimit, p.qbpp)
                if errval < 0:
                    st.Nn[q - 365] += 1
                st.A[q] += (emerr + 1 - ritype) >> 1
                if st.N[q] == p.reset:
                    st.A[q] >>= 1
                    st.N[q] >>= 1
                    st.Nn[q - 365] >>= 1
                st.N[q] += 1
                # reconstruct
                rec = px + (sign * errval * (2 * near + 1))
                if rec < -near:
                    rec += mod
                elif rec > maxval + near:
                    rec -= mod
                cur[xi] = min(max(rec, 0), maxval)
                st.runindex = max(0, runindex - 1)
                xi += 1
                continue
            # --- regular mode (A.4-A.6) ----------------------------------
            q, sign = _context_and_sign(p, d - b, b - c, c - a)
            px = _predict(a, b, c) + sign * st.C[q]
            px = min(max(px, 0), maxval)
            errval = sample - px
            if sign < 0:
                errval = -errval
            if near:
                errval = ((near + errval) // (2 * near + 1) if errval > 0
                          else -((near - errval) // (2 * near + 1)))
            if errval < 0:
                errval += p.range
            if errval >= (p.range + 1) // 2:
                errval -= p.range
            k = _k_of(st.A[q], st.N[q])
            if near == 0 and k == 0 and 2 * st.B[q] <= -st.N[q]:
                merr = 2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
            else:
                merr = 2 * errval if errval >= 0 else -2 * errval - 1
            _golomb_encode(bw, merr, k, p.limit, p.qbpp)
            _update(st, q, errval, p)
            rec = px + sign * errval * (2 * near + 1)
            if rec < -near:
                rec += mod
            elif rec > maxval + near:
                rec -= mod
            cur[xi] = min(max(rec, 0), maxval)
            xi += 1
    bw.flush()

    def seg(marker, payload):
        return struct.pack(">HH", marker, len(payload) + 2) + payload

    head = struct.pack(">H", 0xFFD8)
    head += seg(0xFFF7, struct.pack(">BHHB", precision, rows, cols, 1)
                + bytes([1, 0x11, 0]))  # SOF55, 1 component
    head += seg(0xFFF8, struct.pack(">BHHHHH", 1, maxval, p.t1, p.t2, p.t3,
                                    p.reset))  # LSE id 1
    head += seg(0xFFDA, bytes([1, 1, 0, near, 0, 0]))  # SOS
    return head + bytes(bw.out) + struct.pack(">H", 0xFFD9)


def decode(data: bytes) -> np.ndarray:
    """Decode a single-component JPEG-LS stream to (rows, cols) uint16."""
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise ValueError("not a JPEG-LS stream")
    pos = 2
    precision = rows = cols = 0
    maxval = t1 = t2 = t3 = None
    reset, near = 64, 0
    scan_start = -1
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        if data[pos + 1] == 0xFF:  # fill byte before a marker
            pos += 1
            continue
        m = struct.unpack_from(">H", data, pos)[0]
        pos += 2
        if m in (0xFFD8, 0xFF01) or 0xFFD0 <= m <= 0xFFD7:
            continue
        if m == 0xFFD9:
            break
        (seglen,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2:pos + seglen]
        if m == 0xFFF7:  # SOF55
            precision = seg[0]
            rows, cols = struct.unpack_from(">HH", seg, 1)
            if seg[5] != 1:
                raise ValueError("only single-component JPEG-LS supported")
        elif m == 0xFFF8 and seg and seg[0] == 1:  # LSE coding params
            maxval, t1, t2, t3, reset = struct.unpack_from(">HHHHH", seg, 1)
        elif m == 0xFFDA:  # SOS
            ns = seg[0]
            near = seg[1 + 2 * ns]
            scan_start = pos + seglen
            break
        pos += seglen
    if scan_start < 0 or not rows:
        raise ValueError("truncated JPEG-LS stream")
    if maxval in (None, 0):
        maxval = (1 << precision) - 1
    if t1 in (None, 0):
        t1, t2, t3 = _default_thresholds(maxval, near)
    p = _Params(maxval, near, t1, t2, t3, reset or 64)
    st = _Stats(p)
    # entropy data runs to the EOI (FFD9) or next marker; bit stuffing means
    # 0xFF bytes inside data are followed by a 0 bit, so a real marker
    # (0xFF then high bit set) terminates
    end = scan_start
    while end < n - 1:
        if data[end] == 0xFF and data[end + 1] & 0x80:
            break
        end += 1
    br = _BitReader(data[scan_start:end])

    out = np.zeros((rows, cols), np.int64)
    prev = np.zeros(cols + 2, np.int64)
    cur = np.zeros(cols + 2, np.int64)
    mod = p.range * (2 * near + 1)
    runindex = 0
    for y in range(rows):
        prev, cur = cur, prev
        cur[0] = prev[1]
        prev[cols + 1] = prev[cols]
        xi = 1
        while xi <= cols:
            a = int(cur[xi - 1])
            b = int(prev[xi])
            c = int(prev[xi - 1])
            d = int(prev[xi + 1])
            if (abs(d - b) <= near and abs(b - c) <= near
                    and abs(c - a) <= near):
                # --- run mode ------------------------------------------
                eol = False
                while True:
                    if br.bit() == 1:
                        rg = 1 << J[runindex]
                        remaining = cols - xi + 1
                        fill = min(rg, remaining)
                        for _ in range(fill):
                            cur[xi] = a
                            out[y, xi - 1] = a
                            xi += 1
                        if rg <= remaining and runindex < 31:
                            # a FULL segment bumps RUNindex on the encoder
                            # even when it lands exactly on end-of-line —
                            # mirror it or the J tables desync; only the
                            # partial EOL-terminating '1' (rg > remaining)
                            # skips the bump
                            runindex += 1
                        if fill == remaining:
                            eol = True
                            break
                    else:
                        if J[runindex]:
                            cnt = br.bits(J[runindex])
                            for _ in range(cnt):
                                cur[xi] = a
                                out[y, xi - 1] = a
                                xi += 1
                        break
                if eol:
                    continue
                # run-interruption sample
                b = int(prev[xi])
                ritype = 1 if abs(a - b) <= near else 0
                px = a if ritype else b
                sign = -1 if (ritype == 0 and a > b) else 1
                q, k = _ri_stats_k(st, ritype)
                glimit = p.limit - J[runindex] - 1
                emerr = _golomb_decode(br, k, glimit, p.qbpp)
                s_flag = 2 * st.Nn[q - 365] < st.N[q]
                total = emerr + ritype
                if k == 0 and s_flag:
                    errval = (total + 1) // 2 if total % 2 else -(total // 2)
                else:
                    errval = total // 2 if total % 2 == 0 else -((total + 1) // 2)
                if errval < 0:
                    st.Nn[q - 365] += 1
                st.A[q] += (emerr + 1 - ritype) >> 1
                if st.N[q] == p.reset:
                    st.A[q] >>= 1
                    st.N[q] >>= 1
                    st.Nn[q - 365] >>= 1
                st.N[q] += 1
                rec = px + sign * errval * (2 * near + 1)
                if rec < -near:
                    rec += mod
                elif rec > maxval + near:
                    rec -= mod
                rec = min(max(rec, 0), maxval)
                cur[xi] = rec
                out[y, xi - 1] = rec
                runindex = max(0, runindex - 1)
                xi += 1
                continue
            # --- regular mode --------------------------------------------
            q, sign = _context_and_sign(p, d - b, b - c, c - a)
            px = _predict(a, b, c) + sign * st.C[q]
            px = min(max(px, 0), maxval)
            k = _k_of(st.A[q], st.N[q])
            merr = _golomb_decode(br, k, p.limit, p.qbpp)
            if near == 0 and k == 0 and 2 * st.B[q] <= -st.N[q]:
                errval = (merr - 1) // 2 if merr % 2 else -(merr // 2) - 1
            else:
                errval = merr // 2 if merr % 2 == 0 else -((merr + 1) // 2)
            _update(st, q, errval, p)
            rec = px + sign * errval * (2 * near + 1)
            if rec < -near:
                rec += mod
            elif rec > maxval + near:
                rec -= mod
            rec = min(max(rec, 0), maxval)
            cur[xi] = rec
            out[y, xi - 1] = rec
            xi += 1
    return out.astype(np.uint16)

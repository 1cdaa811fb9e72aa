"""JPEG decoding on the host (no OpenCV, no PIL, no libjpeg).

`decode(data, name)` returns what `cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)`
returns, byte for byte, for the JPEG files a camera dataset stores:
[H, W] uint8 for one component, [H, W, 3] uint8 in BGR order for three
(YCbCr, or RGB where the file says so). It reproduces libjpeg-turbo's
default decompression, which OpenCV's reader uses: the integer `islow`
IDCT (jidctint.c), "fancy" triangle upsampling of 2x1, 1x2 and 2x2
subsampled chroma (jdsample.c, edges replicated), and the fixed-point
YCbCr -> RGB tables (jdcolor.c). EXIF orientation is not applied
(IMREAD_UNCHANGED does not apply it).

Read: SOI, APPn / COM (skipped), DQT (8- and 16-bit tables), DHT,
SOF0 / SOF1 / SOF2 (baseline, extended Huffman and progressive, 8-bit),
DRI with RSTn, SOS, EOI. Progressive scans cover spectral selection and
successive approximation, DC and AC, first and refinement passes. Raise
ValueError, naming the file and the reason: arithmetic coding, 12-bit
precision, lossless or hierarchical coding, other than 1 or 3 components
(CMYK / YCCK), a component sampled at other than 1x1, 2x1, 1x2 or 2x2 of
the largest factors, a progressive file whose low AC coefficients are left
unrefined (libjpeg would smooth those blocks), and truncated or corrupt
data (where libjpeg warns and fills with zeros).

The work runs in a host routine (csrc/jpeg_decode.cpp, built with the host
C++ compiler at first use through ops/cuda_lib.py; the call releases the
GIL, so the dataset's read-ahead thread decodes beside the tracker).
`decode_plain` is the same decoder in Python and numpy (Huffman decoding
bit by bit, the IDCT vectorized over blocks), reached only from tests,
which hold the two equal on small files.
"""

from __future__ import annotations

import ctypes

import numpy as np

SIGNATURE = b"\xff\xd8\xff"
_ERR_LEN = 256

# zigzag position k -> natural (row-major) position (jpeg_natural_order)
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a JPEG file's bytes into cv2.imdecode(IMREAD_UNCHANGED)'s array
    ([H, W] gray or [H, W, 3] BGR, uint8); `name` labels errors."""
    from ..ops import cuda_lib

    lib = cuda_lib.load("jpeg_decode")
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = np.zeros(3, np.int32)
    if lib.jpeg_header(buf.ctypes.data, len(buf), dims.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    h, w, nc = (int(x) for x in dims)
    out = np.empty((h, w, nc) if nc == 3 else (h, w), np.uint8)
    if lib.jpeg_decode(buf.ctypes.data, len(buf), out.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


# ---------------------------------------------------------------------------
# the plain version: Python and numpy


class _Huffman:
    """A canonical Huffman table (JPEG Annex C) decoded one bit at a time."""

    def __init__(self, counts, values):
        self.maxcode, self.valptr, self.mincode = [-1] * 17, [0] * 17, [0] * 17
        self.values = list(values)
        code = k = 0
        for length in range(1, 17):
            n = counts[length - 1]
            if n:
                self.valptr[length], self.mincode[length] = k, code
                code += n
                k += n
                self.maxcode[length] = code - 1
                if code > (1 << length):
                    raise ValueError("bad Huffman table")
            code <<= 1
        if k != len(self.values):
            raise ValueError("bad Huffman table")

    def decode(self, bits) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | bits.bit()
            if code <= self.maxcode[length]:
                return self.values[self.valptr[length] + code - self.mincode[length]]
        raise ValueError("corrupt data (bad Huffman code)")


class _Bits:
    """The entropy-coded segment of a scan, bit by bit: stuffed 0xFF 0x00
    bytes give 0xFF, and a marker ends the segment (reading past it is an
    error: libjpeg would insert zeros)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.acc, self.n = data, pos, 0, 0

    def bit(self) -> int:
        if self.n == 0:
            d, p = self.data, self.pos
            if p >= len(d):
                raise ValueError("truncated data")
            b = d[p]
            if b == 0xFF:
                if p + 1 >= len(d):
                    raise ValueError("truncated data")
                if d[p + 1] != 0:
                    raise ValueError("corrupt data (scan data ends early)")
                p += 1
            self.pos, self.acc, self.n = p + 1, b, 8
        self.n -= 1
        return (self.acc >> self.n) & 1

    def bits(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self.bit()
        return v

    def restart(self, expect: int):
        """Byte-align and read the marker RSTn, n = expect."""
        self.n = 0
        d, p = self.data, self.pos
        while p + 1 < len(d) and d[p] == 0xFF and d[p + 1] == 0xFF:
            p += 1
        if p + 1 >= len(d) or d[p] != 0xFF or d[p + 1] != 0xD0 + expect:
            raise ValueError(f"corrupt data (RST{expect} marker missing)")
        self.pos = p + 2


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


class _Frame:
    def __init__(self, body: bytes, progressive: bool):
        if len(body) < 6:
            raise ValueError("corrupt SOF segment")
        precision = body[0]
        if precision != 8:
            raise ValueError(f"{precision}-bit precision is not supported (8-bit only)")
        self.h = (body[1] << 8) | body[2]
        self.w = (body[3] << 8) | body[4]
        nc = body[5]
        if self.h == 0 or self.w == 0:
            raise ValueError("image size 0 (DNL markers are not supported)")
        if nc not in (1, 3):
            raise ValueError(f"{nc} components (CMYK/YCCK or other) are not supported")
        if len(body) < 6 + 3 * nc:
            raise ValueError("corrupt SOF segment")
        self.progressive = progressive
        self.ids, self.hs, self.vs, self.tq = [], [], [], []
        for c in range(nc):
            cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
            self.ids.append(cid)
            self.hs.append(hv >> 4)
            self.vs.append(hv & 15)
            self.tq.append(tq)
        if not all(1 <= x <= 4 for x in self.hs + self.vs) or any(t > 3 for t in self.tq):
            raise ValueError("corrupt SOF segment")
        self.hmax, self.vmax = max(self.hs), max(self.vs)
        if nc > 1:
            for hh, vv in zip(self.hs, self.vs):
                if (self.hmax // hh, self.vmax // vv) not in ((1, 1), (2, 1), (1, 2), (2, 2)) \
                        or self.hmax % hh or self.vmax % vv:
                    raise ValueError(f"sampling factors {list(zip(self.hs, self.vs))} are not "
                                     "supported (1x1, 2x1, 1x2, 2x2 of the largest only)")
        self.mcux = -(-self.w // (8 * self.hmax))
        self.mcuy = -(-self.h // (8 * self.vmax))
        # each component's blocks (padded to whole MCUs) and its real size
        self.coef = [np.zeros((self.mcuy * v, self.mcux * hh, 64), np.int32)
                     for hh, v in zip(self.hs, self.vs)]
        self.comp_w = [-(-self.w * hh // self.hmax) for hh in self.hs]
        self.comp_h = [-(-self.h * v // self.vmax) for v in self.vs]
        self.qt = [None] * nc  # each component's table, latched at its first scan
        # successive-approximation bit still missing per coefficient (-1: never sent)
        self.coef_bits = np.full((nc, 64), -1, np.int64)


def _scan(data: bytes, pos: int, frame: _Frame, body: bytes, dc_tabs, ac_tabs, qtabs,
          restart: int) -> int:
    """Decode one scan's entropy-coded data starting at pos into the frame's
    coefficients; returns the position after it."""
    ns = body[0]
    if ns < 1 or ns > 4 or len(body) < 4 + 2 * ns:
        raise ValueError("corrupt SOS segment")
    comps = []
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in frame.ids:
            raise ValueError("corrupt SOS segment (unknown component)")
        comps.append((frame.ids.index(cid), t >> 4, t & 15))
    ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    if frame.progressive:
        if (ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63 or ns != 1)) or al > 13:
            raise ValueError("corrupt progressive scan parameters")
    elif ss != 0 or se != 63 or ah or al:
        raise ValueError("corrupt sequential scan parameters")
    for c, td, ta in comps:
        if frame.qt[c] is None:
            q = qtabs[frame.tq[c]]
            if q is None:
                raise ValueError("a component's quantization table is missing")
            frame.qt[c] = q.copy()
        if ss == 0 and ah == 0 and dc_tabs[td] is None:
            raise ValueError("a scan's DC Huffman table is missing")
        if (se > 0 or not frame.progressive) and ac_tabs[ta] is None:
            raise ValueError("a scan's AC Huffman table is missing")
        bits_now = frame.coef_bits[c, ss:se + 1]
        if frame.progressive and ah != 0 and np.any(bits_now != ah):
            raise ValueError("corrupt progressive scan (refinement out of order)")
        frame.coef_bits[c, ss:se + 1] = al if frame.progressive else 0
    bits = _Bits(data, pos)
    if ns == 1:  # non-interleaved: one block per MCU, over the component's own blocks
        c = comps[0][0]
        units = [(by, bx) for by in range(-(-frame.comp_h[c] // 8))
                 for bx in range(-(-frame.comp_w[c] // 8))]
        mcus = [[(c, by, bx)] for by, bx in units]
    else:
        mcus = []
        for my in range(frame.mcuy):
            for mx in range(frame.mcux):
                mcus.append([(c, my * frame.vs[c] + y, mx * frame.hs[c] + x)
                             for c, _, _ in comps
                             for y in range(frame.vs[c]) for x in range(frame.hs[c])])
    tabs = {c: (td, ta) for c, td, ta in comps}
    pred = {c: 0 for c, _, _ in comps}
    eobrun = [0]
    for i, mcu in enumerate(mcus):
        if restart and i and i % restart == 0:
            bits.restart((i // restart - 1) % 8)
            pred = {c: 0 for c in pred}
            eobrun[0] = 0
        for c, by, bx in mcu:
            blk = frame.coef[c][by, bx]
            td, ta = tabs[c]
            if not frame.progressive:
                _block_sequential(bits, blk, dc_tabs[td], ac_tabs[ta], pred, c)
            elif ss == 0 and ah == 0:
                s = dc_tabs[td].decode(bits)
                if s > 11:
                    raise ValueError("corrupt data (bad DC size)")
                pred[c] += _extend(bits.bits(s), s)
                blk[0] = pred[c] * (1 << al)
            elif ss == 0:
                if bits.bit():
                    blk[0] |= 1 << al
            elif ah == 0:
                _block_ac_first(bits, blk, ac_tabs[ta], ss, se, al, eobrun)
            else:
                _block_ac_refine(bits, blk, ac_tabs[ta], ss, se, al, eobrun)
    return bits.pos


def _block_sequential(bits, blk, dc, ac, pred, c):
    s = dc.decode(bits)
    if s > 11:
        raise ValueError("corrupt data (bad DC size)")
    pred[c] += _extend(bits.bits(s), s)
    blk[0] = pred[c]
    k = 1
    while k < 64:
        rs = ac.decode(bits)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                raise ValueError("corrupt data (coefficient index past 63)")
            blk[NATURAL_ORDER[k]] = _extend(bits.bits(s), s)
        elif r != 15:
            break
        else:
            k += 15
        k += 1


def _block_ac_first(bits, blk, ac, ss, se, al, eobrun):
    if eobrun[0] > 0:
        eobrun[0] -= 1
        return
    k = ss
    while k <= se:
        rs = ac.decode(bits)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > se:
                raise ValueError("corrupt data (coefficient index past the band)")
            blk[NATURAL_ORDER[k]] = _extend(bits.bits(s), s) * (1 << al)
        elif r == 15:
            k += 15
        else:
            eobrun[0] = (1 << r) + (bits.bits(r) if r else 0) - 1
            break
        k += 1


def _refine(bits, blk, pos, p1):
    if bits.bit() and (blk[pos] & p1) == 0:
        blk[pos] += p1 if blk[pos] >= 0 else -p1


def _block_ac_refine(bits, blk, ac, ss, se, al, eobrun):
    p1 = 1 << al
    k = ss
    if eobrun[0] == 0:
        while k <= se:
            rs = ac.decode(bits)
            r, s = rs >> 4, rs & 15
            if s:
                if s != 1:
                    raise ValueError("corrupt data (bad refinement size)")
                s = p1 if bits.bit() else -p1
            elif r != 15:
                eobrun[0] = (1 << r) + (bits.bits(r) if r else 0)
                break
            while k <= se:
                pos = NATURAL_ORDER[k]
                if blk[pos] != 0:
                    _refine(bits, blk, pos, p1)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > se:
                    raise ValueError("corrupt data (coefficient index past the band)")
                blk[NATURAL_ORDER[k]] = s
            k += 1
    if eobrun[0] > 0:
        while k <= se:
            pos = NATURAL_ORDER[k]
            if blk[pos] != 0:
                _refine(bits, blk, pos, p1)
            k += 1
        eobrun[0] -= 1


# jidctint.c's constants (CONST_BITS 13, PASS1_BITS 2)
_FIX = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
            f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _idct_1d(d, shift):
    """One pass of jpeg_idct_islow over axis -1 (8 values): int64 arrays in,
    the 8 outputs descaled by `shift` out."""
    f = _FIX
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 - z3 * f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    tmp0 = (d[..., 0] + d[..., 4]) << 13
    tmp1 = (d[..., 0] - d[..., 4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * f["f1175"]
    o0, o1, o2, o3 = o0 * f["f0298"], o1 * f["f2053"], o2 * f["f3072"], o3 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    r = 1 << (shift - 1)
    return np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                     t13 - o0, t12 - o1, t11 - o2, t10 - o3], -1).__add__(r) >> shift


def _idct_range_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit (jdmaster.c), indexed by x & 1023."""
    j = np.arange(1024)
    return np.where(j < 128, j + 128, np.where(j < 512, 255,
                                               np.where(j < 896, 0, j - 896))).astype(np.uint8)


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """jpeg_idct_islow of [..., 64] natural-order coefficients with the
    [64] quantization table: [..., 8, 8] uint8 samples."""
    d = (coef.astype(np.int64) * q.astype(np.int64)).reshape(coef.shape[:-1] + (8, 8))
    ws = _idct_1d(np.swapaxes(d, -1, -2), 13 - 2)  # columns: [..., col, row]
    out = _idct_1d(np.swapaxes(ws, -1, -2), 13 + 2 + 3)  # rows
    return _idct_range_table()[out & 1023]


def _up_h2(x: np.ndarray, fancy: bool) -> np.ndarray:
    if not fancy:
        return np.repeat(x, 2, axis=1)
    x = x.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def upsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a component's real samples (jdsample.c,
    do_fancy_upsampling on): h2v1 and h2v2 "fancy" (triangle) for widths
    over 2, else box; h1v2 always fancy; edges replicated."""
    x = plane.astype(np.int32)
    if fy == 1:
        return x if fx == 1 else _up_h2(x, x.shape[1] > 2)
    above = np.concatenate([x[:1], x[:-1]], 0)
    below = np.concatenate([x[1:], x[-1:]], 0)
    if fx == 1:
        out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
        out[0::2] = (3 * x + above + 1) >> 2
        out[1::2] = (3 * x + below + 2) >> 2
        return out
    if x.shape[1] <= 2:
        return np.repeat(np.repeat(x, 2, axis=0), 2, axis=1)
    cs = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    cs[0::2], cs[1::2] = 3 * x + above, 3 * x + below
    left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
    right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
    out = np.empty((cs.shape[0], 2 * cs.shape[1]), np.int32)
    out[:, 0::2] = (3 * cs + left + 8) >> 4
    out[:, 1::2] = (3 * cs + right + 7) >> 4
    return out


def ycc_to_bgr(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert (SCALEBITS 16), written as BGR."""
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    half = 1 << 15
    cb, cr = cb - 128, cr - 128
    r = y + ((91881 * cr + half) >> 16)
    g = y + ((-46802 * cr + (-22554 * cb + half)) >> 16)
    b = y + ((116130 * cb + half) >> 16)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def _color_space_rgb(frame: _Frame, jfif: bool, adobe) -> bool:
    """libjpeg's guess (jdapimin.c default_decompress_parms): True when the
    three components are R, G, B rather than Y, Cb, Cr."""
    if jfif:
        return False
    if adobe is not None:
        return adobe == 0
    return frame.ids == [82, 71, 66]


def decode_plain(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """decode() in Python and numpy; for tests on small files."""
    try:
        return _decode_plain(bytes(data))
    except (IndexError, ValueError) as e:
        msg = str(e) if isinstance(e, ValueError) else "truncated data"
        raise ValueError(f"{name}: {msg}") from None


def _decode_plain(data: bytes) -> np.ndarray:
    if data[:3] != SIGNATURE:
        raise ValueError("not a JPEG file")
    dc_tabs, ac_tabs, qtabs = [None] * 4, [None] * 4, [None] * 4
    frame, restart, jfif, adobe = None, 0, False, None
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # bytes before a marker (libjpeg skips them)
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError("truncated data (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        ln = (data[pos] << 8) | data[pos + 1]
        body = data[pos + 2:pos + ln]
        if ln < 2 or len(body) != ln - 2:
            raise ValueError("truncated data")
        pos += ln
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("corrupt data (a second SOF marker)")
            frame = _Frame(body, marker == 0xC2)
        elif marker in (0xC3, 0xC7, 0xCB, 0xCF):
            raise ValueError("lossless JPEG is not supported")
        elif marker in (0xC9, 0xCA, 0xCB, 0xCC, 0xCD, 0xCE) or marker == 0xCC:
            raise ValueError("arithmetic-coded JPEG is not supported")
        elif marker in (0xC5, 0xC6, 0xDE, 0xDF):
            raise ValueError("hierarchical JPEG is not supported")
        elif marker == 0xC4:
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                counts = list(body[p + 1:p + 17])
                n = sum(counts)
                if tc > 1 or th > 3 or len(counts) != 16 or p + 17 + n > len(body):
                    raise ValueError("corrupt DHT segment")
                (ac_tabs if tc else dc_tabs)[th] = _Huffman(counts, body[p + 17:p + 17 + n])
                p += 17 + n
        elif marker == 0xDB:
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                size = 128 if pq else 64
                if pq > 1 or tq > 3 or p + 1 + size > len(body):
                    raise ValueError("corrupt DQT segment")
                raw = np.frombuffer(body[p + 1:p + 1 + size], ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[NATURAL_ORDER] = raw
                qtabs[tq] = q
                p += 1 + size
        elif marker == 0xDD:
            if len(body) < 2:
                raise ValueError("corrupt DRI segment")
            restart = (body[0] << 8) | body[1]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt data (SOS before SOF)")
            pos = _scan(data, pos, frame, body, dc_tabs, ac_tabs, qtabs, restart)
        elif marker == 0xE0:
            jfif = jfif or body[:5] == b"JFIF\x00"
        elif marker == 0xEE:
            if body[:5] == b"Adobe" and len(body) >= 12:
                adobe = body[11]
        elif 0xE1 <= marker <= 0xEF or marker == 0xFE:
            pass
        else:
            raise ValueError(f"unsupported marker 0xFF{marker:02X}")
    if frame is None:
        raise ValueError("no image (no SOF marker)")
    if np.any(frame.coef_bits[:, 0] < 0):
        raise ValueError("truncated data (a component was never coded)")
    if frame.progressive and np.any(frame.coef_bits[:, 1:10] != 0):
        raise ValueError("progressive file with unrefined low AC coefficients (libjpeg "
                         "would smooth its blocks) is not supported")
    planes = []
    for c in range(len(frame.ids)):
        blocks = idct_islow(frame.coef[c], frame.qt[c])  # [by, bx, 8, 8]
        by, bx = blocks.shape[:2]
        plane = blocks.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        plane = plane[:frame.comp_h[c], :frame.comp_w[c]]
        up = upsample(plane, frame.hmax // frame.hs[c], frame.vmax // frame.vs[c])
        planes.append(up[:frame.h, :frame.w])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    if _color_space_rgb(frame, jfif, adobe):
        return np.stack(planes[::-1], -1).astype(np.uint8)
    return ycc_to_bgr(*planes)

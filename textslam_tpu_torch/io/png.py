"""PNG decoding on the host with zlib and numpy (no OpenCV, no PIL).

`decode(data)` returns what `cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)` returns
for every PNG: 8- and 16-bit gray [H, W]; 1-, 2- and 4-bit gray expanded
to 8 bits [H, W] (1-bit as 0 / 255, libpng's expand_gray_1_2_4_to_8);
gray+alpha and RGBA as BGRA [H, W, 4]; RGB as BGR [H, W, 3], or BGRA when
a tRNS chunk names a transparent color (alpha 0 there, else the largest
sample); palette files (1, 2, 4 or 8-bit indices) through PLTE as BGR, or
BGRA when a tRNS chunk gives the entries' alpha (255 past its end); a gray
file's tRNS is dropped, as cv2 drops it; uint16 for 16-bit files. Adam7
interlaced files decode pass by pass at every depth and color type. Chunk
CRCs are checked and IDAT data may be split over any number of chunks;
corrupt or truncated files raise ValueError naming the file.

Unfiltering runs in a small host routine (csrc/png_unfilter.cpp, built with
the host C++ compiler at first use, ops/cuda_lib.py), applied to each
interlace pass on its own: Average and Paeth rows make each byte a
nonlinear function of the byte to its left, a chain numpy can only follow
one pixel at a time. The call releases the GIL, so a read-ahead thread
decodes beside the tracker.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel: gray, RGB, palette index, gray+alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# color type -> the bit depths the PNG specification allows
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunks(data: bytes, name: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        if zlib.crc32(body, zlib.crc32(kind)) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: CRC mismatch in {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: no IEND chunk")


def unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters. raw: [H, 1 + stride] uint8, each row its
    filter type then its filtered bytes; bpp: bytes per complete pixel.
    Returns the [H, stride] uint8 image bytes."""
    from ..ops import cuda_lib

    raw = np.ascontiguousarray(raw, np.uint8)
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    if cuda_lib.load("png_unfilter").png_unfilter(raw.ctypes.data, out.ctypes.data, h, stride, bpp):
        raise ValueError(f"unknown PNG filter type {int(raw[:, 0].max())}")
    return out


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """[h, row bytes] unfiltered rows -> [h, w, ch] samples (uint8, uint16
    for 16-bit; 1, 2 and 4-bit samples unpacked from the high bit)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)[:, :w * ch].reshape(h, w, ch)
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    v = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return v.reshape(h, -1)[:, :w * ch].reshape(h, w, ch).astype(np.uint8)


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a PNG file's bytes into cv2.imdecode(IMREAD_UNCHANGED)'s array
    (channels in BGR / BGRA order); `name` labels errors."""
    header, idat, plte, trns = None, [], None, None
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{name}: corrupt IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8)
        elif kind == b"tRNS":
            trns = body
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in CHANNELS or depth not in DEPTHS[ctype] or interlace > 1 or not w or not h:
        raise ValueError(f"{name}: corrupt IHDR chunk (color type {ctype}, bit depth {depth}, "
                         f"interlace {interlace})")
    if ctype == 3 and (plte is None or len(plte) % 3 or not 0 < len(plte) <= 768):
        raise ValueError(f"{name}: palette file without a valid PLTE chunk")
    ch = CHANNELS[ctype]
    bits = ch * depth  # per pixel
    bpp = max(1, bits // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data ({e})") from None
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * bits // 8)
        n = ph * (1 + stride)
        if len(raw) < pos + n:
            raise ValueError(f"{name}: image data too short")
        try:
            rows = unfilter(np.frombuffer(raw, np.uint8, n, pos).reshape(ph, 1 + stride), bpp)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
        img[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += n
    if ctype == 3:
        pal = plte.reshape(-1, 3)
        idx = img[:, :, 0]
        if int(idx.max()) >= len(pal):
            raise ValueError(f"{name}: palette index past the PLTE chunk's {len(pal)} entries")
        bgr = pal[idx][:, :, ::-1]
        if trns is None:
            return np.ascontiguousarray(bgr)
        alpha = np.full(len(pal), 255, np.uint8)
        alpha[:min(len(trns), len(pal))] = np.frombuffer(trns, np.uint8)[:len(pal)]
        return np.concatenate([bgr, alpha[idx][:, :, None]], -1)
    if ch == 1:
        if depth < 8:
            return (img[:, :, 0] * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return img[:, :, 0]
    if ch == 2:  # gray+alpha -> BGRA
        g, a = img[:, :, 0], img[:, :, 1]
        return np.stack([g, g, g, a], -1)
    if ch == 3 and trns is not None:  # a transparent RGB color -> BGRA
        if len(trns) < 6:
            raise ValueError(f"{name}: corrupt tRNS chunk")
        key = np.frombuffer(trns[:6], ">u2").astype(img.dtype)
        top = np.iinfo(img.dtype).max
        alpha = np.where((img == key).all(-1), 0, top).astype(img.dtype)
        return np.concatenate([img[:, :, ::-1], alpha[:, :, None]], -1)
    return np.ascontiguousarray(img[:, :, [2, 1, 0, 3][:ch]])  # RGB(A) -> BGR(A)

"""PNG decoding on the host with zlib and numpy (no OpenCV, no PIL).

`decode(data)` returns what `cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)` returns
for the formats a camera dataset stores: 8-bit gray [H, W], gray+alpha and
RGBA as BGRA [H, W, 4], RGB as BGR [H, W, 3], and the same at 16 bits per
sample (uint16). Chunk CRCs are checked and IDAT data may be split over
any number of chunks. Interlaced, palette and sub-byte (1, 2, 4-bit) files
raise ValueError.

Unfiltering runs in a small host routine (csrc/png_unfilter.cpp, built with
the host C++ compiler at first use, ops/cuda_lib.py): Average and Paeth rows
make each byte a nonlinear function of the byte to its left, a chain numpy
can only follow one pixel at a time. The call releases the GIL, so a
read-ahead thread decodes beside the tracker.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel: gray, RGB, gray+alpha, RGBA (3, the
# palette, is not supported)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a PNG file's bytes into cv2.imdecode(IMREAD_UNCHANGED)'s array
    (channels in BGR / BGRA order); `name` labels errors."""
    header, idat = None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in CHANNELS:
        raise ValueError(f"{name}: PNG color type {ctype} (palette) is not supported")
    if depth not in (8, 16):
        raise ValueError(f"{name}: PNG bit depth {depth} is not supported (8 or 16 only)")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    ch = CHANNELS[ctype]
    bpp = ch * depth // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data ({e})") from None
    if len(raw) < h * (1 + w * bpp):
        raise ValueError(f"{name}: image data too short")
    raw = np.frombuffer(raw, np.uint8, h * (1 + w * bpp)).reshape(h, 1 + w * bpp)
    img = unfilter(raw, bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(h, w, ch)
    if ch == 1:
        return img[:, :, 0]
    if ch == 2:  # gray+alpha -> BGRA
        g, a = img[:, :, 0], img[:, :, 1]
        return np.stack([g, g, g, a], -1)
    return np.ascontiguousarray(img[:, :, [2, 1, 0, 3][:ch]])  # RGB(A) -> BGR(A)

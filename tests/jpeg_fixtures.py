#!/usr/bin/env python3
"""The committed image fixtures of the port's reader and their reference
decodes.

    python tests/jpeg_fixtures.py            # (re)write tests/jpeg/, tests/png/ and the records
    python tests/jpeg_fixtures.py --check    # hold the committed files to cv2 again

Writes small JPEG files (tests/jpeg/) made with cv2 and PIL from seeded
content (a rendered text-world frame of tests/torch_synth.py, tinted to
color): baseline 4:4:4, 4:2:2, 4:2:0 and 4:4:0, gray, progressive color
and gray, restart intervals (baseline and progressive), sizes that are not
multiples of the MCU (641x479, 17x9, 1x1), qualities 50 and 95, 16-bit
quantization tables (SOF1), and an EXIF orientation tag; and the PNG
variants (tests/png/): palette files at 1, 2, 4 and 8 bits with and
without tRNS, 1-, 2- and 4-bit gray, an RGB file with a transparent color,
and Adam7-interlaced files at several depths and color types. Then records
the SHA-256 and shape of cv2.imdecode(..., IMREAD_UNCHANGED) of each in
tests/jpeg_reference.json and tests/png_reference.json, which
tests/test_torch_jpeg.py and chip_smoke.py phase 8 (a machine without cv2)
hold the port's decoders to. Needs cv2 and PIL; run again, the script
rewrites the same bytes.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]  # the repository (the port) and tests/
JPEG_DIR, PNG_DIR = os.path.join(HERE, "jpeg"), os.path.join(HERE, "png")
JPEG_RECORD = os.path.join(HERE, "jpeg_reference.json")
PNG_RECORD = os.path.join(HERE, "png_reference.json")


def digest(arr: np.ndarray) -> dict:
    """The record of one decode: SHA-256 of its bytes, shape, dtype."""
    arr = np.ascontiguousarray(arr)
    return {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(), "shape": list(arr.shape),
            "dtype": str(arr.dtype)}


def _content(h: int, w: int):
    """(gray [h, w], BGR [h, w, 3]) uint8 crops of a rendered text-world frame."""
    import torch_synth

    frames, _, _, _ = torch_synth.render_text_sequence(1, seed=0)
    f = np.tile(frames[0], (-(-h // frames[0].shape[0]), -(-w // frames[0].shape[1])))[:h, :w]
    g = f.clip(0, 255).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    bgr = np.stack([g, (0.6 * g + 80 * np.sin(xx / 23.0) + 60).clip(0, 255),
                    (255 - g) * 0.5 + 100 * (yy / max(h, 1))], -1).clip(0, 255).astype(np.uint8)
    return g, bgr


def _pil(img: np.ndarray, **kw) -> bytes:
    from PIL import Image

    arr = img[:, :, ::-1] if img.ndim == 3 else img  # BGR -> RGB
    b = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(arr)).save(b, "JPEG", **kw)
    return b.getvalue()


def _cv2(img: np.ndarray, **kw) -> bytes:
    import cv2

    params = []
    names = {"quality": cv2.IMWRITE_JPEG_QUALITY, "progressive": cv2.IMWRITE_JPEG_PROGRESSIVE,
             "restart": cv2.IMWRITE_JPEG_RST_INTERVAL,
             "sampling": cv2.IMWRITE_JPEG_SAMPLING_FACTOR}
    for k, v in kw.items():
        params += [names[k], int(v)]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def jpeg_files() -> dict:
    import cv2
    from PIL import Image

    g, bgr = _content(48, 64)
    g_odd, bgr_odd = _content(479, 641)
    g_tiny, bgr_tiny = _content(9, 17)
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440
    out = {
        "base444_q95.jpg": _pil(bgr, quality=95, subsampling=0),
        "base422_q50.jpg": _pil(bgr, quality=50, subsampling=1),
        "base420_q95.jpg": _pil(bgr, quality=95, subsampling=2),
        "base420_q50.jpg": _pil(bgr, quality=50, subsampling=2),
        "base440_q90.jpg": _cv2(bgr, quality=90, sampling=sf),
        "gray_q75.jpg": _pil(g, quality=75),
        "prog420_q90.jpg": _pil(bgr, quality=90, subsampling=2, progressive=True),
        "prog444_q50.jpg": _pil(bgr, quality=50, subsampling=0, progressive=True),
        "prog_gray_q90.jpg": _pil(g, quality=90, progressive=True),
        "rst420_q90.jpg": _cv2(bgr, quality=90, restart=3),
        "rst440_q80.jpg": _cv2(bgr, quality=80, restart=1, sampling=sf),
        "prog_rst_q85.jpg": _cv2(bgr, quality=85, progressive=1, restart=2),
        "odd641x479_420_q90.jpg": _cv2(bgr_odd, quality=90),
        "odd641x479_prog_gray.jpg": _pil(g_odd, quality=80, progressive=True),
        "odd17x9_422_q95.jpg": _pil(bgr_tiny, quality=95, subsampling=1),
        "odd17x9_420_prog.jpg": _pil(bgr_tiny, quality=70, subsampling=2, progressive=True),
        "odd17x9_440_rst.jpg": _cv2(bgr_tiny, quality=60, restart=1, sampling=sf),
        "odd17x9_gray.jpg": _pil(g_tiny, quality=95),
        "one_pixel.jpg": _pil(bgr[:1, :1], quality=90),
    }
    # 16-bit quantization tables: values past 255 (PIL writes them as given, SOF1)
    q = [list(range(200, 264)), [300] * 64]
    out["qt16_420.jpg"] = _pil(bgr, qtables=q, subsampling=2)
    # an EXIF orientation of 6 (rotate 90): IMREAD_UNCHANGED ignores it
    exif = Image.Exif()
    exif[0x0112] = 6
    out["exif_orient6.jpg"] = _pil(bgr, quality=90, exif=exif.tobytes())
    return out


def png_files() -> dict:
    from PIL import Image

    import torch_synth as ts

    g, bgr = _content(48, 64)
    rng = np.random.default_rng(9)
    out = {}

    def pil(img, **kw):
        b = io.BytesIO()
        img.save(b, "PNG", **kw)
        return b.getvalue()

    pal_img = Image.fromarray(np.ascontiguousarray(bgr[:, :, ::-1])).quantize(colors=200, method=2)
    out["pal8.png"] = pil(pal_img)
    out["pal8_trns.png"] = pil(pal_img, transparency=bytes(rng.integers(0, 256, 120, np.uint8)))
    for bits in (1, 2, 4):
        im = Image.fromarray(np.ascontiguousarray(bgr[:, :, ::-1])).quantize(colors=1 << bits)
        out[f"pal{bits}.png"] = pil(im, bits=bits)
    out["gray1_pil.png"] = pil(Image.fromarray(g > 128))
    for bits in (2, 4):
        out[f"gray{bits}.png"] = ts.png_file(g >> (8 - bits), bits, 0)
    out["rgb_trns.png"] = ts.png_file((bgr[:, :, ::-1] >> 6) << 6, 8, 2,
                                      trns=bytes([0, 64, 0, 128, 0, 0]))
    out["adam7_gray8.png"] = ts.png_file(g, 8, 0, interlace=True)
    out["adam7_rgb8.png"] = ts.png_file(bgr[:, :, ::-1], 8, 2, interlace=True)
    rgba = np.concatenate([bgr[:, :, ::-1], g[:, :, None]], -1).astype(np.uint16) * 257
    out["adam7_rgba16.png"] = ts.png_file(rgba, 16, 6, interlace=True)
    out["adam7_gray1.png"] = ts.png_file((g[:13, :11] > 100).astype(np.uint8), 1, 0, interlace=True)
    pal = np.asarray(pal_img.getpalette()[:48], np.uint8).reshape(16, 3)
    idx = (np.asarray(pal_img)[:21, :19] % 16).astype(np.uint8)
    out["adam7_pal4_trns.png"] = ts.png_file(idx, 4, 3, plte=pal, trns=bytes(range(0, 160, 10)),
                                             interlace=True)
    out["adam7_graya8.png"] = ts.png_file(np.stack([g, 255 - g], -1), 8, 4, interlace=True)
    return out


def main() -> int:
    import cv2

    check = "--check" in sys.argv[1:]
    bad = 0
    for folder, record, files in ((JPEG_DIR, JPEG_RECORD, jpeg_files()),
                                  (PNG_DIR, PNG_RECORD, png_files())):
        rec = {}
        os.makedirs(folder, exist_ok=True)
        for name, data in sorted(files.items()):
            path = os.path.join(folder, name)
            if check:
                with open(path, "rb") as f:
                    data = f.read()
            else:
                with open(path, "wb") as f:
                    f.write(data)
            ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
            rec[name] = digest(ref)
        if check:
            with open(record) as f:
                old = json.load(f)
            for name, d in rec.items():
                if old.get(name) != d:
                    print(f"{name}: cv2's decode {d} does not match the record {old.get(name)}")
                    bad += 1
        else:
            with open(record, "w") as f:
                json.dump(rec, f, indent=1, sort_keys=True)
                f.write("\n")
        size = sum(os.path.getsize(os.path.join(folder, n)) for n in files)
        print(f"{folder}: {len(files)} files, {size} bytes")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's JPEG decoder (textslam_tpu_torch/io/jpeg.py, the host routine
csrc/jpeg_decode.cpp) and PNG variants (io/png.py) against OpenCV on the
CPU: every committed fixture (tests/jpeg/, tests/png/, written by
tests/jpeg_fixtures.py) decodes byte-equal to cv2.imdecode(IMREAD_UNCHANGED)
and to the recorded digest that chip_smoke.py holds the card's decode to;
tests/torch_synth.encode_jpeg's files in each mode decode byte-equal to
cv2's decode; the plain version (jpeg.decode_plain, Python and numpy)
equals the routine on the small files; each unsupported or corrupt file
raises ValueError naming the file, in both; the reader picks its decoder by
the file's signature; a broken compiler raises."""

import io
import json
import os
import struct

import cv2
import numpy as np
import pytest

from textslam_tpu_torch.io import dataset as tds
from textslam_tpu_torch.io import jpeg, png

import jpeg_fixtures
import torch_synth

HERE = os.path.dirname(os.path.abspath(__file__))
with open(jpeg_fixtures.JPEG_RECORD) as _f:
    JPEG_RECORD = json.load(_f)
with open(jpeg_fixtures.PNG_RECORD) as _f:
    PNG_RECORD = json.load(_f)
PLAIN_MAX_BYTES = 8000  # the plain decoder decodes bit by bit in Python: small files only


def _read(folder, name):
    with open(os.path.join(folder, name), "rb") as f:
        return f.read()


def _cv2(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(JPEG_RECORD))
def test_jpeg_fixture_equals_cv2(name):
    data = _read(jpeg_fixtures.JPEG_DIR, name)
    got = jpeg.decode(data, name)
    _same(got, _cv2(data))
    assert jpeg_fixtures.digest(got) == JPEG_RECORD[name]


@pytest.mark.parametrize("name", sorted(PNG_RECORD))
def test_png_fixture_equals_cv2(name):
    data = _read(jpeg_fixtures.PNG_DIR, name)
    got = png.decode(data, name)
    _same(got, _cv2(data))
    assert jpeg_fixtures.digest(got) == PNG_RECORD[name]


def test_fixtures_cover_the_formats():
    """The committed set holds each mode the reader claims: progressive and
    restart markers, 16-bit tables, 4:4:0, odd sizes, palette, sub-byte and
    interlaced PNG."""
    def markers(data):
        pos, out = 2, []
        while pos + 4 <= len(data) and data[pos] == 0xFF and data[pos + 1] != 0xDA:
            out.append((data[pos + 1], data[pos + 4]))
            pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        return out

    assert (0xC2, 8) in markers(_read(jpeg_fixtures.JPEG_DIR, "prog420_q90.jpg"))
    qt16 = markers(_read(jpeg_fixtures.JPEG_DIR, "qt16_420.jpg"))
    assert (0xC1, 8) in qt16 and any(m == 0xDB and b >> 4 == 1 for m, b in qt16)
    assert (0xDD, 0) in markers(_read(jpeg_fixtures.JPEG_DIR, "rst420_q90.jpg"))
    assert b"\xff\xd0" in _read(jpeg_fixtures.JPEG_DIR, "prog_rst_q85.jpg")
    assert JPEG_RECORD["odd641x479_420_q90.jpg"]["shape"] == [479, 641, 3]
    for name, (depth, ctype, interlace) in {"pal2.png": (2, 3, 0), "gray4.png": (4, 0, 0),
                                            "adam7_pal4_trns.png": (4, 3, 1),
                                            "adam7_rgba16.png": (16, 6, 1)}.items():
        ihdr = struct.unpack(">IIBBBBB", _read(jpeg_fixtures.PNG_DIR, name)[16:29])
        assert (ihdr[2], ihdr[3], ihdr[6]) == (depth, ctype, interlace), name


def test_exif_orientation_not_applied():
    data = _read(jpeg_fixtures.JPEG_DIR, "exif_orient6.jpg")
    assert _cv2(data).shape == (48, 64, 3)  # IMREAD_COLOR would rotate it
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR).shape == (64, 48, 3)
    assert jpeg.decode(data).shape == (48, 64, 3)


@pytest.fixture(scope="module")
def frame():
    frames, _, _, _ = torch_synth.render_text_sequence(1, seed=0, K_mat=np.diag(
        [0.25, 0.25, 1.0]) @ torch_synth.K, size=(160, 120))
    g = frames[0].clip(0, 255).astype(np.uint8)
    return g, np.stack([g, 255 - g, (g // 2 + 60).astype(np.uint8)], -1)


ENCODE_MODES = {
    "gray": dict(), "420": dict(sampling="420"), "444": dict(sampling="444"),
    "420_q50_rst4": dict(quality=50, restart=4), "444_q95_rst1": dict(quality=95, sampling="444",
                                                                      restart=1),
    "qt16": dict(quality=3, baseline=False),
}
# mean absolute error of the decode against the encoded image: a sanity bar
# of the encoder (4:2:0 loses the test image's sharp chroma edges)
ENCODE_ERR = {"420": 8, "420_q50_rst4": 8, "qt16": 12}


@pytest.mark.parametrize("mode", sorted(ENCODE_MODES))
def test_encode_jpeg_decodes_equal_to_cv2(frame, mode):
    kw = ENCODE_MODES[mode]
    img = frame[0] if mode in ("gray", "qt16") else frame[1]
    data = torch_synth.encode_jpeg(img, **kw)
    want = _cv2(data)
    _same(jpeg.decode(data), want)
    assert np.abs(want.astype(np.int64) - img).mean() < ENCODE_ERR.get(mode, 4)
    if not kw.get("baseline", True):
        assert data[data.index(b"\xff\xdb") + 4] >> 4 == 1  # a 16-bit table


SMALL = sorted(n for n in JPEG_RECORD
               if os.path.getsize(os.path.join(jpeg_fixtures.JPEG_DIR, n)) <= PLAIN_MAX_BYTES)


@pytest.mark.parametrize("name", SMALL)
def test_plain_equals_routine(name):
    data = _read(jpeg_fixtures.JPEG_DIR, name)
    _same(jpeg.decode_plain(data, name), jpeg.decode(data, name))


def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def _cmyk() -> bytes:
    from PIL import Image

    b = io.BytesIO()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(b, "JPEG")
    return b.getvalue()


def _unrefined() -> bytes:
    """A progressive file cut after its first scans and closed with EOI."""
    data = _read(jpeg_fixtures.JPEG_DIR, "prog_gray_q90.jpg")
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[:sos[2]] + b"\xff\xd9"


def _bad_cases():
    base = _read(jpeg_fixtures.JPEG_DIR, "base420_q95.jpg")
    gray = _read(jpeg_fixtures.JPEG_DIR, "gray_q75.jpg")
    sof = base.index(b"\xff\xc0")
    sos = base.index(b"\xff\xda")
    ok, s411 = cv2.imencode(".jpg", np.zeros((16, 32, 3), np.uint8), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    return {
        "arithmetic": (_patched(base, b"\xff\xc0", b"\xff\xc9"), "arithmetic"),
        "12-bit": (base[:sof + 4] + b"\x0c" + base[sof + 5:], "12-bit precision"),
        "lossless": (_patched(base, b"\xff\xc0", b"\xff\xc3"), "lossless"),
        "hierarchical": (_patched(base, b"\xff\xc0", b"\xff\xc5"), "hierarchical"),
        "cmyk": (_cmyk(), "4 components"),
        "411": (s411.tobytes(), "sampling factors"),
        "truncated": (base[:len(base) // 2], "truncated"),
        "marker in data": (base[:sos + 40] + b"\xff\xd9" + base[sos + 42:], "corrupt|truncated"),
        "no SOF": (gray[:gray.index(b"\xff\xc0")] + b"\xff\xd9", "no SOF"),
        "unrefined": (_unrefined(), "unrefined"),
        "not a JPEG": (b"GIF89a" + bytes(20), "not a JPEG"),
    }


BAD = ("arithmetic", "12-bit", "lossless", "hierarchical", "cmyk", "411", "truncated",
       "marker in data", "no SOF", "unrefined", "not a JPEG")


@pytest.mark.parametrize("case", BAD)
@pytest.mark.parametrize("decoder", ["routine", "plain"])
def test_unsupported_or_corrupt_raises(case, decoder):
    data, what = _bad_cases()[case]
    fn = jpeg.decode if decoder == "routine" else jpeg.decode_plain
    with pytest.raises(ValueError, match=f"bad_{case}.jpg: .*({what})"):
        fn(data, f"bad_{case}.jpg")


def test_reader_dispatches_on_the_signature(tmp_path):
    """A JPEG named .png decodes as JPEG, a PNG named .jpg as PNG; any other
    signature raises."""
    jp = _read(jpeg_fixtures.JPEG_DIR, "gray_q75.jpg")
    pn = _read(jpeg_fixtures.PNG_DIR, "gray4.png")
    _same(tds.decode_image(jp, "x.png"), _cv2(jp))
    _same(tds.decode_image(pn, "x.jpg"), _cv2(pn))
    with pytest.raises(ValueError, match="y.jpg: not a PNG or JPEG file"):
        tds.decode_image(b"BM" + bytes(40), "y.jpg")


def test_broken_compiler_raises(tmp_path, monkeypatch):
    """No fallback: a build that fails raises (the decoder's library is not
    found and the compiler fails)."""
    from textslam_tpu_torch.ops import cuda_lib

    fake = tmp_path / "broken-c++"
    fake.write_text("#!/bin/sh\necho 'broken compiler' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_lib, "_LIBS", {})
    with pytest.raises(RuntimeError, match="broken compiler"):
        jpeg.decode(_read(jpeg_fixtures.JPEG_DIR, "gray_q75.jpg"))


def _rgb_coded(adobe: bool) -> bytes:
    """base444_q95.jpg stored as RGB: its JFIF segment dropped, and either
    an Adobe segment with transform 0 or component ids 'R', 'G', 'B'."""
    data = _read(jpeg_fixtures.JPEG_DIR, "base444_q95.jpg")
    app0 = data.index(b"\xff\xe0")
    data = data[:app0] + data[app0 + 2 + struct.unpack(">H", data[app0 + 2:app0 + 4])[0]:]
    if adobe:
        body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
        return data[:2] + b"\xff\xee" + struct.pack(">H", len(body) + 2) + body + data[2:]
    out = bytearray(data)
    sof, sos = data.index(b"\xff\xc0"), data.index(b"\xff\xda")
    for i, rgb in enumerate(b"RGB"):
        out[sof + 10 + 3 * i] = rgb  # the SOF's component ids
        out[sos + 5 + 2 * i] = rgb  # and the scan's
    return bytes(out)


@pytest.mark.parametrize("how", ["adobe", "ids"])
def test_rgb_coded_jpeg_equals_cv2(how):
    """A file that libjpeg takes as RGB (no JFIF; Adobe transform 0, or
    component ids R, G, B) is not color-converted, as cv2 does not."""
    data = _rgb_coded(how == "adobe")
    want = _cv2(data)
    _same(jpeg.decode(data), want)
    _same(jpeg.decode_plain(data), want)
    ycc = _read(jpeg_fixtures.JPEG_DIR, "base444_q95.jpg")
    assert not np.array_equal(want, _cv2(ycc))


@pytest.mark.parametrize("decoder", ["routine", "plain"])
def test_bad_huffman_table_raises(decoder):
    """A DHT segment with more codes of one length than the length allows
    (three 1-bit codes) is refused before any code is built."""
    data = _read(jpeg_fixtures.JPEG_DIR, "gray_q75.jpg")
    dht = data.index(b"\xff\xc4")
    counts = bytes([3] + [0] * 15)
    body = bytes([0]) + counts + bytes([0, 1, 2])
    bad = data[:dht] + b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body + data[dht:]
    fn = jpeg.decode if decoder == "routine" else jpeg.decode_plain
    with pytest.raises(ValueError, match="x.jpg: bad Huffman table"):
        fn(bad, "x.jpg")

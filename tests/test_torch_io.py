"""The port's dataset path against OpenCV and the JAX package on the CPU:
the experiment-yaml parser (textslam_tpu_torch.config.load_yaml, no cv2)
against cv2.FileStorage and the JAX load_yaml; the PNG decoder (io/png.py)
exactly equal to cv2.imdecode(IMREAD_UNCHANGED) on every format (palette,
1/2/4-bit, tRNS, 16-bit, Adam7-interlaced) and on each of the five row
filters; a JPEG dataset (io/jpeg.py) through both readers; the gray conversion exactly equal to
cv2.cvtColor, and color frames through both readers equal; the undistorted
frames of io.dataset.Dataset within 1e-3 of the JAX Dataset's (cv2.remap)
on a distorted disk dataset; and the text-file readers and the TUM writer
against the JAX package's (tests/test_io.py's cases)."""

import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from textslam_tpu import config as jcfg
from textslam_tpu.io import dataset as jds
from textslam_tpu.io import trajectory as jtraj
from textslam_tpu_torch import config as tcfg
from textslam_tpu_torch.io import dataset as tds
from textslam_tpu_torch.io import png
from textslam_tpu_torch.io import trajectory as ttraj

import torch_synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNDISTORT_ATOL = 1e-3  # gray levels in [0, 255]
DIST = (-0.05, 0.01, 0.0, 0.0, 0.0)  # tests/test_cli_e2e.py's camera
K_HALF = np.diag([0.5, 0.5, 1.0]) @ torch_synth.K
SMALL = (320, 240)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """3 distorted 320x240 frames in the reference layout."""
    root = str(tmp_path_factory.mktemp("io_seq"))
    gt, world, written = torch_synth.write_dataset(root, 3, dist=DIST, K_mat=K_HALF, size=SMALL,
                                                   n_short=2)
    return root, written


def _yamls(root):
    import test_cli_e2e

    e2e = os.path.join(root, "cli_e2e.yaml")
    test_cli_e2e.write_yaml(e2e, 2, root, "Imshort", no_text=1)
    extra = os.path.join(root, "extra.yaml")
    with open(extra, "w") as f:
        f.write("%YAML:1.0\n# bare strings, a .txt list name, floats in e-notation\n"
                "Exp name: 3\nExp noText: 1\nExp read path: /data/seq one/\n"
                "Exp read list: 'list.txt'  # trailing comment\nCamera.fx: 4.2e2\n"
                "Camera.fy: 420\nCamera.cx: 3.2e+02\nCamera.cy: 240.\nCamera.k1: -1e-3\n"
                "Camera.fps: 30\nCamera.RGB: 1\n")
    return sorted(glob.glob(os.path.join(ROOT, "yaml", "*.yaml"))) + [
        os.path.join(root, n) for n in ("exp0.yaml", "exp2.yaml", "nt_short.yaml")] + [e2e, extra]


def test_load_yaml_matches_cv2_and_jax(disk):
    root, _ = disk
    paths = _yamls(root)
    assert len(paths) == 9
    for path in paths:
        tc, jc = tcfg.load_yaml(path), jcfg.load_yaml(path)
        assert vars(tc.camera) == vars(jc.camera), path
        assert (int(tc.experiment), tc.no_text, tc.read_path, tc.read_list) == \
            (int(jc.experiment), jc.no_text, jc.read_path, jc.read_list), path
        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
        try:
            parsed = tcfg._parse_filestorage(path)
            for key, val in parsed.items():
                node = fs.getNode(key)
                assert not node.empty(), (path, key)
                got = node.string() if isinstance(val, str) else node.real()
                assert got == val, (path, key, got, val)
        finally:
            fs.release()


def test_load_yaml_rejects_what_it_cannot_read(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("%YAML:1.0\nCamera:\n  fx: 1\n")
    with pytest.raises(ValueError, match="bad.yaml:2"):
        tcfg.load_yaml(str(bad))
    bad.write_text("%YAML:1.0\nCamera.fx: abc\n")
    with pytest.raises(ValueError, match="Camera.fx"):
        tcfg.load_yaml(str(bad))
    with pytest.raises(FileNotFoundError):
        tcfg.load_yaml(str(tmp_path / "missing.yaml"))


_RNG = np.random.default_rng(0)
IMAGES = {
    "gray": _RNG.integers(0, 256, (23, 37), dtype=np.uint8),
    "bgr": _RNG.integers(0, 256, (23, 37, 3), dtype=np.uint8),
    "bgra": _RNG.integers(0, 256, (23, 37, 4), dtype=np.uint8),
    "gray16": _RNG.integers(0, 65536, (23, 37), dtype=np.uint16),
    "bgr16": _RNG.integers(0, 65536, (23, 37, 3), dtype=np.uint16),
    "gray_alpha": _RNG.integers(0, 256, (23, 37, 2), dtype=np.uint8),
}


@pytest.mark.parametrize("kind", sorted(IMAGES))
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_decode_equals_cv2(kind, filters):
    img = IMAGES[kind]
    color = "raw" if kind == "gray_alpha" else "bgr"
    for chunks in (1, 3):  # one IDAT and the data split over three
        data = torch_synth.encode_png(img, filters, idat_chunks=chunks, color=color)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        got = png.decode(data)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "gray16", "bgr16"])
def test_png_decode_of_cv2_files(kind):
    ok, buf = cv2.imencode(".png", IMAGES[kind])
    assert ok
    np.testing.assert_array_equal(png.decode(buf.tobytes()),
                                  cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(body, zlib.crc32(kind)))


def test_png_rejects_unsupported_and_corrupt_files():
    def header(depth, ctype, interlace):
        return png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, ctype, 0, 0,
                                                           interlace))

    for data, what in ((header(8, 3, 0), "palette file without a valid PLTE"),
                       (header(8, 0, 2), "corrupt IHDR chunk .*interlace 2"),
                       (header(4, 2, 0), "corrupt IHDR chunk .*bit depth 4"),
                       (header(16, 3, 0), "corrupt IHDR chunk .*bit depth 16"),
                       (b"\xff\xd8\xff\xe0", "not a PNG")):
        with pytest.raises(ValueError, match=what):
            png.decode(data + _chunk(b"IEND", b""), "x.png")
    good = bytearray(torch_synth.encode_png(IMAGES["gray"]))
    good[-20] ^= 1  # inside the IDAT chunk
    with pytest.raises(ValueError, match="x.png: CRC mismatch"):
        png.decode(bytes(good), "x.png")
    idx = np.full((4, 4), 3, np.uint8)  # a palette index past a 2-entry PLTE
    with pytest.raises(ValueError, match="x.png: palette index past"):
        png.decode(torch_synth.png_file(idx, 8, 3, plte=np.zeros((2, 3))), "x.png")
    short = torch_synth.png_file(IMAGES["gray"][:8], 8, 0, interlace=True)
    tall = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 37, 23, 8, 0, 0, 0, 1))
    with pytest.raises(ValueError, match="x.png: (image data too short|unknown PNG filter)"):
        png.decode(tall + short[8 + 25:], "x.png")  # the IHDR says 23 rows, the data holds 8


# the PNG variants: (samples, bit depth, color type, PLTE, tRNS) per kind
_PAL = _RNG.integers(0, 256, (11, 3))
VARIANTS = {
    "gray1": (_RNG.integers(0, 2, (23, 37)), 1, 0, None, None),
    "gray2": (_RNG.integers(0, 4, (23, 37)), 2, 0, None, None),
    "gray4_trns": (_RNG.integers(0, 16, (23, 37)), 4, 0, None, b"\x00\x03"),
    "pal1": (_RNG.integers(0, 2, (23, 37)), 1, 3, _PAL[:2], None),
    "pal2_trns": (_RNG.integers(0, 4, (23, 37)), 2, 3, _PAL[:4], b"\x00\x80"),
    "pal4": (_RNG.integers(0, 11, (23, 37)), 4, 3, _PAL, None),
    "pal8_trns": (_RNG.integers(0, 11, (23, 37)), 8, 3, _PAL, bytes(range(0, 250, 25))),
    "rgb8_trns": (_RNG.integers(0, 2, (23, 37, 3)) * 200, 8, 2, None,
                  b"\x00\xc8\x00\x00\x00\xc8"),
    "rgb16_trns": (_RNG.integers(0, 2, (23, 37, 3)) * 700, 16, 2, None,
                   b"\x02\xbc\x00\x00\x00\x00"),
    "rgba16": (_RNG.integers(0, 65536, (23, 37, 4)), 16, 6, None, None),
    "gray_alpha16": (_RNG.integers(0, 65536, (23, 37, 2)), 16, 4, None, None),
}


@pytest.mark.parametrize("interlace", [False, True], ids=["straight", "adam7"])
@pytest.mark.parametrize("kind", sorted(VARIANTS))
def test_png_variants_equal_cv2(kind, interlace):
    """Palette, sub-byte, tRNS and 16-bit files, plain and Adam7-interlaced,
    in every row filter: equal to cv2.imdecode(IMREAD_UNCHANGED)."""
    samples, depth, ctype, plte, trns = VARIANTS[kind]
    samples = samples.astype(np.uint16 if depth == 16 else np.uint8)
    for filters in ((0,), (4, 3, 2, 1, 0)):
        data = torch_synth.png_file(samples, depth, ctype, filters, idat_chunks=2,
                                    interlace=interlace, plte=plte, trns=trns)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        got = png.decode(data)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("kind", ["bgr", "bgra", "bgr16"])
def test_gray_equals_cv2(kind, rgb):
    img = np.concatenate([IMAGES[kind], IMAGES[kind][::-1]], 0)
    want = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY if rgb else cv2.COLOR_BGR2GRAY)
    got = tds.to_gray(torch.from_numpy(img.astype(np.int32)), rgb).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_dataset_matches_jax(disk):
    """Frames decoded exactly, undistorted within UNDISTORT_ATOL of the JAX
    Dataset (cv2.remap), the undistortion map equal to cv2's, detections
    equal to the JAX reader's (3 frames, so no probe lines)."""
    root, written = disk
    yml = os.path.join(root, "exp0.yaml")
    tc, jc = tcfg.load_yaml(yml), jcfg.load_yaml(yml)
    mx, my = tds.undistort_map(tc.camera)
    m1, m2 = cv2.initUndistortRectifyMap(jc.camera.K, jc.camera.dist, None, jc.camera.K,
                                         SMALL, cv2.CV_32FC1)
    assert np.abs(mx - m1).max() < 1e-4 and np.abs(my - m2).max() < 1e-4
    jd = jds.Dataset(jc)
    with tds.Dataset(tc, device="cpu") as td:
        assert len(td) == len(jd) == 3
        for i in range(3):
            timg, tts, tdets = td[i]
            jimg, jts, jdets = jd[i]
            assert isinstance(timg, torch.Tensor) and timg.dtype == torch.float32
            assert tts == jts
            err = np.abs(timg.numpy() - jimg).max()
            assert err < UNDISTORT_ATOL, f"frame {i}: {err}"
            assert [(d.text, d.score, d.lang) for d in tdets] == \
                [(d.text, d.score, d.lang) for d in jdets]
            for a, b in zip(tdets, jdets):
                np.testing.assert_array_equal(a.quad, b.quad)
        assert len(td.read_ms) == 3
    for i, img in enumerate(written):
        with open(os.path.join(root, "images", f"{i:04d}.png"), "rb") as f:
            np.testing.assert_array_equal(png.decode(f.read()), img)


@pytest.mark.parametrize("rgb", [0, 1])
def test_color_dataset_equals_jax(tmp_path, rgb):
    """Color frames (BGR and BGRA PNG, 8 and 16 bits) through both readers,
    undistortion off: the gray images are equal exactly, for `Camera.RGB`
    0 and 1."""
    rng = np.random.default_rng(rgb)
    frames = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8),
              rng.integers(0, 256, (24, 32, 4), dtype=np.uint8),
              rng.integers(0, 65536, (24, 32, 3), dtype=np.uint16)]
    os.makedirs(tmp_path / "images")
    with open(tmp_path / "Imlist.txt", "w") as f:
        for i, img in enumerate(frames):
            (tmp_path / "images" / f"{i}.png").write_bytes(torch_synth.encode_png(img))
            f.write(f"{i}.0 images/{i}.png\n")
    yml = str(tmp_path / "c.yaml")
    torch_synth.write_yaml(yml, 0, str(tmp_path), "Imlist", size=(32, 24), no_text=1)
    with open(yml) as f:
        text = f.read().replace("Camera.RGB: 0", f"Camera.RGB: {rgb}")
    with open(yml, "w") as f:
        f.write(text)
    tc, jc = tcfg.load_yaml(yml), jcfg.load_yaml(yml)
    assert tc.camera.rgb == jc.camera.rgb == bool(rgb)
    jd = jds.Dataset(jc)
    with tds.Dataset(tc, device="cpu") as td:
        for i in range(len(frames)):
            np.testing.assert_array_equal(td[i][0].numpy(), jd[i][0])


def test_dataset_cuda_without_gpu_raises(disk, jpeg_disk):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    for root in (disk[0], jpeg_disk[0]):
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            tds.Dataset(tcfg.load_yaml(os.path.join(root, "exp0.yaml")), device="cuda")


@pytest.fixture(scope="module")
def jpeg_disk(tmp_path_factory):
    """The disk fixture's 3 frames in color as baseline 4:2:0 JPEG
    (torch_synth.tint_bgr, encode_jpeg)."""
    root = str(tmp_path_factory.mktemp("io_seq_jpg"))
    gt, world, written = torch_synth.write_dataset(root, 3, dist=DIST, K_mat=K_HALF, size=SMALL,
                                                   n_short=2, fmt="jpg")
    return root, written


def test_jpeg_dataset_matches_jax(jpeg_disk):
    """A JPEG set through both readers (the JAX reader decodes with cv2):
    samples equal to cv2's decode, undistorted frames within UNDISTORT_ATOL,
    detections equal."""
    from textslam_tpu_torch.io import jpeg

    root, written = jpeg_disk
    yml = os.path.join(root, "exp0.yaml")
    tc, jc = tcfg.load_yaml(yml), jcfg.load_yaml(yml)
    jd = jds.Dataset(jc)
    with tds.Dataset(tc, device="cpu") as td:
        assert len(td) == len(jd) == 3
        for i in range(3):
            samples, ts, dets = td.read(i)
            with open(os.path.join(root, "images", f"{i:04d}.jpg"), "rb") as f:
                data = f.read()
            np.testing.assert_array_equal(samples, cv2.imdecode(np.frombuffer(data, np.uint8),
                                                                cv2.IMREAD_UNCHANGED))
            np.testing.assert_array_equal(samples, jpeg.decode(data))
            jimg, jts, jdets = jd[i]
            assert ts == jts
            err = np.abs(td.image(samples).numpy() - jimg).max()
            assert err < UNDISTORT_ATOL, f"frame {i}: {err}"
            _same(dets, jdets)
            assert np.abs(samples.astype(np.int64) - written[i]).mean() < 3.0


# tests/test_io.py's cases, each read by both packages


def _same(tdets, jdets):
    assert [(d.text, d.score, d.lang) for d in tdets] == [(d.text, d.score, d.lang)
                                                          for d in jdets]
    for a, b in zip(tdets, jdets):
        np.testing.assert_array_equal(a.quad, b.quad)


def test_image_list(tmp_path):
    p = tmp_path / "Imlist.txt"
    p.write_text("# comment\n0.033 images/0.png\n0.066 images/1.png\n\nbad\n")
    assert tds.read_image_list(str(p)) == jds.read_image_list(str(p)) == [
        (0.033, "images/0.png"), (0.066, "images/1.png")]


def test_detections(tmp_path):
    (tmp_path / "3_dete.txt").write_text("10,20,110,20,110,60,10,60\n5.4,5,50,5,50,25.6,5,25\n")
    (tmp_path / "3_mean.txt").write_text("CAFE,0.93\n你好,0.8\n")
    dets = tds.read_detections(str(tmp_path), 3)
    _same(dets, jds.read_detections(str(tmp_path), 3))
    assert [(d.text, d.lang) for d in dets] == [("CAFE", 0), ("你好", 1)]
    np.testing.assert_array_equal(dets[1].quad[2], [50, 26])


def test_missing_files_empty(tmp_path):
    assert tds.read_detections(str(tmp_path), 7) == jds.read_detections(str(tmp_path), 7) == []


def test_text_dir_mapping():
    for path in ("/data/seq1/images", "/images/a/images/0", "/data/none"):
        assert tds.text_dir_for(path) == jds.text_dir_for(path)
    assert tds.text_stem_for("/d/s/", "images/0012.png") == \
        jds.text_stem_for("/d/s/", "images/0012.png") == "/d/s/text/0012"
    for s in ("", "CAFE", "你好", "Café", "#"):
        assert tds.classify_language(s) == jds.classify_language(s)


def test_string_with_comma(tmp_path):
    (tmp_path / "0_dete.txt").write_text("0,0,1,0,1,1,0,1\n0,0,2,0,2,2,0,2\n")
    (tmp_path / "0_mean.txt").write_text("A,B,0.5\nno score\n")
    dets = tds.read_detections(str(tmp_path), 0)
    _same(dets, jds.read_detections(str(tmp_path), 0))
    assert (dets[0].text, dets[0].score) == ("A,B", 0.5)


def test_trajectory_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    poses = np.concatenate([q, rng.normal(size=(5, 3))], -1).astype(np.float32)
    ts = np.arange(5) * 0.1
    tp, jp = tmp_path / "t.txt", tmp_path / "j.txt"
    ttraj.write_tum(str(tp), ts, poses)
    jtraj.write_tum(str(jp), ts, poses)
    assert tp.read_text() == jp.read_text()
    (ts_t, tw), (ts_j, jw) = ttraj.read_tum(str(tp)), jtraj.read_tum(str(tp))
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_allclose(tw, jw, atol=1e-7)

"""TextSLAM dataset reader: image lists, PNG and JPEG frames and precomputed
OCR files.
Port of textslam_tpu/io/dataset.py without OpenCV.

Reference layout contract (src/tool.cc:21-215, main.cpp:46-84):
- `<read path>/<read list>`: lines "timestamp filename"
- text files live next to images with "images" -> "text" in the path:
  `<idx>_dete.txt`  — one detection per line, 8 comma-separated corner
                      coordinates (u1,v1,...,u4,v4)
  `<idx>_mean.txt`  — per line "string,score"; language classified from
                      UTF-8 byte lengths (src/tool.cc:163-215)
- images are undistorted up front with the camera model (cv::undistort,
  main.cpp:73); everything downstream is pure pinhole.

Where the work runs: a read-ahead thread reads each frame's file, decodes
it by its signature (PNG: io/png.py; JPEG: io/jpeg.py) and reads its
detections on the host; the gray
conversion and the undistortion remap run on `device`, so a frame goes to
the card as its raw 8- or 16-bit samples and comes back as the float32
[H, W] tensor the tracker takes. Both reproduce OpenCV's results: the gray
weights are cv2.cvtColor's fixed-point ones, the remap map is
cv2.initUndistortRectifyMap's model in float64 stored as float32, sampled
bilinearly with a zero border (cv2.remap, INTER_LINEAR).
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from typing import List, Tuple

import numpy as np
import torch

from ..config import CameraConfig, TextSLAMConfig
from ..frontend.frame import TextDetection, check_device
from . import jpeg, png

# cv2.cvtColor's BGR2GRAY fixed point: (R*9798 + G*19235 + B*3735 + 2^14) >> 15
GRAY_WEIGHTS = (9798, 19235, 3735)
LOOKAHEAD = 8  # frames the read-ahead thread decodes past the one asked for


def decode_image(data: bytes, name: str) -> np.ndarray:
    """A frame file's samples, as cv2.imdecode(IMREAD_UNCHANGED) gives them,
    by the decoder its signature names (PNG or JPEG; not its extension).
    Raises ValueError for any other file."""
    if data.startswith(png.SIGNATURE):
        return png.decode(data, name)
    if data.startswith(jpeg.SIGNATURE):
        return jpeg.decode(data, name)
    raise ValueError(f"{name}: not a PNG or JPEG file (signature {data[:4]!r})")


def classify_language(s: str) -> int:
    """Language id from UTF-8 byte lengths (src/tool.cc:163-172):
    0 = english (every char 1 byte), 1 = Chinese (every char 3 bytes),
    2 = mixed (anything in between)."""
    if not s:
        return 0
    n_chars = len(s)
    n_bytes = len(s.encode("utf-8"))
    if n_bytes == n_chars:
        return 0
    if n_bytes == 3 * n_chars:
        return 1
    return 2


def read_image_list(path: str) -> List[Tuple[float, str]]:
    """Parse `Imlist.txt`-style "timestamp filename" lines."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            out.append((float(parts[0]), parts[1]))
    return out


def text_dir_for(image_path: str) -> str:
    """The reference derives the text path by replacing the FIRST "images"
    with "text" in the full image path
    (src/tool.cc:59: path.replace(Path.find("images"), 6, "text"))."""
    return image_path.replace("images", "text", 1)


def text_stem_for(read_path: str, image_name: str) -> str:
    """Per-frame text-file stem: `<read_path>/<image name minus extension>`
    with the first "images" replaced by "text" — the reference indexes text
    files by the IMAGE FILENAME STEM, not the loop counter
    (src/tool.cc:45-46 sRGB.erase(length-4) builds vImg_Idx; main.cpp:60
    ReadText(sReadPath + vImg_Idx[ni]))."""
    stem = image_name[:-4] if len(image_name) > 4 else image_name
    return text_dir_for(os.path.join(read_path, stem))


def read_detections(text_dir: str, idx=None) -> List[TextDetection]:
    """Read `<stem>_dete.txt` + `<stem>_mean.txt` for one frame.

    `text_dir` is the stem path itself when `idx` is None, else the
    directory holding `<idx>_*.txt`. Corner coordinates are rounded to
    integers like the reference (src/tool.cc:92 std::round, DOUBLE=false).
    Deviation (documented): a comma INSIDE the recognized string is kept
    (score = last comma field); the reference's char-walk parser misaligns
    all subsequent lines of the file on such input (src/tool.cc:154-199)."""
    stem = text_dir if idx is None else os.path.join(text_dir, str(idx))
    dete = f"{stem}_dete.txt"
    mean = f"{stem}_mean.txt"
    quads, infos = [], []
    if os.path.exists(dete):
        with open(dete) as f:
            for line in f:
                vals = [v for v in line.strip().replace(",", " ").split() if v]
                if len(vals) >= 8:
                    q = np.round(np.asarray(
                        [float(v) for v in vals[:8]], np.float32)).reshape(4, 2)
                    quads.append(q)
    if os.path.exists(mean):
        with open(mean, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                # "string,score" — string may itself contain commas; score is
                # the last comma-separated field
                head, _, tail = line.rpartition(",")
                try:
                    score = float(tail)
                    string = head
                except ValueError:
                    string, score = line, 0.0
                infos.append((string, score))
    dets = []
    for i, q in enumerate(quads):
        string, score = infos[i] if i < len(infos) else ("", 0.0)
        dets.append(
            TextDetection(quad=q, text=string, score=score, lang=classify_language(string))
        )
    return dets


def to_gray(img: torch.Tensor, rgb: bool) -> torch.Tensor:
    """cv2.cvtColor(img, COLOR_BGR2GRAY) of a [H, W, 3|4] BGR(A) tensor of
    8- or 16-bit samples (any integer dtype), exactly, as int64; rgb=True
    reproduces COLOR_RGB2GRAY on the same buffer (the reference's
    `Camera.RGB: 1` applies it to OpenCV's BGR image, so the R and B
    weights swap)."""
    wr, wg, wb = GRAY_WEIGHTS
    w0, w2 = (wr, wb) if rgb else (wb, wr)
    x = img[..., :3].to(torch.int64)
    return (x[..., 0] * w0 + x[..., 1] * wg + x[..., 2] * w2 + (1 << 14)) >> 15


def undistort_map(cam: CameraConfig) -> Tuple[np.ndarray, np.ndarray]:
    """cv2.initUndistortRectifyMap(K, dist, None, K, (W, H), CV_32FC1):
    for every pixel of the undistorted image, the distorted image position
    it samples (k1, k2, p1, p2, k3 model in float64), as float32 maps."""
    u, v = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                       np.arange(cam.height, dtype=np.float64))
    x, y = (u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy
    r2 = x * x + y * y
    kr = 1 + ((cam.k3 * r2 + cam.k2) * r2 + cam.k1) * r2
    xd = x * kr + 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
    yd = y * kr + cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
    return ((xd * cam.fx + cam.cx).astype(np.float32),
            (yd * cam.fy + cam.cy).astype(np.float32))


class Remap:
    """Bilinear resampling of [H, W] images at fixed float32 maps with a
    zero border (cv2.remap(img, map_x, map_y, INTER_LINEAR)): the four
    corner indices and weights of every output pixel are computed once on
    `device` (a corner outside the image gets weight 0), so a frame costs
    one gather and one weighted sum."""

    def __init__(self, map_x: np.ndarray, map_y: np.ndarray, src_shape, device):
        h, w = src_shape
        mx = torch.as_tensor(map_x, device=device)
        my = torch.as_tensor(map_y, device=device)
        x0, y0 = torch.floor(mx), torch.floor(my)
        fx, fy = mx - x0, my - y0
        idx, wts = [], []
        for dy, wy in ((0, 1 - fy), (1, fy)):
            for dx, wx in ((0, 1 - fx), (1, fx)):
                xx, yy = x0 + dx, y0 + dy
                inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
                idx.append((yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long().flatten())
                wts.append(torch.where(inside, wy * wx, torch.zeros_like(wx)).flatten())
        self.src_shape = (h, w)
        self.shape = tuple(map_x.shape)
        self.idx = torch.stack(idx)  # [4, H*W]
        self.wts = torch.stack(wts)  # [4, H*W] float32

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        if tuple(img.shape) != self.src_shape:
            raise ValueError(f"remap: image {tuple(img.shape)} does not match the camera's "
                             f"{self.src_shape}")
        return (img.reshape(-1)[self.idx] * self.wts).sum(0).reshape(self.shape)


class Dataset:
    """Iterates (gray undistorted float32 [H, W] image on `device`,
    timestamp, detections). Reading ahead: a thread reads and decodes up to
    LOOKAHEAD frames past the one asked for, and records each frame's host
    milliseconds of read + decode (`read_ms`). Close it (or use it as a
    context manager) to stop the thread."""

    def __init__(self, cfg: TextSLAMConfig, *, device):
        self.cfg = cfg
        self.device = check_device(device, "Dataset")
        self.entries = read_image_list(os.path.join(cfg.read_path, cfg.read_list))
        cam = cfg.camera
        self._remap = None
        if np.abs(cam.dist).sum() > 1e-12:
            self._remap = Remap(*undistort_map(cam), (cam.height, cam.width), self.device)
        self._pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="dataset-read")
        self._pending = {}
        self.read_ms: List[float] = []

    def __len__(self):
        return len(self.entries)

    def _read(self, i: int):
        """Host half of frame i: (decoded samples, detections, ms)."""
        t0 = time.perf_counter()
        ts, name = self.entries[i]
        path = os.path.join(self.cfg.read_path, name)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise FileNotFoundError(f"image not found: {name}") from None
        img = decode_image(data, path)
        dets = ([] if self.cfg.no_text
                else read_detections(text_stem_for(self.cfg.read_path, name)))
        return img, dets, (time.perf_counter() - t0) * 1e3

    def image(self, samples: np.ndarray) -> torch.Tensor:
        """Decoded samples ([H, W] or [H, W, 3|4] BGR(A), uint8 / uint16) ->
        the gray undistorted float32 [H, W] tensor on the device."""
        if samples.dtype == np.uint16:  # 16-bit samples travel as int32
            samples = samples.astype(np.int32)
        x = torch.from_numpy(np.ascontiguousarray(samples)).to(self.device)
        if x.ndim == 3:
            x = to_gray(x, self.cfg.camera.rgb)
        x = x.to(torch.float32)
        return self._remap(x) if self._remap is not None else x

    def read(self, i: int):
        """Host half of frame i from the read-ahead: (decoded samples,
        timestamp, detections)."""
        if not 0 <= i < len(self.entries):
            raise IndexError(i)
        for j in range(i, min(i + LOOKAHEAD + 1, len(self.entries))):
            if j not in self._pending:
                self._pending[j] = self._pool.submit(self._read, j)
        for j in [j for j in self._pending if j < i]:  # skipped frames
            self._pending.pop(j).cancel()
        samples, dets, read_ms = self._pending.pop(i).result()
        self.read_ms.append(read_ms)
        return samples, self.entries[i][0], dets

    def __getitem__(self, i: int):
        samples, ts, dets = self.read(i)
        return self.image(samples), ts, dets

    def close(self):
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

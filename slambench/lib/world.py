"""The traffic generator: a walk past textured walls, rendered on the card.

One general generator reads every traffic file (`traffic/<name>.json`). The
world is a copy of the ring world of the port's test renderer (wall
segments on a circle in the x-y plane, each a textured plane z = depth),
frozen here. A hand-held camera goes along the ring looking along +z,
swaying and turning about all three axes at the mean speeds the traffic
states. Frames are rendered with tensor operations on the device: textures
made on the device, each pixel's ray met with the walls' planes and the
textures sampled bilinearly, detections projected from the ground-truth
boxes with occlusion taken into account.

The run's seed draws the boxes' strings (and, in lib/check.py, the frames
whose calls are checked). The walls' textures and where the boxes sit on
them are drawn from the traffic file's `layout_seed`, like the other sizes
there (segments, boxes per segment, speed), so every seed gets the same
frames in other words. Textures drawn from the run's seed changed the work
itself: how many text objects a run keeps and when keyframes come, up to
twice the frame rate between two seeds, where two runs of one seed agree
within 2% (PERF.md).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

WORDS = ("CAFE", "EXIT", "HOTEL", "MARKET", "LIBRARY", "STATION", "PHARMACY", "BAKERY",
         "BANK", "MUSEUM", "TICKETS", "PARKING")


def seed64(seed: int) -> int:
    """The seed as a non-negative 64-bit integer (any whole number is taken)."""
    return int(seed) & 0xFFFF_FFFF_FFFF_FFFF


def ring_layout(traffic: dict, seed: int) -> dict:
    """The world's layout from the traffic parameters and the seed: walls
    (centre x, y; depth), boxes (wall, texture-pixel rectangle, string).
    Boxes sit one to a cell of a grid over the texture, so no two overlap."""
    rng = np.random.default_rng(int(traffic["layout_seed"]))
    n = int(traffic["segments"])
    spacing = float(traffic["spacing_m"])
    radius = n * spacing / (2 * math.pi)
    depths = traffic["depths_m"]
    walls = []
    for i in range(n):
        phi = 2 * math.pi * i / n
        walls.append((radius * math.sin(phi), radius * (1 - math.cos(phi)),
                      float(depths[i % len(depths)])))
    tex = int(traffic["texture_px"])
    grid = int(traffic["box_grid"])
    cell = tex // grid
    (wmin, wmax), (hmin, hmax) = traffic["box_px"]
    per = int(traffic["boxes_per_segment"])
    if per > grid * grid or wmax + 8 > cell or hmax + 8 > cell:
        raise ValueError("traffic: boxes do not fit one to a grid cell")
    words = list(WORDS)
    np.random.default_rng(seed64(seed)).shuffle(words)
    boxes = []
    for wi in range(n):
        cells = rng.permutation(grid * grid)[:per]
        for c in sorted(int(c) for c in cells):
            bw = int(rng.integers(wmin, wmax + 1))
            bh = int(rng.integers(hmin, hmax + 1))
            gx, gy = c % grid, c // grid
            bx = gx * cell + int(rng.integers(4, cell - bw - 3))
            by = gy * cell + int(rng.integers(4, cell - bh - 3))
            # unique strings: a box maps to its wall one to one
            string = f"{words[len(boxes) % len(words)]}{len(boxes)}"
            boxes.append((wi, (bx, by, bw, bh), string))
    return {"walls": walls, "boxes": boxes, "radius": radius,
            "px_per_m": float(traffic["px_per_m"]), "texture_px": tex}


def rotation(yaw: np.ndarray, pitch: np.ndarray, roll: np.ndarray) -> np.ndarray:
    """[N, 3, 3] camera-to-world rotations: yaw about the camera's y axis
    (down), pitch about its x axis, roll about its optical axis, applied in
    that order (R = Ry Rx Rz)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cx, sx = np.cos(pitch), np.sin(pitch)
    cz, sz = np.cos(roll), np.sin(roll)
    one, zero = np.ones_like(yaw), np.zeros_like(yaw)
    Ry = np.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1).reshape(-1, 3, 3)
    Rx = np.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1).reshape(-1, 3, 3)
    Rz = np.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1).reshape(-1, 3, 3)
    return Ry @ Rx @ Rz


def quaternion(R: np.ndarray) -> np.ndarray:
    """[N, 3, 3] rotation matrices -> [N, 4] unit quaternions (w x y z), w >= 0."""
    tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    w = np.sqrt(np.maximum(1.0 + tr, 1e-12)) / 2  # the path's rotations stay far from 180 deg
    q = np.stack([w, (R[:, 2, 1] - R[:, 1, 2]) / (4 * w), (R[:, 0, 2] - R[:, 2, 0]) / (4 * w),
                  (R[:, 1, 0] - R[:, 0, 1]) / (4 * w)], -1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _sway(traffic: dict, t: np.ndarray, amp: np.ndarray):
    """(yaw, pitch, roll) [N] in radians and the centre's offset [N, 3] of
    the hand-held sway at times t: one sinusoid per axis, with the traffic's
    frequencies and phases; `amp` scales the three angles."""
    hz = np.asarray(traffic["sway_hz"], np.float64)  # yaw, pitch, roll, x, y, z
    ph = np.asarray(traffic["sway_phase"], np.float64)
    ang = [amp[j] * np.sin(2 * np.pi * hz[j] * t + ph[j]) for j in range(3)]
    off = np.stack([float(traffic["bob_m"][j]) * np.sin(2 * np.pi * hz[3 + j] * t + ph[3 + j])
                    for j in range(3)], -1)
    return ang, off


def path(traffic: dict, layout: dict, fps: float, n_frames: int) -> tuple:
    """(R_wc [N, 3, 3], camera centres [N, 3]) of the hand-held walk: the
    centre goes along the ring and sways about it, the camera looks along
    +z and turns about all three axes. Amplitudes are scaled so that the
    path's mean speed and mean angular speed are the traffic's
    `speed_mps` and `mean_angular_speed_dps`."""
    n = int(n_frames)
    t = np.arange(n, dtype=np.float64) / fps
    r = layout["radius"]
    rel = np.asarray(traffic["sway_deg"], np.float64) * np.pi / 180  # relative amplitudes
    want_w = float(traffic["mean_angular_speed_dps"]) * np.pi / 180
    want_v = float(traffic["speed_mps"])
    amp, v = rel.copy(), want_v
    for _ in range(8):  # fixed point: the means are near-linear in the scales
        (yaw, pitch, roll), off = _sway(traffic, t, amp)
        R = rotation(yaw, pitch, roll)
        phi = v * t / r
        c = np.stack([r * np.sin(phi), r * (1 - np.cos(phi)), np.zeros(n)], -1) + off
        dR = np.einsum("nji,njk->nik", R[:-1], R[1:])  # R_k-1^T R_k
        cosang = np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1.0, 1.0)
        w = np.arccos(cosang).mean() * fps
        s = np.linalg.norm(np.diff(c, axis=0), axis=-1).mean() * fps
        amp, v = amp * (want_w / w if w > 0 else 0.0), v * want_v / s
    return R, c


def path_poses(R_wc: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Ground-truth Tcw [N, 7] (qw qx qy qz t) of a path (R_wc, centres)."""
    R_cw = np.transpose(R_wc, (0, 2, 1))
    poses = np.concatenate([quaternion(R_cw), -np.einsum("nij,nj->ni", R_cw, c)], -1)
    return poses.astype(np.float32)


def make_textures(n: int, size: int, blobs: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n, size, size] float32 matte textures with corners at many scales:
    rectangles of random size (3-13 px) and grey level painted over 128 in
    order, the last one on top, then a 3x3 Gaussian blur (sigma 0.8,
    reflected border). Drawn on the device in a few large calls."""
    xs = torch.randint(6, size - 6, (n, blobs), generator=gen, device=device)
    ys = torch.randint(6, size - 6, (n, blobs), generator=gen, device=device)
    ws = torch.randint(3, 14, (n, blobs), generator=gen, device=device)
    hs = torch.randint(3, 14, (n, blobs), generator=gen, device=device)
    val = torch.rand((n, blobs), generator=gen, device=device) * 255.0
    off = torch.arange(13, device=device)
    dy, dx = off[:, None, None, None], off[None, :, None, None]
    inside = (dy < hs[None, None]) & (dx < ws[None, None])  # [13, 13, n, blobs]
    yy = (ys[None, None] + dy).clamp(max=size - 1)
    xx = (xs[None, None] + dx).clamp(max=size - 1)
    t = torch.arange(n, device=device)[None, None, :, None]
    flat = ((t * size + yy) * size + xx)
    order = torch.arange(blobs, device=device).expand(13, 13, n, blobs)
    idx = torch.full((n * size * size,), -1, dtype=torch.long, device=device)
    idx.scatter_reduce_(0, flat[inside], order[inside], reduce="amax")
    idx = idx.view(n, size * size)
    painted = torch.gather(val, 1, idx.clamp(min=0))
    tex = torch.where(idx >= 0, painted, torch.full_like(painted, 128.0)).view(n, 1, size, size)
    x = torch.arange(-1, 2, dtype=torch.float64)
    k = torch.exp(-(x * x) / (2 * 0.8 * 0.8))
    k = (k / k.sum()).to(torch.float32).to(device)
    p = F.pad(tex, (1, 1, 1, 1), mode="reflect")
    rows = p[..., 1:-1] * k[1] + (p[..., :-2] + p[..., 2:]) * k[0]
    out = rows[..., 1:-1, :] * k[1] + (rows[..., :-2, :] + rows[..., 2:, :]) * k[0]
    return out[:, 0].contiguous()


class Walk:
    """The walk of one run: its layout, ground-truth path and textures, and
    the frame renderer. `frame(i)` returns (image [H, W] float32 on the
    device, detections)."""

    def __init__(self, traffic: dict, seed: int, camera: dict, n_frames: int, device,
                 detection_cls):
        self.device = torch.device(device)
        self.layout = ring_layout(traffic, seed)
        self.fx, self.fy = float(camera["fx"]), float(camera["fy"])
        self.cx, self.cy = float(camera["cx"]), float(camera["cy"])
        self.width, self.height = int(camera["width"]), int(camera["height"])
        self._R_wc, self._c = path(traffic, self.layout, float(camera["fps"]), n_frames)
        self.poses = path_poses(self._R_wc, self._c)
        self.n_frames = len(self.poses)
        self.margin = float(traffic["detection_margin_px"])
        self.score = float(traffic["detection_score"])
        self.detection_cls = detection_cls
        gen = torch.Generator(device=self.device).manual_seed(int(traffic["layout_seed"]))
        walls = self.layout["walls"]
        self.textures = make_textures(len(walls), self.layout["texture_px"],
                                      int(traffic["blobs"]), gen, self.device)
        # painter's order: far walls first, the later of two equal depths on top
        self.order = sorted(range(len(walls)), key=lambda i: -walls[i][2])
        s = self.layout["px_per_m"]
        half = self.layout["texture_px"] / (2 * s)
        self._wall = np.array([(x - half, y - half, z) for x, y, z in walls], np.float64)
        corners, wall_of = [], []
        for wi, (bx, by, bw, bh), _ in self.layout["boxes"]:
            q = np.array([[bx, by], [bx + bw, by], [bx + bw, by + bh], [bx, by + bh]],
                         np.float64) / s
            corners.append(q + self._wall[wi, :2])
            wall_of.append(wi)
        self._box_xy = np.stack(corners) if corners else np.zeros((0, 4, 2))
        self._box_wall = np.array(wall_of, np.int64)
        ys, xs = torch.meshgrid(torch.arange(self.height, device=self.device, dtype=torch.float32),
                                torch.arange(self.width, device=self.device, dtype=torch.float32),
                                indexing="ij")
        self._xs, self._ys = xs, ys

    def _to_camera(self, i: int, P: np.ndarray) -> np.ndarray:
        """World points [..., 3] in the camera of frame i, in float64."""
        return (P - self._c[i]) @ self._R_wc[i]

    def visible_walls(self, i: int) -> List[int]:
        """Walls whose texture square meets the image of frame i, in
        painter's order."""
        out = []
        side = self.layout["texture_px"] / self.layout["px_per_m"]
        sq = np.array([[0, 0], [side, 0], [side, side], [0, side]], np.float64)
        for wi in self.order:
            x0, y0, z = self._wall[wi]
            p = self._to_camera(i, np.concatenate([sq + (x0, y0), np.full((4, 1), z)], -1))
            if (p[:, 2] <= 0.05).any():
                out.append(wi)  # a corner behind the camera: let the per-pixel test decide
                continue
            u = self.fx * p[:, 0] / p[:, 2] + self.cx
            v = self.fy * p[:, 1] / p[:, 2] + self.cy
            if u.max() > 0 and u.min() < self.width and v.max() > 0 and v.min() < self.height:
                out.append(wi)
        return out

    def frame(self, i: int):
        """(image [H, W] float32 on the device, [detection]) of frame i."""
        walls = self.visible_walls(i)
        s = self.layout["px_per_m"]
        img = torch.zeros((self.height, self.width), dtype=torch.float32, device=self.device)
        wall_id = torch.full((self.height, self.width), -1, dtype=torch.int64, device=self.device)
        if walls:
            w = torch.as_tensor(walls, device=self.device)
            p = torch.as_tensor(self._wall[walls], dtype=torch.float32, device=self.device)
            R = torch.as_tensor(self._R_wc[i], dtype=torch.float32, device=self.device)
            c = [float(x) for x in self._c[i]]
            # each pixel's ray in the world, met with each wall's plane z = depth
            rx = (self._xs - self.cx) / self.fx
            ry = (self._ys - self.cy) / self.fy
            d = [R[k, 0] * rx + R[k, 1] * ry + R[k, 2] for k in range(3)]
            lam = (p[:, 2, None, None] - c[2]) / d[2][None]
            tx = (c[0] + lam * d[0][None] - p[:, 0, None, None]) * s
            ty = (c[1] + lam * d[1][None] - p[:, 1, None, None]) * s
            size = self.layout["texture_px"]
            inside = ((lam > 0) & (tx.round() >= 0) & (tx.round() < size)
                      & (ty.round() >= 0) & (ty.round() < size))
            grid = torch.stack([tx / (size - 1) * 2 - 1, ty / (size - 1) * 2 - 1], -1)
            warped = F.grid_sample(self.textures[w][:, None], grid, mode="bilinear",
                                   padding_mode="zeros", align_corners=True)[:, 0]
            for j in range(len(walls)):
                img = torch.where(inside[j], warped[j], img)
                wall_id = torch.where(inside[j], w[j], wall_id)
        return img, self.detections(i, wall_id)

    def detections(self, i: int, wall_id: torch.Tensor):
        """The boxes seen whole in frame i: in front of the camera, inside the
        image by the margin, and not hidden by a nearer wall (the wall drawn
        at each corner, pulled 2 px toward the centre, is the box's own)."""
        if len(self._box_wall) == 0:
            return []
        z_w = np.broadcast_to(self._wall[self._box_wall, 2][:, None, None], self._box_xy.shape[:2] + (1,))
        p = self._to_camera(i, np.concatenate([self._box_xy, z_w], -1))  # [B, 4, 3]
        z = p[..., 2]
        zs = np.where(z > 0.1, z, 1.0)
        u = self.fx * p[..., 0] / zs + self.cx
        v = self.fy * p[..., 1] / zs + self.cy
        m = self.margin
        cand = np.nonzero(((z > 0.1) & (u > m) & (u < self.width - m)
                           & (v > m) & (v < self.height - m)).all(-1))[0]
        if len(cand) == 0:
            return []
        uv = np.stack([u[cand], v[cand]], -1)
        inset = uv + 2.0 * np.sign(uv.mean(1, keepdims=True) - uv)
        px = torch.as_tensor(np.rint(inset).astype(np.int64), device=self.device)
        seen = (wall_id[px[..., 1], px[..., 0]].cpu().numpy()
                == self._box_wall[cand][:, None]).all(-1)
        boxes = self.layout["boxes"]
        return [self.detection_cls(quad=uv[j].astype(np.float32), text=boxes[b][2],
                                   score=self.score)
                for j, b in enumerate(cand) if seen[j]]

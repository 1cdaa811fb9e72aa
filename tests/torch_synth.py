"""cv2-free and jax-free twin of tests/synth.py for the PyTorch port.

Renders the same textured plane world along the same camera paths, in
numpy only, so that `chip_smoke.py` can drive the port on a machine that has
neither jax nor cv2. The textures come from the same numpy RNG calls as
synth.make_texture. The warps follow cv2.warpPerspective: the inverse
map of each destination pixel, bilinear (INTER_LINEAR) or rounded to the
nearest pixel (INTER_NEAREST), zero outside the texture.
tests/test_torch_synth.py holds the two renderers against each other.

Also: the long-run fixtures of synth.py (the `outback2` and `ring` paths,
`ring_world`, `degrade_frame` with its blur in numpy, `degrade_schedule`);
the text world (`TextWorld`, `render_text_sequence`, detections
projected from the ground-truth boxes, `plane_theta_in_cam`) and
`ate_rmse`, the Sim3-aligned ATE of synth.ate_rmse (Horn alignment), in
numpy; for datasets on disk, `render_distorted` (the image a camera with
radial-tangential distortion takes of the world, tests/test_cli_e2e.py's
renderer without cv2) and `encode_png` (a PNG writer with a chosen filter
per row). `ba_problem_arrays` is __graft_entry__._synthetic_problem (the
bench.py BA problem) in numpy, for ba_problem_from_numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from textslam_tpu_torch.geometry import se3_np

FX, FY, CX, CY = 420.0, 420.0, 320.0, 240.0
W, H = 640, 480
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])

def _gauss3_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), sigma) on float32: separable 3-tap
    kernel (computed in float64, stored as float32), BORDER_REFLECT_101."""
    x = np.arange(-1, 2, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    p = np.pad(img, 1, mode="reflect")
    rows = p[:, 1:-1] * k[1] + (p[:, :-2] + p[:, 2:]) * k[0]
    return (rows[1:-1] * k[1] + (rows[:-2] + rows[2:]) * k[0]).astype(np.float32)


def make_texture(rng, size=1024, blobs=4000):
    """High-frequency matte texture with corners at many scales
    (the RNG call sequence of synth.make_texture)."""
    tex = np.full((size, size), 128.0, np.float32)
    xs = rng.integers(6, size - 6, blobs)
    ys = rng.integers(6, size - 6, blobs)
    for x, y in zip(xs, ys):
        w = int(rng.integers(3, 14))
        h = int(rng.integers(3, 14))
        val = float(rng.uniform(0, 255))
        tex[y : y + h, x : x + w] = val
    return _gauss3_blur(tex, 0.8)


def _source_coords(Hm: np.ndarray, Wc: int, Hc: int):
    """Inverse-mapped source coordinates (X, Y, Wh) of every destination
    pixel, in float64, as cv2.warpPerspective forms them."""
    M = np.linalg.inv(Hm)
    xs = np.arange(Wc, dtype=np.float64)[None, :]
    ys = np.arange(Hc, dtype=np.float64)[:, None]
    X = M[0, 1] * ys + M[0, 2] + M[0, 0] * xs
    Y = M[1, 1] * ys + M[1, 2] + M[1, 0] * xs
    Wh = M[2, 1] * ys + M[2, 2] + M[2, 0] * xs
    return X, Y, Wh


def warp_linear(src: np.ndarray, Hm: np.ndarray, Wc: int, Hc: int) -> np.ndarray:
    """cv2.warpPerspective(src, Hm, (Wc, Hc), flags=INTER_LINEAR): bilinear
    at the exact inverse-mapped coordinates, zero outside the source."""
    X, Y, Wh = _source_coords(Hm, Wc, Hc)
    Wh = np.where(Wh != 0, Wh, np.inf)
    x, y = X / Wh, Y / Wh
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = (x - x0).astype(np.float32), (y - y0).astype(np.float32)
    x0, y0 = x0.clip(-2, 1 << 30).astype(np.int64), y0.clip(-2, 1 << 30).astype(np.int64)
    h, w = src.shape
    out = np.zeros((Hc, Wc), np.float32)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xx, yy = x0 + dx, y0 + dy
            inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            v = np.where(inside, src[yy.clip(0, h - 1), xx.clip(0, w - 1)], np.float32(0))
            out += v * (wy * wx)
    return out


def warp_nearest(src: np.ndarray, Hm: np.ndarray, Wc: int, Hc: int) -> np.ndarray:
    """cv2.warpPerspective(src, Hm, (Wc, Hc), flags=INTER_NEAREST)."""
    X, Y, Wh = _source_coords(Hm, Wc, Hc)
    Wh = np.where(Wh != 0, Wh, np.inf)
    xi = np.rint(X / Wh).clip(-1, 1 << 30).astype(np.int64)
    yi = np.rint(Y / Wh).clip(-1, 1 << 30).astype(np.int64)
    h, w = src.shape
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    return np.where(inside, src[yi.clip(0, h - 1), xi.clip(0, w - 1)], np.float32(0))


class PlaneWorld:
    """Textured planes z = const in world coordinates (synth.PlaneWorld)."""

    def __init__(self, seed=0, planes=None):
        rng = np.random.default_rng(seed)
        if planes is None:
            planes = [
                (7.0, 12.0, None),
                (4.0, 8.0, (260, 760, 200, 640)),
                (2.8, 6.0, (120, 420, 560, 980)),
                (5.0, 9.0, (600, 950, 80, 560)),
            ]
        self.planes = []  # (Z0, scale px/m, texture, mask, (x_off, y_off))
        for spec in planes:
            z0, scale, region = spec[:3]
            off = np.asarray(spec[3], np.float64) if len(spec) > 3 else np.zeros(2)
            tex = make_texture(rng)
            if region is None:
                mask = np.ones_like(tex)
            else:
                mask = np.zeros_like(tex)
                y0, y1, x0, x1 = region
                mask[y0:y1, x0:x1] = 1.0
            self.planes.append((z0, scale * 40.0, tex, mask, off))

    def render(self, pose_cw: np.ndarray, K_mat=None, size=None) -> np.ndarray:
        """Render the world for camera pose Tcw [7] (wxyz + t)."""
        Km = K if K_mat is None else K_mat
        Wc, Hc = (W, H) if size is None else size
        q, t = pose_cw[:4], pose_cw[4:]
        R = se3_np.qto_matrix(np.asarray(q, np.float32))
        img = np.zeros((Hc, Wc), np.float32)
        for z0, s, tex, mask, off in sorted(self.planes, key=lambda p: -p[0]):
            th, tw = tex.shape
            r1, r2, r3 = R[:, 0], R[:, 1], R[:, 2]
            col3 = (r3 * z0 + t + r1 * (off[0] - tw / (2 * s))
                    + r2 * (off[1] - th / (2 * s)))
            Hm = Km @ np.stack([r1 / s, r2 / s, col3], axis=1)
            warped = warp_linear(tex, Hm, Wc, Hc)
            wmask = warp_nearest(mask, Hm, Wc, Hc)
            img = np.where(wmask > 0, warped, img)
        return img


TEXT_STRINGS = ["CAFE", "EXIT", "HOTEL", "MARKET", "LIBRARY", "STATION"]


def plane_theta_in_cam(z0: float, pose_cw: np.ndarray) -> np.ndarray:
    """Ground-truth theta of the world plane z = z0 in a camera (theta^T p
    + 1 = 0 in camera coordinates)."""
    R = se3_np.qto_matrix(np.asarray(pose_cw[:4], np.float32)).astype(np.float64)
    t = np.asarray(pose_cw[4:], np.float64)
    n_c = R @ np.array([0.0, 0.0, 1.0])
    d_c = np.array([0.0, 0.0, 1.0]) @ (-R.T @ t) - z0
    return (n_c / d_c).astype(np.float32)


class TextWorld(PlaneWorld):
    """PlaneWorld + rectangular text regions on the planes, with strings
    (synth.TextWorld: the same RNG calls, so the same boxes)."""

    def __init__(self, seed=0, planes=None, boxes_per_plane=2,
                 box_px=((140, 220), (70, 110))):
        super().__init__(seed=seed, planes=planes)
        rng = np.random.default_rng(seed + 100)
        self.boxes = []  # (plane_idx, texture rect corners [4, 2], string)
        si = 0
        for pi, (z0, s, tex, mask, off) in enumerate(self.planes):
            ys, xs = np.nonzero(mask)
            if len(ys) == 0:
                continue
            y0, y1, x0, x1 = ys.min(), ys.max(), xs.min(), xs.max()
            for _ in range(boxes_per_plane):
                bw = int(rng.uniform(*box_px[0]))
                bh = int(rng.uniform(*box_px[1]))
                if x1 - x0 < bw + 40 or y1 - y0 < bh + 40:
                    continue
                bx = int(rng.uniform(x0 + 20, x1 - bw - 20))
                by = int(rng.uniform(y0 + 20, y1 - bh - 20))
                quad_tex = np.array([[bx, by], [bx + bw, by], [bx + bw, by + bh], [bx, by + bh]],
                                    np.float32)
                # unique strings, so a box maps to its ground-truth plane 1:1
                self.boxes.append((pi, quad_tex, f"{TEXT_STRINGS[si % len(TEXT_STRINGS)]}{si}"))
                si += 1

    def detections(self, pose_cw: np.ndarray, margin=8.0, K_mat=None, size=None):
        """The text boxes projected into a camera -> list of TextDetection
        (boxes behind the camera or not fully inside the image are left out)."""
        from textslam_tpu_torch.frontend.frame import TextDetection

        Km = K if K_mat is None else K_mat
        Wc, Hc = (W, H) if size is None else size
        R = se3_np.qto_matrix(np.asarray(pose_cw[:4], np.float32))
        t = pose_cw[4:]
        dets = []
        for pi, quad_tex, string in self.boxes:
            z0, s, tex, mask, off = self.planes[pi]
            th, tw = tex.shape
            X = (quad_tex[:, 0] - tw / 2) / s + off[0]
            Y = (quad_tex[:, 1] - th / 2) / s + off[1]
            pc = np.stack([X, Y, np.full(4, z0)], -1) @ R.T + t
            if (pc[:, 2] <= 0.1).any():
                continue
            uv = np.stack([Km[0, 0] * pc[:, 0] / pc[:, 2] + Km[0, 2],
                           Km[1, 1] * pc[:, 1] / pc[:, 2] + Km[1, 2]], -1)
            if not ((uv[:, 0] > margin) & (uv[:, 0] < Wc - margin)
                    & (uv[:, 1] > margin) & (uv[:, 1] < Hc - margin)).all():
                continue
            dets.append(TextDetection(quad=uv.astype(np.float32), text=string, score=0.9))
        return dets


RING_SEGMENTS = 12          # wall segments around the circuit
RING_SPACING = 1.0          # metres between segment centres along the ring
RING_RADIUS = RING_SEGMENTS * RING_SPACING / (2 * np.pi)
RING_LAPS = 1.15            # loop-closure fixtures revisit the first ~15%


def _gauss_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) on float32: separable
    kernel (computed in float64, stored as float32), BORDER_REFLECT_101."""
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    p = np.pad(np.asarray(img, np.float32), r, mode="reflect")
    h, w = img.shape
    rows = sum(p[:, i:i + w] * k[i] for i in range(ksize))
    return sum(rows[i:i + h] * k[i] for i in range(ksize)).astype(np.float32)


def degrade_frame(img, rng, g, darken=0.70, noise=13.0, blur=1.7):
    """Photometric degradation at strength g in [0, 1] (synth.degrade_frame:
    the same darkening, Gaussian blur and sensor noise from the same RNG
    call): an underexposed, motion-blurred stretch such as a tunnel, for the
    engineered-drift loop fixtures."""
    if g <= 0:
        return img
    out = img * (1.0 - darken * g)
    s = float(blur * g)
    if s > 0.05:
        out = _gauss_blur(out, int(2 * round(2 * s) + 1), s)
    out = out + rng.normal(0.0, noise * g, out.shape)
    return np.clip(out, 0, 255).astype(np.float32)


def degrade_schedule(n_frames, f0=0.21, f1=0.74, ramp=0.05):
    """Per-frame degradation strength: 0 outside [f0, f1] (fractions of the
    sequence), cosine-ramped over `ramp` at both edges (synth.degrade_schedule)."""
    s = np.linspace(0.0, 1.0, n_frames)
    up = np.clip((s - f0) / ramp, 0.0, 1.0)
    down = np.clip((f1 - s) / ramp, 0.0, 1.0)
    return (0.5 - 0.5 * np.cos(np.pi * np.minimum(up, down))).astype(np.float32)


def ring_world(seed=0, n_segments=RING_SEGMENTS, boxes_per_plane=3,
               box_px=((140, 220), (70, 110))):
    """A circuit of wall segments tiled around a ring in the x-y plane
    (synth.ring_world): each segment is visible only from a ~+-2 m arc of
    the `ring` path, so the covisibility graph breaks by mid-lap and the
    second lap maps the start walls again, the precondition of a semantic
    loop closure."""
    R = n_segments * RING_SPACING / (2 * np.pi)
    planes = []
    for i in range(n_segments):
        phi = 2 * np.pi * i / n_segments
        x, y = R * np.sin(phi), R * (1 - np.cos(phi))
        depth = 1.8 if i % 2 == 0 else 2.6
        # 12.5 -> 500 px/m: each 1024-px texture spans 2.05 m
        planes.append((depth, 12.5, None, (x, y)))
    return TextWorld(seed=seed, planes=planes, boxes_per_plane=boxes_per_plane, box_px=box_px)


def _qexp(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w, np.float32)
    sq = np.float32((w * w).sum())
    if sq < 1e-12:
        return np.concatenate([[1.0 - sq / 8.0], (0.5 - sq / 48.0) * w]).astype(np.float32)
    th = np.sqrt(sq)
    return np.concatenate([[np.cos(0.5 * th)], np.sin(0.5 * th) / th * w]).astype(np.float32)


def camera_path(n_frames: int, kind="lateral"):
    """Ground-truth Tcw poses [N, 7] (the `lateral`, `forward`, `outback`,
    `outback2` and `ring` paths of synth.camera_path)."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        if kind == "lateral":
            t_wc = np.array([1.2 * s, 0.15 * np.sin(2 * np.pi * s), 0.3 * s])
            w = np.array([0.0, -0.25 * s, 0.02 * np.sin(2 * np.pi * s)])
        elif kind == "forward":
            t_wc = np.array([0.2 * s, 0.0, 1.5 * s])
            w = np.array([0.0, 0.05 * s, 0.0])
        elif kind == "outback":
            # out along +x and back to the start (the loop-closure fixture)
            u = 2 * s if s <= 0.5 else 2 * (1 - s)
            t_wc = np.array([1.0 * u, 0.05 * np.sin(np.pi * u), 0.15 * u])
            w = np.array([0.0, -0.2 * u, 0.0])
        elif kind == "outback2":
            # two out-and-back excursions (the multi-loop fixture)
            v = 2 * s % 1.0 if s < 1.0 else 1.0
            u = 2 * v if v <= 0.5 else 2 * (1 - v)
            t_wc = np.array([1.0 * u, 0.05 * np.sin(np.pi * u), 0.15 * u])
            w = np.array([0.0, -0.2 * u, 0.0])
        elif kind == "ring":
            # one and a bit laps around ring_world's circuit, translation only
            phi = 2 * np.pi * RING_LAPS * s
            t_wc = np.array([RING_RADIUS * np.sin(phi), RING_RADIUS * (1 - np.cos(phi)), 0.0])
            w = np.zeros(3)
        else:
            raise ValueError(kind)
        Twc = np.concatenate([_qexp(w), t_wc]).astype(np.float32)
        poses.append(se3_np.inverse(Twc).astype(np.float32))
    return np.stack(poses)


def render_sequence(n_frames=40, seed=0, kind="lateral", K_mat=None, size=None):
    world = PlaneWorld(seed=seed)
    poses = camera_path(n_frames, kind)
    frames = [world.render(p, K_mat=K_mat, size=size) for p in poses]
    return frames, poses


def render_text_sequence(n_frames=40, seed=0, kind="lateral", K_mat=None, size=None):
    """(frames, detections per frame, ground-truth Tcw [N, 7], world)."""
    world = TextWorld(seed=seed)
    poses = camera_path(n_frames, kind)
    frames = [world.render(p, K_mat=K_mat, size=size) for p in poses]
    dets = [world.detections(p, K_mat=K_mat, size=size) for p in poses]
    return frames, dets, poses, world


def ba_problem_arrays(n_kf=8, n_pts=2048, obs_per_kf=512, n_text=16, text_feat=64,
                      img_hw=(480, 640), with_text=True, seed=0) -> dict:
    """__graft_entry__._synthetic_problem in numpy, from the same RNG calls:
    a windowed BA problem on synthetic geometry (the observations are
    exact projections plus noise; the text rows are grouped in [pair,
    text_feat] order over random image stacks). Returns the field dict
    textslam_tpu_torch.solver.ba.ba_problem_from_numpy reads."""
    rng = np.random.default_rng(seed)
    fx = fy = 420.0
    cx, cy = 320.0, 240.0
    poses = []
    for k in range(n_kf):
        q = _qexp(rng.normal(0, 0.02, 3).astype(np.float32))
        t = np.array([-0.25 * k, 0, 0]) + rng.normal(0, 0.01, 3)
        poses.append(np.concatenate([q, t]).astype(np.float32))
    poses = np.stack(poses)
    uv_host = np.stack([rng.uniform(40, 600, n_pts), rng.uniform(40, 440, n_pts)], -1)
    ray = np.concatenate([(uv_host - [cx, cy]) / [fx, fy], np.ones((n_pts, 1))],
                         -1).astype(np.float32)
    rho = (1.0 / rng.uniform(2, 8, n_pts)).astype(np.float32)
    O = n_kf * obs_per_kf
    tgt = np.repeat(np.arange(n_kf, dtype=np.int32), obs_per_kf)
    point = rng.integers(0, n_pts, O).astype(np.int32)
    p_host = ray[point] / rho[point][:, None]
    A = se3_np.compose(poses[tgt], se3_np.inverse(poses[0])[None])
    p_c = se3_np.apply(A, p_host)
    uv = np.stack([fx * p_c[:, 0] / p_c[:, 2] + cx, fy * p_c[:, 1] / p_c[:, 2] + cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    scene = dict(tgt=tgt, host=np.zeros(O, np.int32), host_frozen_pose=np.tile(poses[0], (O, 1)),
                 host_in_window=np.ones(O, bool), point=point, ray=ray[point],
                 uv=uv.astype(np.float32), weight=np.full(O, 1.0 / 1.2, np.float32),
                 valid=p_c[:, 2] > 0.1)
    text = images = None
    if with_text:
        Hh, Ww = img_hw
        inten = rng.uniform(0, 255, (n_kf, Hh, Ww)).astype(np.float32)
        gx = np.gradient(inten, axis=2) * 8.0
        gy = np.gradient(inten, axis=1) * 8.0
        images = np.stack([inten, gx, gy], axis=-1).astype(np.float32)
        n_pairs = n_text * max(n_kf // 2, 1)
        Ot = n_pairs * text_feat
        pair_tgt = rng.integers(1, n_kf, n_pairs).astype(np.int32)
        pair_tid = np.tile(np.arange(n_text, dtype=np.int32), max(n_kf // 2, 1))
        mx, my = min(120, Ww // 4), min(60, Hh // 4)
        box_cx = rng.uniform(mx, Ww - mx, n_pairs)
        box_cy = rng.uniform(my, Hh - my, n_pairs)
        uvf = np.stack([
            np.repeat(box_cx, text_feat) + rng.uniform(-0.75 * mx, 0.75 * mx, Ot),
            np.repeat(box_cy, text_feat) + rng.uniform(-0.75 * my, 0.75 * my, Ot),
        ], -1)
        offs = np.array([[0, 0], [2, 0], [-2, 0], [0, 2], [0, -2], [1, -1], [-1, 1], [-1, -1]],
                        np.float32)
        pos = uvf[:, None, :] + offs[None]
        rays_t = np.concatenate([(pos - [cx, cy]) / [fx, fy], np.ones((Ot, 8, 1))],
                                -1).astype(np.float32)
        text = dict(tgt=np.repeat(pair_tgt, text_feat), host=np.zeros(Ot, np.int32),
                    host_frozen_pose=np.tile(poses[0], (Ot, 1)),
                    host_in_window=np.ones(Ot, bool), text=np.repeat(pair_tid, text_feat),
                    rays=rays_t, ref_inten=rng.normal(0, 1, (Ot, 8)).astype(np.float32),
                    mu_sigma=np.stack([np.full(Ot, 128.0), np.full(Ot, 40.0)],
                                      -1).astype(np.float32),
                    weight=np.full(Ot, 5.0, np.float32), valid=np.ones(Ot, bool), level=0)
    theta = np.tile(np.array([0.05, -0.02, -0.25], np.float32), (max(n_text, 1), 1))
    return dict(poses=poses, pose_free=np.array([False] + [True] * (n_kf - 1)), rho=rho,
                rho_free=np.ones(n_pts, bool), theta=theta,
                theta_free=np.array([with_text] * max(n_text, 1)), scene=scene, text=text,
                images=images, fx=fx, fy=fy, cx=cx, cy=cy)


def _horn_alignment(P1: np.ndarray, P2: np.ndarray) -> tuple:
    """(s, R, t) minimizing ||P1 - (s R P2 + t)|| — the construction of
    textslam_tpu.geometry.sim3.horn_alignment, in float64."""
    c1, c2 = P1.mean(0), P2.mean(0)
    X1, X2 = P1 - c1, P2 - c2
    M = X2.T @ X1
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = M
    N = np.array([
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ])
    q = np.linalg.eigh(N)[1][:, -1]
    q = q if q[0] >= 0 else -q
    R = se3_np.qto_matrix(q / np.linalg.norm(q))
    RX2 = X2 @ R.T
    s = (X1 * RX2).sum() / max((RX2 * RX2).sum(), 1e-12)
    return s, R, c1 - s * (R @ c2)


def ate_rmse(est_ts, est_poses_cw, gt_poses_cw) -> float:
    """Sim3-aligned ATE RMSE of camera centers (evo_ape -s protocol);
    est_ts are frame indices into gt_poses_cw."""
    est = np.asarray(est_poses_cw, np.float64)
    gt = np.asarray(gt_poses_cw, np.float64)[[int(round(t)) for t in est_ts]]
    est_C = se3_np.inverse(est)[:, 4:7]
    gt_C = se3_np.inverse(gt)[:, 4:7]
    s, R, t = _horn_alignment(gt_C, est_C)
    aligned = s * est_C @ R.T + t
    return float(np.sqrt((np.linalg.norm(aligned - gt_C, axis=-1) ** 2).mean()))


def undistort_points(uv: np.ndarray, K_mat: np.ndarray, dist, iters: int = 20) -> np.ndarray:
    """Ideal pinhole pixels of distorted pixels uv [..., 2]: the inverse of
    OpenCV's k1, k2, p1, p2, k3 model by fixed-point iteration in float64
    (cv2.undistortPoints(uv, K, dist, P=K) without OpenCV)."""
    k1, k2, p1, p2, k3 = (float(v) for v in dist)
    fx, fy, cx, cy = K_mat[0, 0], K_mat[1, 1], K_mat[0, 2], K_mat[1, 2]
    xd = (np.asarray(uv, np.float64)[..., 0] - cx) / fx
    yd = (np.asarray(uv, np.float64)[..., 1] - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
        x = (xd - (2 * p1 * x * y + p2 * (r2 + 2 * x * x))) / kr
        y = (yd - (p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)) / kr
    return np.stack([x * fx + cx, y * fy + cy], -1)


def distorted_rays(dist, K_mat=None, size=None) -> np.ndarray:
    """[H, W, 3] homogeneous undistorted pinhole pixels of every pixel of a
    camera with distortion `dist` (the input of render_distorted)."""
    Km = K if K_mat is None else K_mat
    Wc, Hc = (W, H) if size is None else size
    qx, qy = np.meshgrid(np.arange(Wc, dtype=np.float64), np.arange(Hc, dtype=np.float64))
    und = undistort_points(np.stack([qx, qy], -1), Km, dist)
    return np.concatenate([und, np.ones((Hc, Wc, 1))], -1)


def render_distorted(world, pose_cw: np.ndarray, rays: np.ndarray, K_mat=None) -> np.ndarray:
    """The DISTORTED camera image in one resample per plane: each pixel
    samples the plane texture at H^-1 applied to its undistorted pinhole
    position (`rays`, from distorted_rays), bilinear, zero outside the
    texture (tests/test_cli_e2e.py's render_distorted)."""
    Km = K if K_mat is None else K_mat
    R = se3_np.qto_matrix(np.asarray(pose_cw[:4], np.float32))
    t = pose_cw[4:]
    img = np.zeros(rays.shape[:2], np.float32)
    for z0, s, tex, mask, off in sorted(world.planes, key=lambda p: -p[0]):
        th, tw = tex.shape
        r1, r2, r3 = R[:, 0], R[:, 1], R[:, 2]
        col3 = (r3 * z0 + t + r1 * (off[0] - tw / (2 * s)) + r2 * (off[1] - th / (2 * s)))
        Hm = Km @ np.stack([r1 / s, r2 / s, col3], axis=1)
        tc = rays @ np.linalg.inv(Hm).T
        x = (tc[..., 0] / tc[..., 2]).astype(np.float32)
        y = (tc[..., 1] / tc[..., 2]).astype(np.float32)
        img = np.where(_sample_nearest(mask, x, y) > 0, _sample_linear(tex, x, y), img)
    return img


def _sample_linear(src, x, y):
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    h, w = src.shape
    out = np.zeros(x.shape, np.float32)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xx, yy = x0 + dx, y0 + dy
            inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            out += np.where(inside, src[yy.clip(0, h - 1), xx.clip(0, w - 1)], 0) * (wy * wx)
    return out


def _sample_nearest(src, x, y):
    xi, yi = np.rint(x).astype(np.int64), np.rint(y).astype(np.int64)
    h, w = src.shape
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    return np.where(inside, src[yi.clip(0, h - 1), xi.clip(0, w - 1)], 0)


def _png_filter(x: np.ndarray, prior: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """One row's PNG filter (x, prior: the row and the row above as int16
    bytes)."""
    a = np.concatenate([np.zeros(bpp, np.int16), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int16), prior[:-bpp]])
    b = prior
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    else:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def encode_png(img: np.ndarray, filters=(0, 1, 2, 3, 4), idat_chunks: int = 1,
               color: str = "bgr") -> bytes:
    """PNG bytes of a uint8 / uint16 image: [H, W] gray, or [H, W, 3|4] in
    OpenCV's BGR(A) order (color="bgr", as cv2.imwrite takes it) or stored
    as it is (color="raw": [H, W, 2] is gray+alpha). Row r uses filter
    filters[r % len(filters)]; the compressed stream is split over
    idat_chunks IDAT chunks. Written per row in Python: for test data."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"encode_png: dtype {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    ch = img.shape[2]
    if color == "bgr" and ch >= 3:
        img = img[:, :, [2, 1, 0, 3][:ch]]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 16 if img.dtype == np.uint16 else 8
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    rows = rows.reshape(h, -1).astype(np.int16)
    bpp = ch * depth // 8
    prior = np.zeros(rows.shape[1], np.int16)
    raw = bytearray()
    for r in range(h):
        t = filters[r % len(filters)]
        raw.append(t)
        raw += _png_filter(rows[r], prior, t, bpp).tobytes()
        prior = rows[r]
    comp = zlib.compress(bytes(raw), 6)
    step = -(-len(comp) // idat_chunks)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(body, zlib.crc32(kind))))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                         0, 0, 0))
    for i in range(idat_chunks):
        out += chunk(b"IDAT", comp[i * step:(i + 1) * step])
    return out + chunk(b"IEND", b"")


def write_yaml(path, exp_name, read_path, read_list, K_mat=None, size=None, dist=(0,) * 5,
               fps=10.0, no_text=0):
    """A reference-style experiment yaml (tests/test_cli_e2e.py's write_yaml
    with the camera as arguments)."""
    Km = K if K_mat is None else K_mat
    Wc, Hc = (W, H) if size is None else size
    with open(path, "w") as f:
        f.write("%YAML:1.0\n")
        f.write(f"Exp name: {exp_name}\n")
        f.write(f"Exp noText: {no_text}\n")
        f.write(f'Exp read path: "{read_path}/"\n')
        f.write(f'Exp read list: "{read_list}"\n')
        f.write(f"Camera.fx: {Km[0, 0]}\nCamera.fy: {Km[1, 1]}\n")
        f.write(f"Camera.cx: {Km[0, 2]}\nCamera.cy: {Km[1, 2]}\n")
        f.write(f"Camera.k1: {dist[0]}\nCamera.k2: {dist[1]}\n")
        f.write(f"Camera.p1: {dist[2]}\nCamera.p2: {dist[3]}\n")
        f.write(f"Camera.k3: {dist[4]}\n")
        f.write(f"Camera.width: {Wc}\nCamera.height: {Hc}\n")
        f.write(f"Camera.fps: {fps}\nCamera.RGB: 0\n")


def write_dataset(root, n_frames: int, seed=0, kind="lateral", dist=(-0.05, 0.01, 0.0, 0.0, 0.0),
                  K_mat=None, size=None, n_short=12, fps=10.0):
    """The text world rendered to disk in the reference's dataset layout
    (tests/test_cli_e2e.py's fixture): DISTORTED frames as PNG (all five
    row filters) under images/, the ground-truth detections as
    text/<stem>_dete.txt / _mean.txt (frame 5 adds a CJK and a "#" probe
    line), Imlist.txt (every frame) and Imshort.txt (the first n_short), and
    the yamls: exp0 (Imlist) and exp1-3 (Imshort), scene-only nt_full /
    nt_short, text-on t_short. Returns (ground-truth Tcw [N, 7], world, the
    written uint8 frames)."""
    import os

    Km = K if K_mat is None else K_mat
    world = TextWorld(seed=seed)
    poses = camera_path(n_frames, kind)
    rays = distorted_rays(dist, Km, size)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "text"), exist_ok=True)
    lines, written = [], []
    for i, p in enumerate(poses):
        name = f"images/{i:04d}.png"
        img = render_distorted(world, p, rays, Km).clip(0, 255).astype(np.uint8)
        written.append(img)
        with open(os.path.join(root, name), "wb") as f:
            f.write(encode_png(img))
        stem = os.path.join(root, "text", f"{i:04d}")
        with open(stem + "_dete.txt", "w") as fd, \
                open(stem + "_mean.txt", "w", encoding="utf-8") as fm:
            for d in world.detections(p, K_mat=Km, size=size):
                fd.write(",".join(f"{v:.2f}" for v in d.quad.ravel()) + "\n")
                fm.write(f"{d.text},{d.score:.2f}\n")
            if i == 5:
                # the parser's CJK and empty-OCR ("#") handling, on one frame
                # only (a detection static in the image seeds junk landmarks)
                fd.write("1,1,9,1,9,9,1,9\n")
                fm.write("你好餐厅,0.50\n")
                fd.write("11,1,19,1,19,9,11,9\n")
                fm.write("#,0.10\n")
        lines.append(f"{i / fps:.6f} {name}\n")
    with open(os.path.join(root, "Imlist.txt"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(root, "Imshort.txt"), "w") as f:
        f.writelines(lines[:n_short])
    cam = dict(K_mat=Km, size=size, dist=dist, fps=fps)
    for exp, lst in ((0, "Imlist"), (1, "Imshort"), (2, "Imshort"), (3, "Imshort")):
        write_yaml(os.path.join(root, f"exp{exp}.yaml"), exp, root, lst, **cam)
    write_yaml(os.path.join(root, "nt_full.yaml"), 0, root, "Imlist", no_text=1, **cam)
    write_yaml(os.path.join(root, "nt_short.yaml"), 0, root, "Imshort", no_text=1, **cam)
    write_yaml(os.path.join(root, "t_short.yaml"), 0, root, "Imshort", **cam)
    return poses, world, written

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


# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _png_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, ch] samples -> [h, row bytes] as PNG stores them (big-endian
    16-bit samples; 1, 2 and 4-bit samples packed from the high bit, each
    row padded to a byte)."""
    h, w, ch = samples.shape
    if depth == 16:
        return np.ascontiguousarray(samples.astype(">u2")).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    per = 8 // depth
    v = samples.reshape(h, w * ch).astype(np.uint8)
    v = np.pad(v, ((0, 0), (0, -v.shape[1] % per)))
    v = v.reshape(h, -1, per)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(v << shifts, axis=2).astype(np.uint8)


def png_file(samples: np.ndarray, depth: int, ctype: int, filters=(0, 1, 2, 3, 4),
             idat_chunks: int = 1, interlace: bool = False, plte=None, trns=None) -> bytes:
    """PNG bytes of samples [H, W, ch] stored as they are (gray, RGB, palette
    indices, gray+alpha, RGBA) at bit depth `depth` and color type `ctype`,
    with an optional PLTE ([n, 3] RGB) and tRNS chunk (bytes as the PNG
    stores them), Adam7-interlaced on request. Row r of each pass uses
    filter filters[r % len(filters)]; the compressed stream is split over
    idat_chunks IDAT chunks. Written per row in Python: for test data."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = bytearray()
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _png_rows(sub, depth).astype(np.int16)
        prior = np.zeros(rows.shape[1], np.int16)
        for r in range(rows.shape[0]):
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
                                                         0, 0, int(interlace)))
    if plte is not None:
        out += chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", bytes(trns))
    for i in range(idat_chunks):
        out += chunk(b"IDAT", comp[i * step:(i + 1) * step])
    return out + chunk(b"IEND", b"")


def encode_png(img: np.ndarray, filters=(0, 1, 2, 3, 4), idat_chunks: int = 1,
               color: str = "bgr", interlace: bool = False) -> bytes:
    """PNG bytes of a uint8 / uint16 image: [H, W] gray, or [H, W, 3|4] in
    OpenCV's BGR(A) order (color="bgr", as cv2.imwrite takes it) or stored
    as it is (color="raw": [H, W, 2] is gray+alpha); png_file's filters,
    IDAT split and interlacing."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"encode_png: dtype {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    ch = img.shape[2]
    if color == "bgr" and ch >= 3:
        img = img[:, :, [2, 1, 0, 3][:ch]]
    return png_file(img, 16 if img.dtype == np.uint16 else 8, {1: 0, 2: 4, 3: 2, 4: 6}[ch],
                    filters, idat_chunks, interlace)


# JPEG's Annex K tables: luminance and chrominance quantization (quality
# 50, zigzag order) and the Huffman tables (16 code-length counts, values)
_JPEG_Q = (bytes.fromhex("100b0c0e0c0a100e0d0e1211101318281a181616183123251d283a333d3c3933383740"
                         "485c4e404457453738506d51575f626768673e4d71797064785c656763"),
           bytes.fromhex("1112121815182f1a1a2f634238426363636363636363636363636363636363636363"
                         "636363636363636363636363636363636363636363636363636363636363"))
_JPEG_DC = ((bytes.fromhex("00010501010101010100000000000000"), bytes(range(12))),
            (bytes.fromhex("00030101010101010101010000000000"), bytes(range(12))))
_JPEG_AC = (
    (bytes.fromhex("0002010303020403050504040000017d"), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718"
        "191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475"
        "767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (bytes.fromhex("00020102040403040705040400010277"), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125"
        "f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a7374"
        "75767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9ba"
        "c2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")))


def _huffman_codes(counts: bytes, values: bytes):
    """Canonical codes of a JPEG Huffman table: (code [256], length [256]) by symbol."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[values[k]], len_of[values[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _jpeg_qtable(i: int, quality: int, baseline: bool) -> np.ndarray:
    """libjpeg's jpeg_set_quality scaling of Annex K table i (zigzag order);
    values above 255 only when not baseline."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = (np.frombuffer(_JPEG_Q[i], np.uint8).astype(np.int64) * scale + 50) // 100
    return q.clip(1, 255 if baseline else 32767)


def _pack_bits(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate codes (value, bit length), pad the last byte with 1 bits
    and stuff a 0x00 after every 0xFF byte."""
    total = int(lens.sum())
    rep = np.repeat(vals, lens)
    offs = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    bits = ((rep >> (np.repeat(lens, lens) - 1 - offs)) & 1).astype(np.uint8)
    by = np.packbits(np.concatenate([bits, np.ones(-total % 8, np.uint8)]))
    return np.insert(by, np.flatnonzero(by == 0xFF) + 1, 0).tobytes()


def _size_bits(v: np.ndarray):
    """JPEG's magnitude category of each value and its value bits."""
    size = np.zeros(v.shape, np.int64)
    a = np.abs(v)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return size, np.where(v >= 0, v, v + (1 << size) - 1)


def encode_jpeg(img: np.ndarray, quality: int = 90, sampling: str = "420", restart: int = 0,
                baseline: bool = True) -> bytes:
    """A baseline (SOF0; SOF1 with 16-bit tables when baseline=False lets a
    table pass 255) sequential JPEG of a uint8 image, in numpy: [H, W] gray,
    or [H, W, 3] in OpenCV's BGR order as JFIF YCbCr sampled 4:2:0
    (sampling="420") or 4:4:4 ("444"). Annex K tables scaled to `quality`
    as libjpeg scales them, a float DCT, an optional restart interval (in
    MCUs). The DCT, quantization and code assembly are vectorized; Python
    loops only over restart segments. For test data: libjpeg's encoder
    differs in its DCT and color rounding, so the files are not cv2's."""
    from textslam_tpu_torch.io.jpeg import NATURAL_ORDER

    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"encode_jpeg: a uint8 [H, W] or [H, W, 3] image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    if img.ndim == 2:
        planes, factors = [img.astype(np.float64)], [(1, 1)]
    else:
        b, g, r = (img[:, :, i].astype(np.float64) for i in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
        f = {"420": 2, "444": 1}[sampling]
        factors = [(f, f), (1, 1), (1, 1)]
    hmax = max(fx for fx, _ in factors)
    mcu = 8 * hmax
    mh, mw = -(-h // mcu), -(-w // mcu)
    # DCT-II basis, orthonormal
    k = np.arange(8)
    C = np.sqrt(2 / 8) * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    C[0] /= np.sqrt(2)
    coefs, grids = [], []
    for i, (pl, (fx, fy)) in enumerate(zip(planes, factors)):
        pl = np.pad(pl, ((0, mh * mcu - h), (0, mw * mcu - w)), mode="edge")
        if hmax // fx > 1:  # subsample by the block mean
            s = hmax // fx
            pl = pl.reshape(pl.shape[0] // s, s, pl.shape[1] // s, s).mean((1, 3))
        bh, bw = pl.shape[0] // 8, pl.shape[1] // 8
        blocks = pl.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128.0
        dct = np.einsum("ij,abjk,lk->abil", C, blocks, C).reshape(bh, bw, 64)
        q = np.zeros(64, np.int64)
        q[NATURAL_ORDER] = _jpeg_qtable(min(i, 1), quality, baseline)
        coefs.append(np.rint(dct / q).astype(np.int64)[:, :, NATURAL_ORDER])  # zigzag
        grids.append((fx, fy))
    # blocks in scan order: MCU by MCU, each component's fx x fy blocks
    order_c, order_b = [], []
    for c, (fx, fy) in enumerate(grids):
        by, bx = np.meshgrid(np.arange(fy), np.arange(fx), indexing="ij")
        my, mx = np.meshgrid(np.arange(mh), np.arange(mw), indexing="ij")
        rows = (my.reshape(-1, 1) * fy + by.reshape(1, -1))
        cols = (mx.reshape(-1, 1) * fx + bx.reshape(1, -1))
        order_c.append(np.full(rows.shape, c))
        order_b.append(coefs[c][rows, cols])  # [MCUs, blocks of c, 64]
    zz = np.concatenate(order_b, 1)  # [MCUs, blocks per MCU, 64]
    comp = np.concatenate(order_c, 1)[0]
    n_mcu, per = zz.shape[:2]
    zz = zz.reshape(-1, 64)
    bcomp = np.tile(comp, n_mcu)
    mcu_of = np.repeat(np.arange(n_mcu), per)
    seg = mcu_of // restart if restart else np.zeros_like(mcu_of)
    tab = np.minimum(bcomp, 1)
    dc_tabs = [_huffman_codes(*t) for t in _JPEG_DC]
    ac_tabs = [_huffman_codes(*t) for t in _JPEG_AC]

    def huff(tabs, t, sym):
        """(code, length) of each symbol in its block's table (0: luma)."""
        return (np.where(t == 0, tabs[0][0][sym], tabs[1][0][sym]),
                np.where(t == 0, tabs[0][1][sym], tabs[1][1][sym]))

    # events (block, position, step) -> (value, bit length)
    keys, vals, lens = [], [], []

    def emit(blk, pos, step, v, n):
        keys.append(np.stack([blk, pos, step], 1))
        vals.append(np.asarray(v, np.int64))
        lens.append(np.asarray(n, np.int64))

    nb = len(zz)
    diff = np.zeros(nb, np.int64)
    for c in range(len(grids)):
        idx = np.flatnonzero(bcomp == c)
        dc = zz[idx, 0]
        prev = np.concatenate([[0], dc[:-1]])
        prev[np.flatnonzero(np.diff(np.concatenate([[-1], seg[idx]])))] = 0
        diff[idx] = dc - prev
    size, bits = _size_bits(diff)
    ar, zero = np.arange(nb), np.zeros(nb, np.int64)
    emit(ar, zero, zero, *huff(dc_tabs, tab, size))
    emit(ar, zero, zero + 1, bits, size)
    blk, pos = np.nonzero(zz[:, 1:])
    pos = pos + 1
    v = zz[blk, pos]
    first = np.concatenate([[True], blk[1:] != blk[:-1]])
    prev_pos = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
    run = pos - prev_pos - 1
    nzrl = run // 16  # a ZRL (16 zeros) symbol each
    size, bits = _size_bits(v)
    zb = np.repeat(blk, nzrl)
    zstep = np.arange(len(zb)) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
    emit(zb, np.repeat(pos, nzrl), zstep, *huff(ac_tabs, tab[zb], np.full(len(zb), 0xF0)))
    emit(blk, pos, nzrl, *huff(ac_tabs, tab[blk], (run % 16) * 16 + size))
    emit(blk, pos, nzrl + 1, bits, size)
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, blk, pos)
    eob = np.flatnonzero(last < 63)
    emit(eob, np.full(len(eob), 64), np.zeros(len(eob), np.int64),
         *huff(ac_tabs, tab[eob], np.zeros(len(eob), np.int64)))
    key = np.concatenate(keys)
    order = np.lexsort((key[:, 2], key[:, 1], key[:, 0]))
    vals, lens = np.concatenate(vals)[order], np.concatenate(lens)[order]
    ev_seg = seg[key[order, 0]]
    data = bytearray()
    bounds = np.searchsorted(ev_seg, np.arange(int(seg[-1]) + 2))
    for i in range(len(bounds) - 1):
        if i:
            data += bytes([0xFF, 0xD0 + (i - 1) % 8])
        data += _pack_bits(vals[bounds[i]:bounds[i + 1]], lens[bounds[i]:bounds[i + 1]])

    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    nq = min(len(grids), 2)
    qt = [_jpeg_qtable(i, quality, baseline) for i in range(nq)]
    wide = any(int(t.max()) > 255 for t in qt)
    out = b"\xff\xd8" + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for i, t in enumerate(qt):
        out += segment(0xDB, bytes([(16 if wide else 0) | i])
                       + (t.astype(">u2").tobytes() if wide else t.astype(np.uint8).tobytes()))
    sof = struct.pack(">BHHB", 8, h, w, len(grids))
    for c, (fx, fy) in enumerate(grids):
        sof += bytes([c + 1, fx * 16 + fy, min(c, 1)])
    out += segment(0xC1 if wide else 0xC0, sof)
    for i in range(nq):
        out += segment(0xC4, bytes([i]) + _JPEG_DC[i][0] + _JPEG_DC[i][1])
        out += segment(0xC4, bytes([0x10 | i]) + _JPEG_AC[i][0] + _JPEG_AC[i][1])
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    sos = bytes([len(grids)])
    for c in range(len(grids)):
        sos += bytes([c + 1, 0x11 * min(c, 1)])
    out += segment(0xDA, sos + bytes([0, 63, 0]))
    return out + bytes(data) + b"\xff\xd9"


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


def tint_bgr(gray: np.ndarray) -> np.ndarray:
    """A [H, W, 3] BGR frame whose cv2 BGR2GRAY is `gray` within a level or
    two where no channel clips: red and blue gains that vary smoothly over
    the image (as a camera's white balance and lens shading leave them),
    the green channel offsetting their weight in the gray."""
    h, w = gray.shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    g = gray.astype(np.float64)
    a = 0.12 * np.sin(2 * np.pi * x / w + 0.7) * np.cos(np.pi * y / h) * g  # red
    b = 0.12 * np.cos(2 * np.pi * y / h + 0.3) * np.sin(np.pi * x / w) * g  # blue
    green = g - (9798 * a + 3735 * b) / 19235
    return np.rint(np.stack([g + b, green, g + a], -1)).clip(0, 255).astype(np.uint8)


def write_dataset(root, n_frames: int, seed=0, kind="lateral", dist=(-0.05, 0.01, 0.0, 0.0, 0.0),
                  K_mat=None, size=None, n_short=12, fps=10.0, fmt="png", quality=90):
    """The text world rendered to disk in the reference's dataset layout
    (tests/test_cli_e2e.py's fixture): DISTORTED frames as PNG (all five
    row filters; fmt="jpg": the frame in color, tint_bgr, as a baseline
    4:2:0 JPEG at `quality`, encode_jpeg) under images/, the ground-truth detections as
    text/<stem>_dete.txt / _mean.txt (frame 5 adds a CJK and a "#" probe
    line), Imlist.txt (every frame) and Imshort.txt (the first n_short), and
    the yamls: exp0 (Imlist) and exp1-3 (Imshort), scene-only nt_full /
    nt_short, text-on t_short. Returns (ground-truth Tcw [N, 7], world, the
    uint8 frames encoded: [H, W] gray PNG, [H, W, 3] BGR JPEG)."""
    import os

    Km = K if K_mat is None else K_mat
    world = TextWorld(seed=seed)
    poses = camera_path(n_frames, kind)
    rays = distorted_rays(dist, Km, size)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "text"), exist_ok=True)
    lines, written = [], []
    for i, p in enumerate(poses):
        name = f"images/{i:04d}.{fmt}"
        img = render_distorted(world, p, rays, Km).clip(0, 255).astype(np.uint8)
        if fmt == "jpg":
            img = tint_bgr(img)
        written.append(img)
        with open(os.path.join(root, name), "wb") as f:
            f.write(encode_png(img) if fmt == "png" else encode_jpeg(img, quality, "420"))
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


# a TextSLAM's state, field by field, for comparing a resumed system with the
# uninterrupted one (tests/test_torch_checkpoint.py, chip_resume_diff.py)
_STATE_OWNERS = ("map", "tracker", "tracker.text_frontend", "loop_closer")
# attributes that hold a link to another owner, the config, a device or a
# hook, not state
_STATE_LINKS = frozenset({"cfg", "map", "tracker", "text_frontend", "loop_closer", "device",
                          "pyr_device", "mesh", "_covis_mesh", "loop_hook",
                          "pt_candidate_hook", "pool_mask_hook"})


def _state_leaves(prefix: str, v, out: dict, depth: int = 0):
    import dataclasses as dc

    import torch

    if depth > 6:
        out[prefix] = f"<{type(v).__name__}>"
    elif v is None or isinstance(v, (bool, int, float, str, np.generic)):
        out[prefix] = v
    elif isinstance(v, np.ndarray):
        out[prefix] = v.copy()
    elif isinstance(v, torch.Tensor):
        out[prefix] = v.detach().cpu().numpy().copy()
    elif isinstance(v, torch.Generator):
        out[prefix] = v.get_state().numpy().copy()
    elif isinstance(v, (list, tuple)):
        out[prefix + ".len"] = len(v)
        for i, x in enumerate(v):
            _state_leaves(f"{prefix}[{i}]", x, out, depth + 1)
    elif isinstance(v, dict):
        out[prefix + ".keys"] = repr(list(v.keys()))
        for k, x in v.items():
            _state_leaves(f"{prefix}[{k!r}]", x, out, depth + 1)
    elif dc.is_dataclass(v) or hasattr(v, "__dict__"):
        if callable(v) and not dc.is_dataclass(v):
            return
        for k, x in vars(v).items():
            if k not in _STATE_LINKS and not callable(x):
                _state_leaves(f"{prefix}.{k}", x, out, depth + 1)
    else:
        out[prefix] = f"<{type(v).__name__}>"


def system_state(slam) -> dict:
    """Every field of a TextSLAM's map, tracker, text frontend and loop
    closer (and its frame count) as a flat dict name -> value: arrays and
    tensors as numpy copies, generators as their state, lists, dicts and
    records (keyframes, frames, detections) expanded by index or key, with
    each dict's key order recorded as `<name>.keys`. Links between the
    owners, the config, devices and hooks are left out."""
    out = {"frame_count": slam.frame_count}
    for name in _STATE_OWNERS:
        obj = slam
        for part in name.split("."):
            obj = getattr(obj, part)
        if obj is not None:
            _state_leaves(name, obj, out)
    return out


def state_diff(a: dict, b: dict) -> dict:
    """The fields where two system_state() dicts differ: name -> a short
    description (only in one, shape, dtype, or the count of differing
    elements and their largest absolute difference)."""
    out = {}
    for k in sorted(set(a) | set(b)):
        if k not in b or k not in a:
            out[k] = "only in " + ("the first" if k in a else "the second")
            continue
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            if x.shape != y.shape:
                out[k] = f"shape {x.shape} vs {y.shape}"
            elif x.dtype != y.dtype:
                out[k] = f"dtype {x.dtype} vs {y.dtype}"
            elif not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
                ne = (x != y) & ~((x != x) & (y != y)) if x.dtype.kind == "f" else x != y
                with np.errstate(invalid="ignore"):  # inf - inf where a field holds inf
                    d = (np.abs(x.astype(np.float64) - y.astype(np.float64))[ne].max()
                         if x.dtype.kind in "fiub" else float("nan"))
                out[k] = f"{int(ne.sum())} of {x.size} differ, max |diff| {d:.6g}"
        elif x != y and not (isinstance(x, float) and x != x and y != y):
            out[k] = f"{x!r} vs {y!r}"
    return out


# fields a checkpoint deliberately does not restore, with the reason; a
# field name matching one of these patterns is left out of resume_diff
RESUME_NOT_RESTORED = {
    r"tracker\.init_frame(\.|$)": "the two-view init's pending first frame, read only before "
                                  "the map is initialized",
    r"tracker\.last_frame(\.|$)": "the latest Frame record, written every frame and read by "
                                  "nothing",
    r"tracker\.prev_pose$": "overwritten by last_pose before the velocity reads it",
    r"tracker\.text_frontend\._pool_dev_cache(\.|\[|$)": "a cache of the text pool's device "
                                                         "copies, keyed by _pool_version",
    r"tracker\.text_frontend\._pool_version$": "the pool cache's key, bumped on a load",
    r"tracker\.text_frontend\._klt\.keys$": "the KLT accumulator's key order",
    r"map\._pyr_lru(\.|\[|$)": "device uploads of evicted keyframes' pyramids, refilled on use",
    r"map\.keyframes\[\d+\]\.pyr_dev$": "the device copy of a keyframe's host pyramid "
                                        "(pyr_data), resident again for the last "
                                        "ba_window + 8 keyframes after a load",
}


def resume_diff(live: dict, resumed: dict) -> dict:
    """state_diff of two system_state() dicts without the fields a checkpoint
    deliberately does not restore (RESUME_NOT_RESTORED)."""
    import re

    skip = [re.compile(p) for p in RESUME_NOT_RESTORED]
    return {k: v for k, v in state_diff(live, resumed).items()
            if not any(p.match(k) for p in skip)}

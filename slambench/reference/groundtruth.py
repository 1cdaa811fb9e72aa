"""Ground truth of the rendered walk and the accuracy numbers held to it, in
numpy: the Sim3-aligned ATE of camera centres (Horn's closed form, the
evo_ape -s protocol) and the ground-truth plane of a wall in a camera.

A frozen copy of the port's test helpers (`ate_rmse`, `_horn_alignment`,
`plane_theta_in_cam`); it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def qto_matrix(q: np.ndarray) -> np.ndarray:
    """[..., 4] (w x y z) -> [..., 3, 3] rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def camera_centres(poses_cw: np.ndarray) -> np.ndarray:
    """Camera centres in the world, -R^T t, of Tcw poses [N, 7]."""
    p = np.asarray(poses_cw, np.float64)
    R = qto_matrix(p[:, :4] / np.linalg.norm(p[:, :4], axis=-1, keepdims=True))
    return -np.einsum("nji,nj->ni", R, p[:, 4:])


def horn_alignment(P1: np.ndarray, P2: np.ndarray) -> tuple:
    """(s, R, t) minimizing ||P1 - (s R P2 + t)||, in float64."""
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
    R = qto_matrix(q / np.linalg.norm(q))
    RX2 = X2 @ R.T
    s = (X1 * RX2).sum() / max((RX2 * RX2).sum(), 1e-12)
    return s, R, c1 - s * (R @ c2)


def ate_rmse(frame_ids, est_poses_cw, gt_poses_cw) -> float:
    """Sim3-aligned RMSE of camera centres; frame_ids index gt_poses_cw."""
    est_C = camera_centres(est_poses_cw)
    gt_C = camera_centres(np.asarray(gt_poses_cw)[np.asarray(frame_ids, np.int64)])
    s, R, t = horn_alignment(gt_C, est_C)
    aligned = s * est_C @ R.T + t
    return float(np.sqrt((np.linalg.norm(aligned - gt_C, axis=-1) ** 2).mean()))


def plane_theta_in_cam(z0: float, pose_cw: np.ndarray) -> np.ndarray:
    """theta of the world plane z = z0 in a camera (theta^T p + 1 = 0 for
    points p in camera coordinates)."""
    p = np.asarray(pose_cw, np.float64)
    R = qto_matrix(p[:4] / np.linalg.norm(p[:4]))
    n_c = R @ np.array([0.0, 0.0, 1.0])
    d_c = np.array([0.0, 0.0, 1.0]) @ (-R.T @ p[4:]) - z0
    return n_c / d_c


def plane_errors(objects, walls, gt_poses_cw) -> list:
    """1 - |cos| between each text object's plane normal and its wall's, in
    the object's host camera. objects: (theta [3], host frame id, wall)."""
    out = []
    for theta, host_frame, wall in objects:
        gt = plane_theta_in_cam(walls[wall][2], gt_poses_cw[host_frame])
        th = np.asarray(theta, np.float64)
        cos = abs(th @ gt) / (np.linalg.norm(th) * np.linalg.norm(gt) + 1e-300)
        out.append(float(1.0 - cos))
    return out

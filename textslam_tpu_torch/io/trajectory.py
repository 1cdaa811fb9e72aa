"""TUM-format trajectory output (keyframe_latest.txt / keyframe.txt).

Reference: RecordKeyFrame_latest rewrites the full keyframe trajectory after
every KF insertion (crash-durable output, src/tracking.cc:2564-2586); final
RecordKeyFrame writes keyframe.txt (:2588-2635). Format per line:
`timestamp tx ty tz qx qy qz qw` — note the pose written is Twc (camera in
world), i.e. the inverse of the tracked Tcw.
"""

from __future__ import annotations

import numpy as np

from ..geometry import se3_np


def tum_lines(timestamps, poses_cw) -> str:
    """Format poses (Tcw, [N, 7] wxyz+t) as TUM lines (Twc, xyzw quat order)."""
    out = []
    T = np.asarray(poses_cw, np.float32)
    Twc = se3_np.inverse(T)
    for ts, p in zip(timestamps, Twc):
        qw, qx, qy, qz, tx, ty, tz = p
        out.append(f"{ts:.6f} {tx:.7f} {ty:.7f} {tz:.7f} {qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}")
    return "\n".join(out) + ("\n" if out else "")


def write_tum(path: str, timestamps, poses_cw):
    """Atomic truncate-rewrite, matching the reference's crash durability."""
    with open(path, "w") as f:
        f.write(tum_lines(timestamps, poses_cw))


def read_tum(path: str):
    """Read a TUM trajectory -> (timestamps [N], poses_wc [N, 7] wxyz+t)."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            ts.append(vals[0])
            tx, ty, tz, qx, qy, qz, qw = vals[1:8]
            poses.append([qw, qx, qy, qz, tx, ty, tz])
    return np.asarray(ts), np.asarray(poses, np.float32)

"""Per-frame construction: ORB keypoints, port of
textslam_tpu/frontend/frame.py (scene-only: the direct-alignment pyramid and
text detections arrive with the text slice).

The keypoints of a frame stay on the device as one packed [N, 14] float32
pool (ops.orb.pack_keypoints); the host mirror (numpy, descriptors as
uint32) materializes once, on first access, through ensure_host_kp — only
keyframes and the initializer need it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import TextSLAMConfig
from ..ops import orb


@dataclasses.dataclass
class Frame:
    frame_id: int
    timestamp: float
    shape: tuple  # (H, W)
    # host keypoint mirror (lazy when kp_packed_dev is set)
    kp_uv: Optional[np.ndarray] = None
    kp_level: Optional[np.ndarray] = None
    kp_angle: Optional[np.ndarray] = None
    kp_desc: Optional[np.ndarray] = None  # [N, 8] uint32
    kp_valid: Optional[np.ndarray] = None
    # packed [N, 14] device keypoint pool (ops.orb.pack_keypoints layout)
    kp_packed_dev: Optional[torch.Tensor] = None
    pose: Optional[np.ndarray] = None  # [7] Tcw once tracked

    @property
    def n_valid(self) -> int:
        ensure_host_kp(self)
        return int(self.kp_valid.sum())


def ensure_host_kp(frame) -> None:
    """Materialize (once) the host keypoint mirror from the packed device
    pool: one readback; no-op when the mirror already exists."""
    if frame.kp_uv is not None or getattr(frame, "kp_packed_dev", None) is None:
        return
    from ..utils.profiling import phase

    with phase("frame.kp_pull"):
        packed = frame.kp_packed_dev.cpu().numpy()
    uv, level, angle, _, valid, desc = orb.unpack_keypoints_np(packed)
    frame.kp_uv = uv
    frame.kp_level = level
    frame.kp_angle = angle
    frame.kp_desc = desc
    frame.kp_valid = valid


def packed_kp_dev(frame, device) -> torch.Tensor:
    """The packed [N, 14] device keypoint pool of a Frame, building it from
    the host mirror when the frame was not device-built (tests, replays)."""
    if getattr(frame, "kp_packed_dev", None) is not None:
        return frame.kp_packed_dev
    n = frame.kp_uv.shape[0]
    kp = orb.Keypoints(
        uv=torch.as_tensor(frame.kp_uv, dtype=torch.float32, device=device),
        uv_level=torch.zeros((n, 2), device=device),
        level=torch.as_tensor(frame.kp_level, dtype=torch.int32, device=device),
        angle=torch.as_tensor(frame.kp_angle, dtype=torch.float32, device=device),
        score=torch.zeros(n, device=device),
        desc=desc_to_dev(frame.kp_desc, device),
        valid=torch.as_tensor(frame.kp_valid, dtype=torch.bool, device=device),
    )
    frame.kp_packed_dev = orb.pack_keypoints(kp)
    return frame.kp_packed_dev


def desc_to_dev(desc: np.ndarray, device) -> torch.Tensor:
    """Host uint32 descriptor words [N, 8] -> device int32 bits [N, 8]."""
    d = np.ascontiguousarray(desc, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(d.copy()).to(device)


def build_frame(
    cfg: TextSLAMConfig,
    img: np.ndarray,
    frame_id: int,
    timestamp: float,
    n_features: Optional[int] = None,
    device="cpu",
) -> Frame:
    """Construct a Frame from an undistorted grayscale image (float32 [H,W])."""
    from ..utils.profiling import phase

    imt = torch.as_tensor(np.asarray(img, np.float32), device=device)
    with phase("frame.orb"):
        kp = orb.extract_orb(
            imt,
            n_features=n_features or cfg.orb.n_features,
            n_levels=cfg.orb.n_levels,
            scale=cfg.orb.scale_factor,
            threshold=float(cfg.orb.fast_threshold_min),
        )
    return Frame(
        frame_id=frame_id,
        timestamp=timestamp,
        shape=img.shape,
        kp_packed_dev=orb.pack_keypoints(kp),
    )

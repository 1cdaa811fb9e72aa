"""System façade: the `TextSLAM` object a user drives frame by frame.

Port of textslam_tpu/system.py for the scene-only slice (`Exp noText`):
construct map + tracker on an explicit device, feed frames, write TUM
output. With noText the JAX package builds its loop closer but never runs
it; this port leaves it out until loop closing is ported.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .config import TextSLAMConfig
from .mapper.state import SlamMap
from .frontend.frame import build_frame
from .frontend.tracking import Tracker, OK
from .io import trajectory


class TextSLAM:
    def __init__(self, cfg: TextSLAMConfig, output_dir: Optional[str] = None, device="cuda"):
        if not cfg.no_text:
            raise NotImplementedError(
                "textslam_tpu_torch runs the scene-only pipeline (no_text=True); "
                "the text pipeline is not ported yet")
        if cfg.parallel.ba_devices > 1 or cfg.parallel.covis_devices > 1:
            raise NotImplementedError("multi-device BA / covisibility is not ported yet")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TextSLAM(device={device!r}) needs a CUDA GPU and none is available")
        self.cfg = cfg
        self.map = SlamMap(cfg)
        self.tracker = Tracker(cfg, self.map, device=self.device)
        self.output_dir = output_dir
        self.frame_count = 0
        self.tracker.loop_hook = self._on_keyframe

    def _on_keyframe(self, kid: int):
        if self.output_dir:
            self.record_keyframes(os.path.join(self.output_dir, "keyframe_latest.txt"))

    def track_monocular(self, image: np.ndarray, timestamp: float) -> Optional[np.ndarray]:
        """Track one undistorted grayscale frame; returns Tcw [7] or None."""
        from .utils.profiling import phase

        with phase("frame.build"):
            frame = build_frame(
                self.cfg,
                image,
                frame_id=self.frame_count,
                timestamp=timestamp,
                n_features=(
                    self.cfg.orb.n_features_init
                    if self.tracker.state != OK
                    else self.cfg.orb.n_features
                ),
                device=self.device,
            )
        self.frame_count += 1
        ok = self.tracker.process(frame)
        return frame.pose if ok else None

    def record_keyframes(self, path: str):
        """Write the keyframe trajectory in TUM format."""
        kfs = self.map.keyframes
        ts = [kf.timestamp for kf in kfs]
        poses = np.stack([self.map.kf_pose[kf.kid] for kf in kfs]) if kfs else np.zeros((0, 7))
        trajectory.write_tum(path, ts, poses)

    def record_frames(self, path: str):
        """Write the full per-frame trajectory."""
        traj = self.tracker.trajectory
        ts = [t for t, _ in traj]
        poses = np.stack([p for _, p in traj]) if traj else np.zeros((0, 7))
        trajectory.write_tum(path, ts, poses)

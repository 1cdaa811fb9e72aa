"""System façade: the `TextSLAM` object a user drives frame by frame.

Port of textslam_tpu/system.py: construct map + tracker (+ the text frontend
unless `Exp noText`) and the loop closer on an explicit device, feed frames
with their text detections, write TUM output. With text on, the loop closer
runs at every new keyframe (it returns at once below its keyframe gates).
ParallelConfig.ba_devices / covis_devices > 1 put the BA and the
covisibility rebuilds on a device mesh (parallel.mesh.make_mesh).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .config import TextSLAMConfig
from .mapper.state import SlamMap
from .frontend.frame import TextDetection, build_frame, check_device
from .frontend.tracking import Tracker, OK
from .io import trajectory
from .loop.closing import LoopCloser


class TextSLAM:
    def __init__(self, cfg: TextSLAMConfig, output_dir: Optional[str] = None, device="cuda"):
        self.device = check_device(device, "TextSLAM")
        self.cfg = cfg
        self.map = SlamMap(cfg, device=self.device)
        self.tracker = Tracker(cfg, self.map, device=self.device)
        self.output_dir = output_dir
        self.frame_count = 0
        if not cfg.no_text:
            from .frontend.text import TextFrontend

            self.tracker.text_frontend = TextFrontend(cfg, self.map, self.tracker,
                                                      device=self.device)
        self.loop_closer = LoopCloser(cfg, self.map, device=self.device)
        self.loop_closer.tracker = self.tracker
        self.tracker.loop_hook = self._on_keyframe

    def _on_keyframe(self, kid: int):
        if not self.cfg.no_text:
            self.loop_closer.run(kid)
        if self.output_dir:
            self.record_keyframes(os.path.join(self.output_dir, "keyframe_latest.txt"))

    def track_monocular(self, image, timestamp: float,
                        detections: Optional[List[TextDetection]] = None) -> Optional[np.ndarray]:
        """Track one undistorted grayscale frame (float32 [H, W], numpy or a
        tensor on the system's device) with its text detections; returns
        Tcw [7] or None."""
        from .utils.profiling import phase

        with phase("frame.build"):
            frame = build_frame(
                self.cfg,
                image,
                frame_id=self.frame_count,
                timestamp=timestamp,
                detections=detections,
                n_features=(
                    self.cfg.orb.n_features_init
                    if self.tracker.state != OK
                    else self.cfg.orb.n_features
                ),
                with_pyramid=not self.cfg.no_text,
                device=self.device,
            )
        self.frame_count += 1
        ok = self.tracker.process(frame)
        return frame.pose if ok else None

    def save_checkpoint(self, path: str, extra: Optional[dict] = None):
        """Serialize the full resumable state (map, tracker motion state,
        text-frontend reference buffers, loop bookkeeping, the RANSAC
        generators) to the JAX package's npz format (mapper/checkpoint.py)."""
        from .mapper import checkpoint

        ex = {"frame_count": int(self.frame_count),
              "last_loop_kid": int(self.loop_closer.last_loop_kid),
              "closed_loops": [list(p) for p in self.loop_closer.closed_loops]}
        ex.update(extra or {})
        checkpoint.save(path, self.map, tracker=self.tracker,
                        text_frontend=self.tracker.text_frontend, extra=ex,
                        loop_closer=self.loop_closer)

    def load_checkpoint(self, path: str) -> dict:
        """Restore from save_checkpoint (or from the JAX package's); returns
        the stored extra dict. From a JAX-package checkpoint, which does not
        keep them, the KLT tracks of new text restart at the next keyframe
        and the text frontend's row count and maturation cursor at 0."""
        from .mapper import checkpoint

        self.map, ex = checkpoint.load(path, self.cfg, tracker=self.tracker,
                                       text_frontend=self.tracker.text_frontend,
                                       loop_closer=self.loop_closer, device=self.device)
        self.tracker.map = self.map
        self.loop_closer.map = self.map
        if self.tracker.text_frontend is not None:
            self.tracker.text_frontend.map = self.map
        self.frame_count = int(ex.get("frame_count", 0))
        self.loop_closer.last_loop_kid = int(
            ex.get("last_loop_kid", self.loop_closer.last_loop_kid))
        self.loop_closer.closed_loops = [tuple(p) for p in ex.get("closed_loops", [])]
        return ex

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

"""Command-line entry point of the port:

    python -m textslam_tpu_torch.cli <config>.yaml [output_dir]
        [--checkpoint-every N] [--resume] [--device cuda]

Mirrors the JAX package's main.py and the reference binary (`./TextSLAM
<cfg>.yaml`, main.cpp:30-98): load the experiment yaml, iterate the image
list, feed each frame with its precomputed text detections to the system,
write `keyframe_latest.txt` after every keyframe, and `keyframe.txt` and
`pose_F.txt` at the end (TUM format).

Beyond the reference:
  --checkpoint-every N   save a resumable checkpoint every N frames
                         (<output_dir>/checkpoint.npz, written aside and
                         renamed over the previous one)
  --resume               continue from that checkpoint if present
  --device               where the system runs (default cuda; there is no
                         fallback to the CPU)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch


class _Marks:
    """Time marks on `device` without a sync per mark: CUDA events on the
    GPU, read once at the end; the host clock elsewhere."""

    def __init__(self, device):
        self._cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, a, b) -> float:
        """Milliseconds from mark a to mark b (after the last mark ran)."""
        if self._cuda:
            self.marks[-1].synchronize()
            return self.marks[a].elapsed_time(self.marks[b])
        return (self.marks[b] - self.marks[a]) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m textslam_tpu_torch.cli",
        description="TextSLAM on PyTorch/CUDA (reference: ./TextSLAM <cfg>.yaml)")
    ap.add_argument("config", help="experiment yaml")
    ap.add_argument("output_dir", nargs="?", default=".")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="save a resumable checkpoint every N frames")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <output_dir>/checkpoint.npz if present")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from .config import MapConfig, load_yaml
    from .io.dataset import Dataset
    from .system import TextSLAM

    cfg = load_yaml(args.config)
    out_dir = args.output_dir
    os.makedirs(out_dir, exist_ok=True)
    ckpt_path = os.path.join(out_dir, "checkpoint.npz")

    with Dataset(cfg, device=args.device) as ds:
        # pool caps from the image-list length (the reference's param_M rule,
        # src/system.cc:23-29)
        cfg = dataclasses.replace(
            cfg, map=MapConfig.derive(len(ds), cfg.camera.fps, cfg.map))
        print(f"[cfg] pools from {len(ds)} images @ {cfg.camera.fps:.0f} fps: "
              f"kfs={cfg.map.max_keyframes} pts={cfg.map.max_points} "
              f"texts={cfg.map.max_texts}")
        slam = TextSLAM(cfg, output_dir=out_dir, device=args.device)
        start = 0
        if args.resume and os.path.exists(ckpt_path):
            extra = slam.load_checkpoint(ckpt_path)
            start = int(extra.get("frame_index", -1)) + 1
            print(f"[resume] checkpoint at frame {start - 1}: "
                  f"kfs={len(slam.map.keyframes)} pts={slam.map.n_points} "
                  f"texts={slam.map.n_texts}; continuing at frame {start}")
        t0 = time.time()
        # per frame: before the upload, after the undistortion, after tracking
        marks = _Marks(slam.device)
        for i in range(start, len(ds)):
            samples, ts, dets = ds.read(i)
            marks.mark()
            img = ds.image(samples)
            marks.mark()
            slam.track_monocular(img, ts, detections=dets)
            marks.mark()
            if i % 500 == 0:
                print(f"[{i}/{len(ds)}] kfs={len(slam.map.keyframes)} "
                      f"pts={slam.map.n_points} texts={slam.map.n_texts}")
            if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
                # atomic: write aside, rename over (a crash mid-save keeps the
                # previous checkpoint usable)
                tmp = ckpt_path + ".tmp.npz"
                slam.save_checkpoint(tmp, extra={"frame_index": i})
                os.replace(tmp, ckpt_path)
        slam.record_keyframes(os.path.join(out_dir, "keyframe.txt"))
        slam.record_frames(os.path.join(out_dir, "pose_F.txt"))
        dt = time.time() - t0
        n_done = len(ds) - start

        def med(xs):
            return f"{np.median(xs):.1f}" if xs else "-"

        undistort_ms = [marks.ms(j, j + 1) for j in range(0, len(marks.marks), 3)]
        track_ms = [marks.ms(j + 1, j + 2) for j in range(0, len(marks.marks), 3)]
        print(f"done: {n_done} frames in {dt:.1f}s ({n_done / max(dt, 1e-9):.2f} fps); "
              f"median ms per frame: read+decode {med(ds.read_ms)} (host thread), "
              f"undistort {med(undistort_ms)}, track {med(track_ms)} [{slam.device}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A resumed TextSLAM against the uninterrupted one, field by field: the
checkpoint study of the long regime's amnesia run.

    python3 chip_resume_diff.py [--save-at 100] [--stop 125] [--out F.json]
    python3 chip_resume_diff.py --device cpu --small --frames 40 --save-at 20 --stop 26

Runs chip_smoke.py phase 10(b)'s amnesia run (the `outback2` text world,
seed 3, 3 boxes per plane, pools derived for --frames frames, fps 10,
global_decompose_kfs 16, tests/test_e2e_loop.py's amnesia from frame
frames/2 on, forgetting the landmarks of the keyframes made before frame
frames/4) in system A up to frame --save-at, saves A's checkpoint there and
loads it into a fresh system B (with the amnesia hooks and the keyframe
count they read at frame frames/4). Then it feeds every later frame up to
--stop to both. It prints the fields of the two systems that differ
(tests/torch_synth.system_state / resume_diff: every field but those listed
in torch_synth.RESUME_NOT_RESTORED) just after the load and after
each of the next --diff-frames frames, and, for every frame, the largest
difference of the two trajectories' poses; at the end each system's loops,
keyframes, online and keyframe ATE. --out keeps it all as JSON.

Exits non-zero without a CUDA device unless --device cpu. Imports neither
jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]

import chip_smoke  # noqa: E402  (the long regime's world, config and amnesia hooks)


def _summary(slam, gt) -> dict:
    import numpy as np
    import torch_synth

    m, traj = slam.map, slam.tracker.trajectory
    kfs = m.keyframes
    return {
        "keyframes": len(kfs), "texts": int(m.n_texts), "points": int(m.n_points),
        "loops": [list(x) for x in slam.loop_closer.closed_loops],
        "ate": torch_synth.ate_rmse([t for t, _ in traj], np.stack([p for _, p in traj]), gt),
        "kf_ate": torch_synth.ate_rmse([kf.timestamp for kf in kfs],
                                       np.stack([m.kf_pose[kf.kid] for kf in kfs]), gt),
    }


def main() -> int:
    import numpy as np
    import torch
    import torch_synth
    from textslam_tpu_torch.system import TextSLAM

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=chip_smoke.LONG_FRAMES,
                    help="the sequence the fixture and its pools are made for")
    ap.add_argument("--save-at", type=int, default=chip_smoke.LONG_FRAMES // 2)
    ap.add_argument("--stop", type=int, default=chip_smoke.LONG_AMNESIA_STOP)
    ap.add_argument("--diff-frames", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="320x240, 500 / 1500 ORB features")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device (use --device cpu for a rehearsal)", file=sys.stderr)
        return 2
    card = chip_smoke.card_line() if args.device.startswith("cuda") else "cpu"
    print(card, flush=True)

    n = args.frames
    forget, start = n // 4, n // 2
    spec = chip_smoke.world_spec("outback2", n, small=args.small, boxes_per_plane=3)
    _, gt, _ = chip_smoke.make_world(spec)
    cfg = chip_smoke.long_config(n, small=args.small, decompose_kfs=chip_smoke.LONG_DECOMPOSE_KFS)
    a = TextSLAM(cfg, device=args.device)
    track_a = chip_smoke.amnesia_track(a, forget, start)
    b = track_b = None
    out = {"card": card, "args": vars(args), "diffs": {}, "pose_diff": {}}

    def diff(label):
        d = torch_synth.resume_diff(torch_synth.system_state(a), torch_synth.system_state(b))
        out["diffs"][label] = d
        print(f"[diff] {label}: {len(d)} fields differ", flush=True)
        for k, v in list(d.items())[:80]:
            print(f"    {k}: {v}")

    with tempfile.TemporaryDirectory() as tmp:
        for i, (img, dets) in enumerate(chip_smoke.frame_stream(spec, args.stop)):
            if i == args.save_at:
                path = os.path.join(tmp, "ckpt.npz")
                a.save_checkpoint(path, extra={"amnesia_quarter": track_a.amnesia["quarter"]})
                b = TextSLAM(cfg, device=args.device)
                ex = b.load_checkpoint(path)
                track_b = chip_smoke.amnesia_track(b, forget, start, quarter=ex["amnesia_quarter"])
                diff(f"after the load at frame {i}")
            track_a(img, float(i), detections=dets)
            if b is None:
                continue
            track_b(img, float(i), detections=dets)
            pa, pb = a.tracker.trajectory[-1][1], b.tracker.trajectory[-1][1]
            dp = float(np.abs(pa - pb).max())
            out["pose_diff"][i] = dp
            print(f"[frame {i}] KFs {len(a.map.keyframes)} / {len(b.map.keyframes)}, "
                  f"loops {len(a.loop_closer.closed_loops)} / {len(b.loop_closer.closed_loops)}, "
                  f"max |pose A - pose B| {dp:.6g}", flush=True)
            if i < args.save_at + args.diff_frames:
                diff(f"after frame {i}")
    out["uninterrupted"], out["resumed"] = _summary(a, gt), _summary(b, gt)
    print(f"uninterrupted: {out['uninterrupted']}\nresumed: {out['resumed']}  [{card}]")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())

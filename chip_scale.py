#!/usr/bin/env python3
"""The port's long-sequence regime on one GPU, without the smoke checks:
the counterpart of bench_scale.py, a study script.

    python3 chip_scale.py [--frames 1000] [--kind outback2|ring|ring_drift] [--out F.json]
    python3 chip_scale.py --device cpu --small --frames 40   # 320x240 rehearsal

Runs TextSLAM(TextSLAMConfig(), device=...) with text on over a long
rendered sequence (tests/torch_synth.py) at 640x480 (--small: 320x240 with
500 / 1500 ORB features), with the pools derived from the sequence length
(MapConfig.derive, as the CLI sizes them) at fps 10:

- outback2: the text world (seed 3, 4 boxes per plane) on two out-and-back
  excursions, so loop closures fire (bench_scale.py's default);
- ring: ring_world (seed 3), one and a bit laps of a circuit whose walls
  leave the view mid-lap;
- ring_drift: the ring with smaller boxes and a degraded mid-lap stretch
  (darkened, blurred, noisy; no detections at strength >= 0.3; the true
  focal length ramped up to +4% under the nominal calibration), so the
  revisit carries real drift (bench_scale.py's fixture; the noise is drawn
  per frame from seed [9, frame]).

The frames are rendered by a pool of spawned processes a bounded window
ahead of the tracker, so the main process holds only the frames in flight.
Every `--every` frames (100 by default) it prints one snapshot: the
block's median per-frame and keyframe-insertion ms (synchronized host
clock) and its host time by phase (utils/profiling), map counts,
saturation drops, loops, each closure's ms with its keyframe count and
whether it took the decomposed landmark pass, how often the local-map
narrowing ran, host RSS, SlamMap.host_bytes, and device memory
(torch.cuda.memory_allocated / max_memory_allocated). At the end: one JSON
line (online-trajectory ATE, keyframe ATE, drift before the seam and at the
end for the ring kinds, the snapshots). The worlds, the render pool and
run_long are chip_smoke.py's, whose phase 10(b) runs them with its checks
and holds the rehearsal to its bars.

Exits non-zero without a CUDA device unless --device cpu. Imports neither
jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]

import chip_smoke  # noqa: E402  (run_long, its worlds and the card line)


def drift_at(est_ts, est, gt, frac: float) -> float:
    """bench_scale.py's drift reading: the first stretch of the online
    trajectory's camera centres (80 frames or a third) Sim3-aligned to the
    ground truth, then the aligned position error at `frac` of the run."""
    import numpy as np
    import torch_synth
    from textslam_tpu_torch.geometry import se3_np

    est_c = se3_np.inverse(np.asarray(est, np.float32))[:, 4:7].astype(np.float64)
    gt_c = se3_np.inverse(np.asarray(gt[[int(round(t)) for t in est_ts]], np.float32))[
        :, 4:7].astype(np.float64)
    n_fit = min(80, len(est) // 3)
    s, R, t = torch_synth._horn_alignment(gt_c[:n_fit], est_c[:n_fit])
    al = s * est_c @ R.T + t
    i = min(int(frac * len(est)), len(est) - 1)
    return float(np.linalg.norm(al[i] - gt_c[i]))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--kind", choices=chip_smoke.LONG_KINDS, default="outback2")
    ap.add_argument("--every", type=int, default=100, help="frames per snapshot")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="320x240, 500 / 1500 ORB features")
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("chip_scale: no CUDA device", file=sys.stderr)
        return 2
    rss_import = chip_smoke.host_rss_mb()
    from textslam_tpu_torch.system import TextSLAM

    card = chip_smoke.card_line() if dev.type == "cuda" else f"CPU ({os.cpu_count()} cores)"
    print(card)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
    print(f"[scale] host RSS {rss_import:.1f} MB with torch imported, "
          f"{chip_smoke.host_rss_mb():.1f} MB with the device's context up", flush=True)
    spec = chip_smoke.world_spec(args.kind, args.frames, small=args.small)
    world, gt, _ = chip_smoke.make_world(spec)
    cfg = chip_smoke.long_config(args.frames, small=args.small)
    print(f"[scale] {args.frames} frames of {args.kind}; derived pools: keyframes "
          f"{cfg.map.max_keyframes}, points {cfg.map.max_points}, texts {cfg.map.max_texts}; "
          f"global_decompose_kfs {cfg.solver.global_decompose_kfs}", flush=True)
    slam = TextSLAM(cfg, device=dev)

    def census():
        n_good, cosines, failed = chip_smoke.text_planes(slam, gt, world)
        return (f"GOOD {n_good}: {chip_smoke._planes_line(cosines)}; outside the text bars: "
                f"{failed}")

    res = chip_smoke.run_long(slam, chip_smoke.frame_stream(spec), gt, args.every, card,
                              census=census, log=lambda s: print(s, flush=True))
    ts, est = res.pop("trajectory_ts"), res.pop("trajectory")
    if args.kind != "outback2":
        res["drift_pre_seam_m"] = drift_at(ts, est, gt, 0.82)
        res["drift_final_m"] = drift_at(ts, est, gt, 1.0)
    res.update(kind=args.kind, small=args.small, card=card,
               device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    print(f"[scale] {args.kind} {res['frames']} frames in {res['wall_s']:.1f} s: "
          f"{res['tracked']} tracked, {res['keyframes']} KFs (cap {res['kf_pool_cap']}), "
          f"{res['points']} points, {res['texts']} texts, drops {res['saturation_drops']}, "
          f"loops {res['loops']}, online ATE {res['ate']:.6f}, KF ATE {res['kf_ate']:.6f}; "
          f"closures (K, ms, decomposed) "
          f"{[(c['K'], round(c['ms'], 1), c['decomposed']) for c in res['closures']]}  [{card}]")
    line = json.dumps({"scale": res})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

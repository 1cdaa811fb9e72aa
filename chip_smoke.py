#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (textslam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
1. require a CUDA device; print the card's name and power limit
   (nvidia-smi);
2. build csrc/hamming.cu from this checkout (nvcc) and print the build time;
3. hold the Hamming kernel against its plain PyTorch version on random
   descriptors at the main path's shapes — exact equality — and time both
   with CUDA events;
4. render a 640x480 plane-world sequence (tests/torch_synth.py, numpy only);
5. run TextSLAM(cfg, device="cuda") with no_text=True over it, at the full
   ORB / map / BA-window configuration, and check the tracker state, the
   keyframe and point counts, ATE against ground truth, that the Hamming
   kernel was launched during the run, and that the map and solver tensors
   lay on the GPU;
6. print per-frame and keyframe-insertion times, one JSON line describing
   the kernel, and last the JSON result line.

Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N_FRAMES = 40
# Hamming shapes on the main path: tracked frames [P, 1000] for point pools
# of 4096..32768, two-view init [3000, 3000], keyframe triangulation
# [1000, 1000], and a ragged shape that exercises the edge masking
HAMMING_SHAPES = [(4096, 1000), (32768, 1000), (3000, 3000), (1000, 1000), (1001, 999)]
KF_ATE_MAX = 0.012  # the bounds tests/test_e2e_scene.py holds the JAX package to
FRAME_ATE_MAX = 0.025


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_hamming(matching, card: str):
    """Kernel vs plain version at every path shape; exact equality."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for n1, n2 in HAMMING_SHAPES:
        d1 = torch.randint(-2**31, 2**31 - 1, (n1, 8), dtype=torch.int32, device="cuda",
                           generator=gen)
        d2 = torch.randint(-2**31, 2**31 - 1, (n2, 8), dtype=torch.int32, device="cuda",
                           generator=gen)
        got = matching.hamming_matrix(d1, d2)
        want = matching.hamming_matrix_plain(d1, d2)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        check(torch.equal(got, want), f"hamming kernel != plain at {n1}x{n2} (max err {err})")
        check(int(want.min()) >= 0 and int(want.max()) <= 256, "plain hamming out of range")
        ms = time_ms(lambda: matching.hamming_matrix(d1, d2), iters=20)
        plain_ms = time_ms(lambda: matching.hamming_matrix_plain(d1, d2), iters=5)
        rows.append({"shape": [n1, n2], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        print(f"hamming {n1}x{n2}: equal, max_abs_err {err}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms  [{card}]")
    return rows


def run_slam(frames, gt, card: str):
    """The port's main path on the GPU, with the checks of phase 5."""
    import numpy as np
    import torch
    import torch_synth
    from textslam_tpu_torch.config import CameraConfig, TextSLAMConfig
    from textslam_tpu_torch.frontend import tracking
    from textslam_tpu_torch.ops import matching
    from textslam_tpu_torch.solver import ba
    from textslam_tpu_torch.system import TextSLAM

    # record the devices of every tensor entering / leaving the per-frame
    # track step and the BA solver (the map's device-side columns and the
    # solver state)
    devices = set()

    def watch(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            for x in list(args) + list(kw.values()) + [out]:
                for t in (x if isinstance(x, tuple) else (x,)):
                    if isinstance(t, torch.Tensor):
                        devices.add(t.device.type)
            return out
        return wrapped

    tracking.fused_track_step = watch(tracking.fused_track_step)
    ba.solve_ba = watch(ba.solve_ba)

    cfg = TextSLAMConfig(
        no_text=True,
        camera=CameraConfig(fx=torch_synth.FX, fy=torch_synth.FY, cx=torch_synth.CX,
                            cy=torch_synth.CY, width=torch_synth.W, height=torch_synth.H,
                            fps=10.0),
    )
    slam = TextSLAM(cfg, device="cuda")
    matching.hamming_matrix.launches = 0  # count only the main path's launches
    # frames before tracking starts (init candidates, two-view init) are
    # timed apart from steady tracked frames and keyframe insertions
    init_ms, frame_ms, kf_ms, n_ok = [], [], [], 0
    for i, img in enumerate(frames):
        n_kf = len(slam.map.keyframes)
        tracking_before = slam.tracker.state == 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pose = slam.track_monocular(img, float(i))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        n_ok += pose is not None
        if not tracking_before:
            init_ms.append(dt)
        else:
            (kf_ms if len(slam.map.keyframes) > n_kf else frame_ms).append(dt)
    launches = matching.hamming_matrix.launches

    check(slam.tracker.state == 1, "tracker not OK at the end of the sequence")
    check(n_ok >= len(frames) - 5, f"only {n_ok}/{len(frames)} frames tracked")
    check(len(slam.map.keyframes) >= 3, f"{len(slam.map.keyframes)} keyframes")
    check(slam.map.n_points > 100, f"{slam.map.n_points} map points")
    kfs = slam.map.keyframes
    kposes = np.stack([slam.map.kf_pose[kf.kid] for kf in kfs])
    check(np.isfinite(kposes).all(), "non-finite keyframe pose")
    kf_ate = torch_synth.ate_rmse([kf.timestamp for kf in kfs], kposes, gt)
    traj = slam.tracker.trajectory
    frame_ate = torch_synth.ate_rmse([t for t, _ in traj], np.stack([p for _, p in traj]), gt)
    check(launches > 0, "the main path never launched the Hamming kernel")
    check(devices == {"cuda"}, f"track-step / solver tensors on {sorted(devices)}")
    check(kf_ate < KF_ATE_MAX, f"keyframe ATE {kf_ate} >= {KF_ATE_MAX}")
    check(frame_ate < FRAME_ATE_MAX, f"frame ATE {frame_ate} >= {FRAME_ATE_MAX}")

    from textslam_tpu_torch.utils.profiling import report

    print(report())
    res = {
        "frames": len(frames), "tracked": n_ok, "keyframes": len(kfs),
        "points": int(slam.map.n_points), "kf_ate": kf_ate, "frame_ate": frame_ate,
        "hamming_launches": launches, "tensor_devices": sorted(devices),
        "frame_ms_median": float(np.median(frame_ms)),
        "frame_ms_p90": float(np.percentile(frame_ms, 90)),
        "kf_insert_ms_median": float(np.median(kf_ms)),
    }
    print(f"init ms: {init_ms}")
    print(f"frame ms: {frame_ms}")
    print(f"KF insertion ms: {kf_ms}")
    print(f"slam: {n_ok}/{len(frames)} tracked, {len(kfs)} KFs, {slam.map.n_points} points, "
          f"KF ATE {kf_ate:.6f}, frame ATE {frame_ate:.6f}, hamming launches {launches}")
    print(f"per-frame ms: median {res['frame_ms_median']:.3f}, p90 {res['frame_ms_p90']:.3f}; "
          f"KF insertion ms: median {res['kf_insert_ms_median']:.3f} "
          f"over {len(kf_ms)} insertions  [{card}]")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch_synth
    from textslam_tpu_torch.ops import cuda_lib, matching

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = cuda_lib.build("hamming")
    print(f"built {os.path.relpath(lib, root)} in {time.perf_counter() - t0:.2f} s")

    hamming_rows = compare_hamming(matching, card)

    t0 = time.perf_counter()
    frames, gt = torch_synth.render_sequence(N_FRAMES, seed=0, kind="lateral")
    print(f"rendered {len(frames)} frames of {frames[0].shape[1]}x{frames[0].shape[0]} "
          f"in {time.perf_counter() - t0:.1f} s")
    slam = run_slam(frames, gt, card)

    path_row = hamming_rows[0]  # [4096, 1000]: every tracked frame below 4096 points
    kernel = {
        "name": "hamming_matrix", "route": "cuda",
        "source": "textslam_tpu_torch/csrc/hamming.cu",
        "replaces": "textslam_tpu/ops/pallas_kernels.py:52",
        "launches": slam["hamming_launches"], "max_abs_err": path_row["max_abs_err"],
        "ms": path_row["ms"], "plain_ms": path_row["plain_ms"], "shape": path_row["shape"],
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

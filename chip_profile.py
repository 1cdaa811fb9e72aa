#!/usr/bin/env python3
"""Device-time profile of the port's text pipeline on one GPU.

    python3 chip_profile.py [--frames 24] [--start 14] [--end 20]
    python3 chip_profile.py --loop

Runs chip_smoke.py's text run (its text_setup: the rendered 640x480 text
world, seed 0, through TextSLAM(TextSLAMConfig(), device="cuda") with the
ground-truth detections) and traces frames [start, end) with
torch.profiler (CPU + CUDA activities). Prints the card's name and power
limit, the traced window's host wall time, the summed device kernel time
and the device's busy share (one stream: kernels do not overlap), the
kernel launches per frame, the host time in cudaLaunchKernel, the top
device kernels by time and the port's own kernels with their device time
per execution. Before that window it traces 20 calls of the region sampler
at the path's commonest shape (level 0 of a frame's packed pyramid, G = 16,
Q = 512) and prints the device operations per call, which must be the one
kernel, and 20 matcher searches with an alternate descriptor set at the
tracking shape [4096, 1000], each of which must run the Hamming kernel once
and no separate minimum. Then times whole text runs in turns
(deterministic, atomic, atomic, deterministic) with the BA's segment sums
(solver/ba.py::_segment_sum) in PyTorch's deterministic mode, as the port
runs them, and as plain index_add_ (CUDA atomics); prints each run's
per-frame median and whether the runs of each mode ended on identical
keyframe poses and thetas. With --loop it does only this instead: runs
chip_smoke.py's loop run (its loop_setup: the 640x480 outback fixture with
amnesia) and traces the loop closer's run that closes the loop, printing
the same breakdown for the closure. Exits non-zero without a CUDA device.
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


PORT_KERNELS = ("region_sample_kernel", "hamming_mma_kernel")  # csrc/*.cu kernel names


def dev_us(e):
    """Device microseconds of a profiler event (the attribute's name moved)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_events(prof):
    import torch

    return [e for e in prof.key_averages()
            if dev_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]


def sampler_call_trace(card: str, n: int = 20) -> None:
    """Device operations of n grouped_bilinear_stack calls on one frame's
    level 0 with G = 16, Q = 512; fails unless each call ran exactly one
    operation on the card, the sampler kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import _sampler_pyramids, _sampler_samples, check
    from textslam_tpu_torch.ops import patch_sample

    imgs = _sampler_pyramids(1)[0][0, :480, :640, :3][None]
    gen = torch.Generator(device="cuda").manual_seed(1)
    group_k, uv = _sampler_samples(gen, 1, 480, 640, 16, 0)
    patch_sample.grouped_bilinear_stack(imgs, group_k, uv)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            patch_sample.grouped_bilinear_stack(imgs, group_k, uv)
        torch.cuda.synchronize()
    ops = {e.key: (e.count, dev_us(e)) for e in device_events(prof)}
    print(f"sampler, {n} calls at level 0, G=16, Q=512: device operations "
          f"{sum(c for c, _ in ops.values()) / n:g} per call; "
          + "; ".join(f"{k} x{c}, {us / c:.2f} us each" for k, (c, us) in ops.items())
          + f"  [{card}]")
    check(len(ops) == 1 and PORT_KERNELS[0] in next(iter(ops)) and
          next(iter(ops.values()))[0] == n, f"sampler calls ran {ops} on the card")


def hamming_call_trace(card: str, n: int = 20) -> None:
    """Device operations of n mutual_best_match searches with an alternate
    descriptor set at the tracking shape [4096, 1000]; fails unless each
    search ran the Hamming kernel exactly once and no separate minimum."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import check
    from textslam_tpu_torch.ops import matching

    gen = torch.Generator(device="cuda").manual_seed(2)
    d1, d1_alt, d2 = (torch.randint(-2**31, 2**31 - 1, (k, 8), dtype=torch.int32, device="cuda",
                                    generator=gen) for k in (4096, 4096, 1000))
    v1 = torch.rand(4096, device="cuda", generator=gen) < 0.9
    v2 = torch.rand(1000, device="cuda", generator=gen) < 0.9
    pair = torch.rand((4096, 1000), device="cuda", generator=gen) < 0.05

    def search():
        return matching.mutual_best_match(d1, d2, v1, v2, pair_mask=pair, max_dist=100,
                                          d1_alt=d1_alt)

    search()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            search()
        torch.cuda.synchronize()
    ops = {e.key: (e.count, dev_us(e)) for e in device_events(prof)}
    ham = [(c, us) for k, (c, us) in ops.items() if PORT_KERNELS[1] in k]
    print(f"mutual_best_match with d1_alt, {n} searches at [4096, 1000]: device operations "
          f"{sum(c for c, _ in ops.values()) / n:g} per search, the Hamming kernel "
          f"{sum(c for c, _ in ham) / n:g} per search at "
          f"{sum(us for _, us in ham) / max(sum(c for c, _ in ham), 1):.2f} us each; "
          + "; ".join(f"{k[:60]} x{c}" for k, (c, _) in ops.items()) + f"  [{card}]")
    check(len(ham) == 1 and ham[0][0] == n, f"searches ran the Hamming kernel {ham}, want {n}")
    check(not any("minimum" in k for k in ops), f"a separate minimum ran on the card: {ops}")


def breakdown(prof, wall_ms: float, n: int, what: str) -> list:
    """Lines describing a traced window of n units (frames, closures):
    host wall and device kernel time, the device's busy share, kernel
    executions, host time in cudaLaunchKernel, the top device kernels and
    the port's own kernels."""
    rows = prof.key_averages()
    kernels = device_events(prof)
    dev_ms = sum(dev_us(e) for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    launch_host_ms = sum(e.cpu_time_total for e in rows if e.key == "cudaLaunchKernel") / 1e3
    lines = [
        f"{what}: host wall {wall_ms:.1f} ms ({wall_ms / n:.1f} ms each), device kernel time "
        f"{dev_ms:.1f} ms ({dev_ms / n:.1f} ms each), device busy {100 * dev_ms / wall_ms:.1f}%",
        f"device kernel executions {n_launch} ({n_launch / n:.0f} each); host time in "
        f"cudaLaunchKernel {launch_host_ms:.1f} ms",
        "top device kernels (name | executions | device ms | share of device time):",
    ]
    ranked = sorted(kernels, key=dev_us, reverse=True)
    for e in ranked[:25]:
        lines.append(f"  {e.key[:90]:<90} | {e.count:>7} | {dev_us(e) / 1e3:>9.3f} | "
                     f"{100 * dev_us(e) / 1e3 / dev_ms:>5.2f}%")
    lines.append("the port's own kernels (name | executions | device ms | share | us per "
                 "execution):")
    for e in ranked:
        if any(k in e.key for k in PORT_KERNELS):
            lines.append(f"  {e.key[:90]:<90} | {e.count:>7} | {dev_us(e) / 1e3:>9.3f} | "
                         f"{100 * dev_us(e) / 1e3 / dev_ms:>5.2f}% | {dev_us(e) / e.count:.2f}")
    return lines


def loop_closure_profile(card: str) -> int:
    """torch.profiler over the loop closer's run that closes the loop in
    chip_smoke.py's loop run; fails unless a loop closed and the closure
    ran both of the port's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import check, loop_setup

    slam, frames, dets, _, _, track = loop_setup()
    lc = slam.loop_closer
    run = lc.run
    traced = []

    def run_traced(kid):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            closed = run(kid)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if closed:
            traced.append((kid, wall_ms, prof))
        return closed

    lc.run = run_traced
    for i, img in enumerate(frames):
        track(img, float(i), detections=dets[i])
    check(traced, "the loop run closed no loop")
    kid, wall_ms, prof = traced[0]
    lines = breakdown(prof, wall_ms, 1, f"loop closure at keyframe {kid} -> "
                                        f"{lc.closed_loops[0][1]}")
    print("\n".join(lines) + f"  [{card}]")
    names = {e.key for e in device_events(prof)}
    for k in PORT_KERNELS:
        check(any(k in n for n in names), f"the closure did not run {k}")
    return 0


def segment_sum_ab(text_setup, n_frames: int, card: str) -> int:
    import numpy as np
    import torch
    from textslam_tpu_torch.solver import ba

    deterministic = ba._segment_sum

    def atomic(src, idx, n):
        return src.new_zeros((n,) + src.shape[1:]).index_add_(0, idx, src)

    ends = {"deterministic": [], "atomic": []}
    for mode in ("deterministic", "atomic", "atomic", "deterministic"):
        ba._segment_sum = deterministic if mode == "deterministic" else atomic
        try:
            slam, frames, dets, _, _ = text_setup(n_frames)
            ms = []
            for i, img in enumerate(frames):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                slam.track_monocular(img, float(i), detections=dets[i])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            ba._segment_sum = deterministic
        m = slam.map
        ends[mode].append((np.stack([m.kf_pose[kf.kid] for kf in m.keyframes]),
                           m.tx_theta[: m.n_texts].copy()))
        print(f"segment sums {mode}: per-frame median {np.median(ms[2:]):.2f} ms over frames "
              f"2..{len(ms) - 1}, whole run {sum(ms):.1f} ms  [{card}]", flush=True)
    for mode, (a, b) in ends.items():
        same = all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))
        print(f"segment sums {mode}: the two runs end on identical keyframe poses and thetas: "
              f"{same}")
    return 0


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--start", type=int, default=14)
    ap.add_argument("--end", type=int, default=20)
    ap.add_argument("--loop", action="store_true",
                    help="only profile the loop run's closure")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this profile needs one GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import card_line, text_setup
    from textslam_tpu_torch.ops import matching, patch_sample

    card = card_line()
    print(card)
    if args.loop:
        return loop_closure_profile(card)
    sampler_call_trace(card)
    hamming_call_trace(card)
    slam, frames, dets, _, _ = text_setup(args.frames)
    for i in range(args.start):
        slam.track_monocular(frames[i], float(i), detections=dets[i])
    torch.cuda.synchronize()
    n_kf0 = len(slam.map.keyframes)
    launches0 = (matching.hamming_matrix.launches, patch_sample.grouped_bilinear_stack.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.start, args.end):
            slam.track_monocular(frames[i], float(i), detections=dets[i])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = args.end - args.start
    lines = breakdown(prof, wall_ms, n, f"frames {args.start}..{args.end - 1} ({n} frames, "
                                        f"{len(slam.map.keyframes) - n_kf0} keyframe "
                                        f"insertions)")
    lines.insert(2, f"port kernels launched in the window: hamming_matrix "
                    f"{matching.hamming_matrix.launches - launches0[0]}, grouped_bilinear_stack "
                    f"{patch_sample.grouped_bilinear_stack.launches - launches0[1]}")
    print("\n".join(lines))
    return segment_sum_ab(text_setup, args.frames, card)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (textslam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
1. require a CUDA device; print the card's name and power limit
   (nvidia-smi);
2. build every kernel of the port from this checkout, one nvcc per source,
   all started together (csrc/hamming.cu, csrc/patch_sample.cu) with the
   reader's host routines (csrc/jpeg_decode.cpp, csrc/png_unfilter.cpp, g++),
   and print the build time and ptxas's registers and spills;
3. hold the Hamming kernel against its plain PyTorch version on random
   descriptors at the main path's shapes and three ragged ones, without and
   with the alternate row set (one launch computes the minimum), with
   all-zero, all-ones and identical descriptors (exact equality), and time
   them with CUDA events beside the old path of a search (two launches and
   torch.minimum) and two one-call PyTorch yardsticks (torch.cdist(p=0) on
   the unpacked bits, a +-1 bf16 matmul), each held exactly equal once,
   both back to back from the host and as device time per call (CUDA
   graphs); ptxas's registers and spills, and the binary MMA instructions in
   the built kernel (cuobjdump), are printed in phase 2;
4. hold the grouped region sampler (one launch computes the region
   origins, the mask and the samples) against its plain PyTorch version on
   the images the main path hands it (a frame's packed pyramid levels 0..2
   read in place, and keyframe stacks), at the main path's group counts,
   with NaN, off-image, beyond-region and last-pixel samples, then on the
   region cases the kernel computes itself (an all-off-image group, minima
   on tile boundaries, the last-tile clamp, a width-only and a both-full
   level, +-inf, a strided group_k view, G = 70,000 past the old grid
   limit): masks equal, values within 1e-3. For every case it times the
   wrapper, the launch alone, the device time per launch (a CUDA graph of
   many launches), regions() alone (the host work the sampler did before
   each launch when its origins were computed in PyTorch), the plain
   version and the nearest one-call PyTorch equivalent (F.grid_sample over
   the gathered images, the gather's copy included), each the median of 5
   timings taken in turns;
5. the scene-only pipeline (no_text=True): 40 rendered 640x480 plane-world
   frames (tests/torch_synth.py, numpy only) through TextSLAM(cfg,
   device="cuda") at the full ORB / map / BA-window configuration; checks
   tracking, ATE against ground truth, the Hamming kernel's launches on
   that run and that the track-step and solver tensors lay on the GPU;
6. the text pipeline, the default configuration (TextSLAMConfig()): a
   rendered 640x480 text world with its ground-truth detections; checks
   tracking, text objects and their plane normals against ground truth
   (the bars tests/test_e2e_text.py holds the JAX package to), keyframe
   ATE, both kernels' launches on that run and the devices;
7. the loop run: 32 frames of the rendered 640x480 text world's `outback`
   path (out and back to the start) with ground-truth detections, then the
   last 3 frames again, through TextSLAM(TextSLAMConfig(), device="cuda")
   with tests/test_e2e_loop.py's loop gates and its amnesia hooks (the
   return leg forgets the first quarter's landmarks and maps them again);
   checks the bars test_e2e_loop holds the JAX package to (a loop closed to
   an older keyframe, landmarks fused, keyframe ATE < 0.03, the legs'
   covisibility bridged, post-loop re-tracking on first-leg points), the
   text bars of phase 6 on every GOOD object (an object that a step of the
   run from the correction on leaves outside its bar passes only where
   tests/loop_reference_steps.json shows the JAX package, given a map of
   the same digest, missing the same bar), one Hamming launch per
   loop-time search, sampler launches inside the landmark-only BA, every
   loop-time kernel call equal to its plain version on the same tensors
   (Hamming exactly, the sampler's masks exactly and values within 1e-3),
   and the Sim3 / pose-graph / BA tensors on the GPU; prints the closure's
   synchronized wall time and its parts (the checks' time left out); then
   runs landmark_theta_pass once on the post-loop map and holds the text
   bars and the kernel checks again;
8. the CLI run: 24 frames of the text world of phase 6 written to a
   temporary directory in the reference's dataset layout (tests/torch_synth
   write_dataset: frames stored distorted as PNG with all five row filters,
   OCR files with a CJK and a "#" probe line on frame 5, Imlist / Imshort,
   one yaml per experiment and scene-only ones) and its JPEG twin (the same
   frames in color, torch_synth.tint_bgr, as baseline 4:2:0 JPEG,
   torch_synth.encode_jpeg); checks that every
   committed fixture of the reader (tests/jpeg/, tests/png/: baseline and
   progressive JPEG, palette, sub-byte and interlaced PNG) decodes to the
   digest of cv2's decode recorded beside it, that every PNG frame decodes
   to the image written and every JPEG frame near it, that the detections
   read back as written,
   that the reader's undistorted frame is a CUDA tensor equal within 1e-4
   to the same reader's on the CPU and within tests/test_cli_e2e.py's bar
   of the ideal render, and that a BGR frame decodes exactly and converts
   to cv2's gray on the card; then runs `textslam_tpu_torch.cli.main` in
   this process on the card: experiment 0 over all frames with
   --checkpoint-every 8 (every output written, at least 3 keyframes,
   keyframe ATE < 0.05, both kernels launched and every call held to its
   plain version as in phase 7), the same run again on the JPEG twin with
   the checks off (the same bars; its launches, and its per-frame medians
   of read + decode, undistortion and tracking, are printed, with the PNG
   run's read + decode), a scene-only run split at frame 12 and resumed (the
   same keyframes as the uninterrupted run, poses within 1e-3), the same
   split with text on (ATE < 0.05), experiments 1-3 over the first 12 frames
   (at least 2 keyframes each); prints those medians and the checkpoint's
   save and load times and size;
9. scale-out (textslam_tpu_torch/parallel/), on a mesh of two shards of
   cuda:0 (the machine has one card; NCCL between two cards is not run):
   (a) bench.py's problem (20 KFs, 8,192 points, 512 observations per KF,
   32 texts x 64 features, made with numpy from a seed): one sharded
   assembly, scene and text, held to one device's at
   tests/test_parallel.py's tolerances, solve_ba_sharded held to solve_ba
   by final cost (1e-3 relative) and poses (1e-4), the landmark-sharded
   step held to the observation-sharded one, and each solve's synchronized
   wall time beside solve_ba's and the region-sampler solve's;
   (b) phase 6's text run with the tracker's and the map's mesh set: every
   windowed BA runs the sharded LM level by level; phase 6's bars (tracking,
   KF ATE, the text planes), keyframe camera centres within 5e-3 of phase
   6's after Sim3 alignment (the windowed BA's scale is a gauge:
   chip_mesh_scale.py) and quaternions within 5e-3, the Sim3 scale printed
   and within a factor of 1.5 of phase 6's, the sharded solver called with
   text rows, both kernels launched and every call held to its plain
   version as in phase 7, per-frame and KF-insertion medians printed beside
   phase 6's; then the same run on a mesh of four shards of cuda:0, held to
   the same bars (its kernel calls not held again);
   (c) the sharded covisibility product at K = 5, 64, 200 and 512
   keyframes x 32,768 points, plain and weighted, bit-equal to the exact
   product and timed against the host product (the crossover K printed);
   (d) two spawned processes, each a 1-shard mesh on cuda:0, in a gloo
   group (CUDA tensors): one assembly held to the same two shards in one
   process (1e-5 relative), one solve_ba_sharded held to solve_ba by final
   cost; then NCCL with a world size of 1, equal to the 1-shard mesh
   without a group;
10. the long regime: (a) the native host routines (csrc/native.cpp, built
   with the host C++ compiler): covis_product bit-equal to the exact product
   on phase 9(c)'s incidences (K = 5..512 x 32,768 points), timed beside
   9(c)'s numpy and device products, and levenshtein_batch exactly equal to
   the Python DP at L = 128 and 256 with empty, ASCII and CJK strings;
   (b) tests/test_scale_rehearsal.py's fixture through the port
   (run_long): 200 frames of the 640x480 text world (seed 3,
   3 boxes per plane) on two out-and-back excursions, TextSLAMConfig() with
   the pools derived from the sequence length (MapConfig.derive) and
   global_decompose_kfs 16; its bars (keyframes >= N/8 and below the cap,
   no saturation drop, at least one loop closed, online-trajectory ATE <
   0.06, the RSS at the end below 1.6 x the mid-run RSS + 500 MB) and the
   port's (every closure past 16 keyframes took the decomposed landmark
   pass, every kernel call equal to its plain version as in phase 7, the
   tensors on the GPU); a run that closes no loop passes only as the JAX
   package's own result on this fixture (tests/rehearsal_reference.json,
   written by tests/rehearsal_reference.py on the CPU: no loop either, and
   no keyframe left eligible by the covisibility exclusion at any closer
   run, in either package); a snapshot every 50 frames (median frame and
   keyframe-insertion ms, closures with their keyframe count, map counts,
   narrowing, RSS, host_bytes, device memory, the text-plane census of
   phase 6, printed and not held); then the amnesia run: the same
   fixture's frames 0..124 with tests/test_e2e_loop.py's amnesia from frame
   100 on (the landmarks of the keyframes made before frame 50 forgotten):
   its first 100 frames are the rehearsal's, which saves its checkpoint
   there, and a new TextSLAM loaded from it takes frames 100..124
   (checkpoint MB, save and load ms printed); it must close a loop through
   the decomposed pass, track and keep ATE < 0.06 (its kernel calls not
   held again); (c) tests/test_long_regime.py's two
   scene-only fixtures at 640x480: the local-map narrowing of a 2,048-point
   pool runs, leaves more than 50 candidates at every call and keeps
   tracking at KF ATE < 0.02; a 1,024-point pool is never passed. 10(b)
   and (c) run in a process of their own (LongSide, `--long-side OUT`),
   started after phase 4 and run on the same card beside phases 5-10(a),
   so that the script stays well within its time limit; their output is
   printed when they end;
11. print the wall seconds of each phase, per-frame and
   keyframe-insertion times, one JSON line of the scale-out numbers, one
   of the long regime's, one JSON line describing the kernels, and last
   the JSON result line.

    python3 chip_smoke.py --seed-study 0-21

runs only the text pipeline under the given RANSAC seeds and holds each run
to those bars; `--long-only` runs only phase 9(c) and phase 10.

Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_SCENE_FRAMES = 40
N_TEXT_FRAMES = 24  # ~8 keyframes: at least 6 and below the 20 of the loop gate
# the loop run: test_e2e_loop's fixture (its frame count, camera rate and
# loop gates; the gates are depth, not width), the last 3 frames fed again
N_LOOP_FRAMES = 32
N_LOOP_REFEED = 3
LOOP_FPS = 6.0
LOOP_GATES = dict(min_kfs_before_loop=6, min_kfs_between_loops=5, num_covis_for_thresh=3)
LOOP_ATE_MAX = 0.03  # tests/test_e2e_loop.py's post-loop keyframe ATE bar
# the CLI run: tests/test_cli_e2e.py's fixture (distorted frames on disk,
# its bars) on the text world of the text run (seed 0, lateral path)
N_CLI_FRAMES, N_CLI_SHORT = 24, 12
CLI_FPS = 10.0
CLI_DIST = (-0.05, 0.01, 0.0, 0.0, 0.0)  # k1, k2, p1, p2, k3
CLI_ATE_MAX = 0.05
UNDISTORT_ERR_MAX = 6.0  # mean abs gray in the central region vs the ideal render
UNDISTORT_DEV_ATOL = 1e-4  # gray, the reader on the card vs the same reader on the CPU
RESUME_POSE_DIFF = 1e-3
# the JPEG twin of the CLI set (torch_synth.encode_jpeg, color baseline 4:2:0) and
# the reader's committed fixtures with cv2's digests (tests/jpeg_fixtures.py)
CLI_JPEG_QUALITY = 90
JPEG_TWIN_ERR_MAX = 2.0  # mean abs sample of a decoded frame against the image encoded
FIXTURE_SETS = (("jpeg", "jpeg_reference.json"), ("png", "png_reference.json"))
# Hamming shapes on the main path: tracked frames [P, 1000] for point pools
# of 4096..32768, two-view init [3000, 3000], keyframe triangulation
# [1000, 1000]; then ragged shapes that exercise the edge masking and the
# scalar stores of rows that are not 16-byte aligned
HAMMING_SHAPES = [(4096, 1000), (32768, 1000), (3000, 3000), (1000, 1000), (1001, 999),
                  (4095, 1001), (17, 9), (1, 1)]
# Hamming launches of the text run: one per search (the alternate-descriptor
# minimum in the same launch), two searches per tracked frame, and one more
# (triangulation) per keyframe insertion
HAMMING_PER_FRAME, HAMMING_PER_KF = 2.0, 3.0
HAMMING_GRAPH_CALLS = 20  # calls per CUDA graph when timing the device alone
# sampler: groups of Q = 64 features x 8 pattern samples (one text box per
# group) on the images the main path hands the kernel. The path cases: one
# frame's packed pyramid level, sampled in place (a view whose row stride is
# the level-0 width: fused_pose_refine), with G = 4 / 8 / 16 / 32 objects; and
# keyframe stacks assembled the way TextFrontend._stack_levels assembles them,
# K = 16 slots with G = 16 (maturation) and K = 32 slots with G = 32 (the
# windowed BA's pair tier). Off the path, kept as a stress case: a 20-KF stack
# with G = 640 (20 KFs x 32 texts, the window bench.py times) and a ragged G = 7.
SAMPLER_LEVELS = (0, 1, 2)
SAMPLER_FRAME_GROUPS = (4, 8, 16, 32)
SAMPLER_STACKS = ((16, 16), (32, 32))  # (slots, groups)
SAMPLER_OFF_PATH = ((20, 640), (20, 7))
SAMPLER_Q = 512
SAMPLER_BIG_G = 70_000  # past CUDA's 65,535 limit on grid.y, off the path
SAMPLER_ATOL = 1e-3  # intensities in [0, 255], Sobel values up to ~1,020
KF_ATE_MAX = 0.012  # the bound tests/test_e2e_scene.py / test_e2e_text.py hold JAX to
FRAME_ATE_MAX = 0.025
# the bars tests/test_e2e_text.py holds the JAX package's text planes to:
THETA_COS_MIN = 0.95  # GOOD objects with >= 3 KF observations
THETA_COS_BASIN = 0.6  # every other GOOD object: not a wrong-basin plane
THETA_COS_CONVERGED = 0.99  # ... and at least this share of GOOD planes above it
CONVERGED_SHARE_MIN = 0.5
# H100 SXM datasheet peaks: HBM bytes/s; 32-bit
# operations outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS32 = 67e12


T_START = time.perf_counter()  # the script's start, for its wall time


def timed(label: str, fn, *args):
    """fn(*args), its wall seconds printed as `[time] phase <label>`."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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


def median_ms(fns, iters: int, reps: int = 5):
    """{name: median over reps of time_ms(fn, iters)}, the functions taken
    in turns, so that host-bound calls on a shared host meet the same noise."""
    import statistics

    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            times[k].append(time_ms(fn, iters))
    return {k: statistics.median(v) for k, v in times.items()}


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the 32-bit peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_OPS32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def unpack_bits(d):
    """[N, 8] int32 descriptor words -> [N, 256] float32 0/1 bits."""
    import torch

    shifts = torch.arange(32, dtype=torch.int32, device=d.device)
    return ((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], 256).float()


def capture(fn, n: int):
    """A CUDA graph of n calls of fn (after one warm-up call on a side
    stream): replaying it runs their launches with no host work between."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return graph


def device_ms(fn, n: int = 50) -> float:
    """Device milliseconds per call: CUDA events around replays of a CUDA
    graph that captured n calls."""
    graph = capture(fn, n)
    ms = time_ms(graph.replay, iters=10) / n
    del graph
    return ms


def _hamming_inputs(gen, n1: int, n2: int):
    """Random descriptors (d1, d1_alt, d2) with the edge cases written into
    the first rows and columns where the shape has room: all-zero and
    all-ones words (the int32 sign bit set in every word), rows identical
    to columns. Returns the tensors and {(set, i, j): expected distance}."""
    import torch

    def rnd(n):
        return torch.randint(-2**31, 2**31 - 1, (n, 8), dtype=torch.int32, device="cuda",
                             generator=gen)

    d1, d1_alt, d2 = rnd(n1), rnd(n1), rnd(n2)
    expect = {}
    d1[0], d2[0] = 0, -1  # all zeros against all ones: 256 in both entries
    d1_alt[0] = 0 if n2 == 1 else d2[0]
    expect[("d1", 0, 0)] = 256
    expect[("min", 0, 0)] = 256 if n2 == 1 else 0
    if n1 > 1 and n2 > 1:
        d1[1], d1_alt[1], d2[1] = -1, -1, -1  # all ones against all ones
        expect[("d1", 1, 1)] = expect[("min", 1, 1)] = 0
        expect[("d1", 1, 0)] = 0
        expect[("d1", 0, 1)] = 256
    if n1 > 3 and n2 > 3:
        d2[2], d2[3] = d1[2], d1_alt[3]  # rows identical to columns
        expect[("d1", 2, 2)] = expect[("min", 2, 2)] = expect[("min", 3, 3)] = 0
    return d1, d1_alt, d2, expect


def compare_hamming(matching, card: str):
    """Kernel vs plain version at every path shape and the ragged ones,
    without and with the alternate row set (hamming_matrix and
    hamming_matrix_min): exact equality, and the edge descriptors at their
    known distances. Times (medians of 5, in turns): the kernel, the
    one-launch minimum, the old path of a search (two launches and
    torch.minimum), the plain version and two one-call PyTorch yardsticks
    the port never calls, each held exactly equal to the kernel once:
    torch.cdist(p=0) on the descriptors unpacked to 0/1 floats (it counts
    the differing bits), and a bf16 matmul of the +-1 bits (256 - 2 H, exact
    in bf16)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for n1, n2 in HAMMING_SHAPES:
        d1, d1_alt, d2, expect = _hamming_inputs(gen, n1, n2)
        got = {"d1": matching.hamming_matrix(d1, d2),
               "min": matching.hamming_matrix_min(d1, d1_alt, d2)}
        want = {"d1": matching.hamming_matrix_plain(d1, d2),
                "min": matching.hamming_matrix_min_plain(d1, d1_alt, d2)}
        torch.cuda.synchronize()
        err = 0
        for k in got:
            check(got[k].shape == (n1, n2) and got[k].dtype == torch.int32,
                  f"hamming {k} at {n1}x{n2}: {tuple(got[k].shape)} {got[k].dtype}")
            e = int((got[k] - want[k]).abs().max().item())
            err = max(err, e)
            check(torch.equal(got[k], want[k]),
                  f"hamming kernel ({k}) != plain at {n1}x{n2} (max err {e})")
            check(int(want[k].min()) >= 0 and int(want[k].max()) <= 256,
                  "plain hamming out of range")
        for (k, i, j), h in expect.items():
            check(int(got[k][i, j]) == h, f"hamming {k}[{i}, {j}] at {n1}x{n2}: "
                                          f"{int(got[k][i, j])}, want {h}")
        b1, b2 = unpack_bits(d1), unpack_bits(d2)
        s1, s2 = (1 - 2 * b1).bfloat16(), (1 - 2 * b2).bfloat16()
        if (n1, n2) == HAMMING_SHAPES[0]:
            check(torch.equal(torch.cdist(b1, b2, p=0).int(), got["d1"]), "cdist(p=0) != kernel")
            check(torch.equal(((256 - torch.matmul(s1, s2.T).float()) / 2).int(), got["d1"]),
                  "+-1 bf16 matmul != kernel")
        calls = {
            "ms": lambda: matching.hamming_matrix(d1, d2),
            "ms_alt": lambda: matching.hamming_matrix_min(d1, d1_alt, d2),
            "old_path_ms": lambda: torch.minimum(matching.hamming_matrix(d1, d2),
                                                 matching.hamming_matrix(d1_alt, d2)),
            "bf16_matmul_ms": lambda: torch.matmul(s1, s2.T)}
        fast = median_ms(calls, iters=20)  # back to back from the host, as the path calls them
        slow = median_ms({
            "plain_ms": lambda: matching.hamming_matrix_plain(d1, d2),
            "library_ms": lambda: torch.cdist(b1, b2, p=0)}, iters=3)
        # device time per call: replays of CUDA graphs of HAMMING_GRAPH_CALLS
        # calls each, in turns (no host time between the launches)
        graphs = {"device_" + k: capture(fn, HAMMING_GRAPH_CALLS) for k, fn in calls.items()}
        dev = {k: v / HAMMING_GRAPH_CALLS for k, v in
               median_ms({k: g.replay for k, g in graphs.items()}, iters=3).items()}
        del graphs
        # descriptors read once, the int32 matrix written once; XOR + popcount
        # + add per word pair (and the alternate set's, and a minimum, with d1_alt)
        bound_ms, bound_by = bound((n1 + n2) * 32 + n1 * n2 * 4, n1 * n2 * 8 * 3)
        bound_alt_ms, _ = bound((2 * n1 + n2) * 32 + n1 * n2 * 4, n1 * n2 * (8 * 6 + 1))
        row = {"shape": [n1, n2], "max_abs_err": err, **fast, **slow, **dev,
               "bound_ms": bound_ms, "bound_by": bound_by, "bound_alt_ms": bound_alt_ms}
        rows.append(row)
        print(f"hamming {n1}x{n2}: equal without and with d1_alt (edge descriptors included); "
              f"back to back from the host: kernel {row['ms']:.5f} ms, with d1_alt "
              f"{row['ms_alt']:.5f} ms, old path (two launches + minimum) "
              f"{row['old_path_ms']:.5f} ms, +-1 bf16 matmul {row['bf16_matmul_ms']:.5f} ms, "
              f"plain {row['plain_ms']:.4f} ms, cdist(p=0) on 0/1 floats "
              f"{row['library_ms']:.4f} ms; device time per call (CUDA graph): kernel "
              f"{row['device_ms']:.5f} ms (share of bound {bound_ms / row['device_ms']:.2f}), "
              f"with d1_alt {row['device_ms_alt']:.5f} ms (share "
              f"{bound_alt_ms / row['device_ms_alt']:.2f}), old path "
              f"{row['device_old_path_ms']:.5f} ms, bf16 matmul "
              f"{row['device_bf16_matmul_ms']:.5f} ms (kernel / matmul "
              f"{row['device_ms'] / row['device_bf16_matmul_ms']:.2f}); bound {bound_ms:.5f} ms "
              f"({bound_by}), with d1_alt {bound_alt_ms:.5f} ms  [{card}]")
    torch.cuda.empty_cache()
    return rows


def _sampler_pyramids(n: int = 4):
    """Packed [4, 480, 640, 3] pyramids (intensity, sobel-x, sobel-y) of n
    rendered 640x480 text-world frames, built on the card as build_frame
    builds them."""
    import torch
    import torch_synth
    from textslam_tpu_torch.ops import pyramid

    world = torch_synth.TextWorld(seed=0)
    out = []
    for pose in torch_synth.camera_path(n * 6)[::6]:
        img = torch.as_tensor(world.render(pose), dtype=torch.float32, device="cuda")
        imgs, grads = pyramid.build_pyramid(img, levels=4)
        out.append(pyramid.pack_pyramid(imgs, grads)["data"])
    return out


def _sampler_stack(pyrs, level: int, n_slots: int):
    """A keyframe stack as TextFrontend._stack_levels assembles it: a
    [n_slots, H_l, W_l, 3] tensor whose slots are copied from packed
    pyramids' level views (here the rendered frames, cycled)."""
    import torch

    H, W = 480 >> level, 640 >> level
    st = torch.zeros((n_slots, H, W, 3), device="cuda")
    for i in range(n_slots):
        st[i] = pyrs[i % len(pyrs)][level, :H, :W, :3]
    return st


def _sampler_samples(gen, K, H, W, G, level, Q=SAMPLER_Q):
    """G groups of Q clustered samples (one text box per group, 64 features
    x the 8-sample pattern) on images 0..K-1, plus the edge cases: a NaN
    projection, an off-image sample, a sample beyond its region and samples
    at exactly the last pixel / row / column."""
    import torch

    dev = "cuda"
    group_k = torch.randint(0, K, (G,), device=dev, generator=gen)
    s = 2.0 ** level
    bw = (torch.rand((G, 1), device=dev, generator=gen) * 80 + 140) / s  # box px at level
    bh = (torch.rand((G, 1), device=dev, generator=gen) * 40 + 70) / s
    x0 = torch.rand((G, 1), device=dev, generator=gen) * (W - bw - 4) + 2
    y0 = torch.rand((G, 1), device=dev, generator=gen) * (H - bh - 4) + 2
    x0[-1], y0[-1] = W - 1 - bw[-1], H - 1 - bh[-1]  # the last box in the bottom-right corner
    u = x0 + torch.rand((G, Q), device=dev, generator=gen) * bw
    v = y0 + torch.rand((G, Q), device=dev, generator=gen) * bh
    uv = torch.stack([u, v], dim=-1).contiguous()
    uv[0, 0] = torch.tensor([float("nan"), float("nan")])  # broken projection
    uv[0, 1] = torch.tensor([-3.0, 5.0])  # off-image
    uv[0, 2] = uv[0, 3] + torch.tensor([400.0 / s, 0.0], device=dev)  # beyond the region
    uv[-1, 0] = torch.tensor([W - 1.0, H - 1.0])  # the last pixel exactly
    uv[-1, 1] = torch.tensor([W - 1.0, float(v[-1, 5])])  # the last column
    uv[-1, 2] = torch.tensor([float(u[-1, 5]), H - 1.0])  # the last row
    return group_k, uv


def _sampler_bytes(patch_sample, imgs, group_k, uv):
    """Bytes the sampler must move on these inputs: uv and group_k read,
    the samples and the mask written, and each distinct corner pixel's 3
    channels read once."""
    import torch

    K, H, W, C = imgs.shape
    _, meta, mask, RH, RW = patch_sample.regions(imgs, group_k, uv, 160, 384)
    k, oy, ox = meta.long().unbind(-1)
    x0 = ox[:, None] + (uv[..., 0] - ox[:, None]).clamp(0, RW - 1).floor().long().clamp(0, RW - 2)
    y0 = oy[:, None] + (uv[..., 1] - oy[:, None]).clamp(0, RH - 1).floor().long().clamp(0, RH - 2)
    corners = []
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = y0 + dy, x0 + dx
            ok = mask & (y < H) & (x < W)
            corners.append(((k[:, None] * H + y) * W + x)[ok])
    n_pix = int(torch.unique(torch.cat(corners)).numel())
    G, Q = mask.shape
    return G * Q * (2 * 4 + 1 + C * 4) + G * 8 + n_pix * C * 4, G * Q * C * 12


def _sampler_cases(pyrs, gen):
    """(label, on_path, level, imgs, group_k, uv, expect) for every sampler
    case: the path's images and group counts first, then the region cases
    the kernel computes itself. `expect(patch_sample, imgs, group_k, uv,
    mask)` returns what a case must show, beside the masks-equal /
    values-close check every case gets."""
    import torch

    def view(level):  # one frame's packed pyramid level, read in place
        return pyrs[0][level, :480 >> level, :640 >> level, :3][None]

    def cases():
        for level in SAMPLER_LEVELS:
            for G in SAMPLER_FRAME_GROUPS:
                yield "frame level view", True, level, view(level), G
            for slots, G in SAMPLER_STACKS:
                yield f"{slots}-slot KF stack", True, level, _sampler_stack(pyrs, level, slots), G
            for slots, G in SAMPLER_OFF_PATH:
                yield f"{slots}-slot KF stack, off the path", False, level, \
                    _sampler_stack(pyrs, level, slots), G

    def edge_expect(patch_sample, imgs, group_k, uv, mask):
        return [(not bool(mask[0, 0]) and not bool(mask[0, 1]), "NaN / off-image samples kept"),
                (bool(mask[-1, :3].all()), "last-pixel / last-row / last-column samples masked")]

    for label, on_path, level, imgs, G in cases():
        K, H, W, _ = imgs.shape
        yield (label, on_path, level, imgs, *_sampler_samples(gen, K, H, W, G, level),
               edge_expect)

    def origins(patch_sample, imgs, group_k, uv):
        return patch_sample.regions(imgs, group_k, uv, 160, 384)[1][:, 1:].tolist()

    def samples(level, G, K=1):
        return _sampler_samples(gen, K, 480 >> level, 640 >> level, G, level)

    # a group with no in-image sample (NaN, left of and below the image)
    gk, uv = samples(0, 16)
    uv[1, 0::3] = float("nan")
    uv[1, 1::3] = torch.tensor([-3.0, 5.0])
    uv[1, 2::3] = torch.tensor([700.0, 500.0])
    yield "all-off-image group", True, 0, view(0), gk, uv, \
        lambda ps, im, k, uv, m: [(not bool(m[1].any()), "an off-image group kept samples")]

    # minima exactly on and just below a 128-px / 8-row tile boundary, and
    # samples on and just past the region's last column
    gk, uv = samples(0, 16)
    for g, c, lo in ((1, 0, 128.0), (2, 0, 127.99998), (3, 1, 8.0), (4, 1, 7.9999995)):
        uv[g, :, c] = lo + (uv[g, :, c] - uv[g, :, c].min())  # the minimum becomes lo exactly
        uv[g, 0, c] = lo
    uv[1, 1, 0] = 128.0 + 383  # ox + RW - 1: kept
    uv[1, 2, 0] = float(torch.nextafter(torch.tensor(511.0), torch.tensor(512.0)))  # masked
    yield "tile-boundary minima", True, 0, view(0), gk, uv, \
        lambda ps, im, k, uv, m: [
            ([o[1] for o in origins(ps, im, k, uv)[1:3]] == [128, 0], "ox at u = 128 / 127.99998"),
            ([o[0] for o in origins(ps, im, k, uv)[3:5]] == [8, 0], "oy at v = 8 / 7.9999995"),
            (bool(m[1, 1]) and not bool(m[1, 2]), "the region's last column")]

    # a box in the bottom-right corner: origins clamp to the last tile
    gk, uv = samples(0, 16)
    uv[1, :, 0] = 520.0 + (uv[1, :, 0] - uv[1, :, 0].min()).clamp(max=119.0)
    uv[1, :, 1] = 330.0 + (uv[1, :, 1] - uv[1, :, 1].min()).clamp(max=149.0)
    yield "last-tile clamp", True, 0, view(0), gk, uv, \
        lambda ps, im, k, uv, m: [(origins(ps, im, k, uv)[1] == [480 - 160, 640 - 384],
                                   "origins of the corner box: (H8 - RH, W128 - RW)")]

    # level 1 (320 px -> W128 = 384): only the width is full; samples
    # across the width
    gk, uv = samples(1, 16)
    uv[2:, 3:, 0] = torch.rand((14, SAMPLER_Q - 3), device="cuda", generator=gen) * 180 + 139
    yield "width-only full level", True, 1, view(1), gk, uv, \
        lambda ps, im, k, uv, m: [(ps.launch_args(im, k, uv)[-2:] == (0, 1), "full flags"),
                                  (all(o[1] == 0 for o in origins(ps, im, k, uv)), "ox = 0")]

    # level 3 (80 x 60 -> 128 x 64): both full
    gk, uv = samples(3, 16)
    yield "both-full level", True, 3, view(3), gk, uv, \
        lambda ps, im, k, uv, m: [(ps.launch_args(im, k, uv)[-2:] == (1, 1), "full flags")]

    # +-inf coordinates; group 3 has nothing else
    gk, uv = samples(0, 16)
    inf = float("inf")
    uv[1, 0], uv[1, 1] = torch.tensor([inf, 5.0]), torch.tensor([-inf, 5.0])
    uv[2, 0], uv[2, 1] = torch.tensor([5.0, inf]), torch.tensor([5.0, -inf])
    uv[3, 0::2], uv[3, 1::2] = torch.tensor([inf, -inf]), torch.tensor([-inf, inf])
    yield "+-inf coordinates", True, 0, view(0), gk, uv, \
        lambda ps, im, k, uv, m: [(not bool(m[1, :2].any() or m[2, :2].any() or m[3].any()),
                                   "non-finite samples kept")]

    # the strided image-index view solver/ba.py::_sample_text_values passes
    stack = _sampler_stack(pyrs, 0, 16)
    gk, uv = _sampler_samples(gen, 16, 480, 640, 16, 0)
    gk = gk.repeat_interleave(64).reshape(16, 64)[:, 0]
    yield "strided group_k view (16-slot KF stack)", True, 0, stack, gk, uv, \
        lambda ps, im, k, uv, m: [(k.stride(0) == 64 and not k.is_contiguous(),
                                   "group_k is a strided view")]

    # past the old 65,535-group grid limit
    G = SAMPLER_BIG_G
    gk, uv = _sampler_samples(gen, 20, 60, 80, G, 3, Q=8)
    yield f"G = {G}, Q = 8 (20-slot KF stack), off the path", False, 3, \
        _sampler_stack(pyrs, 3, 20), gk, uv, lambda ps, im, k, uv, m: [(m.shape == (G, 8), "shape")]


def compare_sampler(patch_sample, card: str):
    """Kernel vs plain version on the inputs the main path hands the kernel
    and on the region cases it computes itself: masks equal, values within
    SAMPLER_ATOL; times of the wrapper, the kernel's device time, the plain
    version, regions() alone (the host work the sampler did before its
    origins moved into the kernel) and F.grid_sample."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    pyrs = _sampler_pyramids()
    rows = []
    for label, on_path, level, imgs, group_k, uv, expect in _sampler_cases(pyrs, gen):
        K, H, W, _ = imgs.shape
        G, Q = uv.shape[:2]
        vals, mask = patch_sample.grouped_bilinear_stack(imgs, group_k, uv)
        pv, pm = patch_sample.grouped_bilinear_stack_plain(imgs, group_k, uv)
        torch.cuda.synchronize()
        where = f"{label}, level {level} {list(imgs.shape)} G={G} Q={Q}"
        check(torch.equal(mask, pm), f"sampler masks differ: {where}")
        check(bool(torch.isfinite(vals).all()), f"non-finite sampler values: {where}")
        err = float((vals - pv).abs().max())
        check(err <= SAMPLER_ATOL, f"sampler kernel vs plain max err {err}: {where}")
        for ok, what in expect(patch_sample, imgs, group_k, uv, mask):
            check(ok, f"sampler case does not show what it is for ({what}): {where}")
        grid = torch.stack([uv[..., 0] / (W - 1) * 2 - 1, uv[..., 1] / (H - 1) * 2 - 1],
                           dim=-1)[:, :, None, :]

        def library():
            return F.grid_sample(imgs.index_select(0, group_k).permute(0, 3, 1, 2), grid,
                                 mode="bilinear", align_corners=True)

        def wrapper():
            return patch_sample.grouped_bilinear_stack(imgs, group_k, uv)

        args = patch_sample.launch_args(imgs, group_k, uv)
        t = median_ms({
            "ms": wrapper,
            # the launch alone, into preallocated outputs
            "launch_ms": lambda: patch_sample._launch(imgs, group_k, uv, vals, mask, args),
            "regions_ms": lambda: patch_sample.regions(imgs, group_k, uv, 160, 384),
            "plain_ms": lambda: patch_sample.grouped_bilinear_stack_plain(imgs, group_k, uv),
            "library_ms": library}, iters=20)
        ms, launch_ms, regions_ms, plain_ms, library_ms = (
            t[k] for k in ("ms", "launch_ms", "regions_ms", "plain_ms", "library_ms"))
        dev_ms = device_ms(wrapper)
        bound_ms, bound_by = bound(*_sampler_bytes(patch_sample, imgs, group_k, uv))
        rows.append({"case": label, "on_path": on_path, "level": level, "stack": list(imgs.shape),
                     "row_stride": imgs.stride(1), "groups": G, "Q": Q, "max_abs_err": err,
                     "ms": ms, "launch_ms": launch_ms, "device_ms": dev_ms,
                     "regions_ms": regions_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"sampler {where} (row stride {imgs.stride(1)}): masks equal, max_abs_err "
              f"{err:.2e}, wrapper {ms:.4f} ms, launch alone {launch_ms:.4f} ms, device "
              f"{dev_ms:.5f} ms per launch (CUDA graph), regions() alone {regions_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, grid_sample incl. gather copy {library_ms:.4f} ms "
              f"(wrapper / grid_sample {ms / library_ms:.2f}), bound {bound_ms:.5f} ms "
              f"({bound_by})  [{card}]")
    del pyrs
    torch.cuda.empty_cache()
    return rows


def _watch(devices):
    """A wrapper factory recording the device of every tensor going into or
    out of the wrapped function."""
    import torch

    def watch(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            for x in list(args) + list(kw.values()) + [out]:
                for t in (x if isinstance(x, (tuple, list)) else (x,)):
                    if isinstance(t, torch.Tensor):
                        devices.add(t.device.type)
            return out
        return wrapped
    return watch


def drive(slam, frames, dets, counters):
    """Feed the frames; per-frame host times (synchronized, less the time of
    kernel checks made inside; see _kernel_checks), split into init,
    tracked and keyframe-insertion frames, with kernel launches per
    frame."""
    import torch

    init_ms, frame_ms, kf_ms, n_ok = [], [], [], 0
    launches = {"frame": {k: [] for k in counters}, "kf": {k: [] for k in counters}}
    for fn in counters.values():
        fn.launches = 0  # count only this run's launches
    for i, img in enumerate(frames):
        n_kf = len(slam.map.keyframes)
        tracking_before = slam.tracker.state == 1
        before = {k: fn.launches for k, fn in counters.items()}
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), CHECK_MS[0]
        pose = slam.track_monocular(img, float(i), detections=None if dets is None else dets[i])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3 - (CHECK_MS[0] - c0)
        n_ok += pose is not None
        if not tracking_before:
            init_ms.append(dt)
            continue
        kind = "kf" if len(slam.map.keyframes) > n_kf else "frame"
        (kf_ms if kind == "kf" else frame_ms).append(dt)
        for k, fn in counters.items():
            launches[kind][k].append(fn.launches - before[k])
    total = {k: fn.launches for k, fn in counters.items()}
    return init_ms, frame_ms, kf_ms, n_ok, launches, total


def _summary(name, frames, init_ms, frame_ms, kf_ms, n_ok, slam, gt, launches, total,
             devices, card):
    import numpy as np
    import torch_synth
    from textslam_tpu_torch.utils.profiling import report

    kfs = slam.map.keyframes
    kposes = np.stack([slam.map.kf_pose[kf.kid] for kf in kfs])
    check(np.isfinite(kposes).all(), f"{name}: non-finite keyframe pose")
    kf_ate = torch_synth.ate_rmse([kf.timestamp for kf in kfs], kposes, gt)
    traj = slam.tracker.trajectory
    frame_ate = torch_synth.ate_rmse([t for t, _ in traj], np.stack([p for _, p in traj]), gt)
    check(slam.tracker.state == 1, f"{name}: tracker not OK at the end of the sequence")
    check(n_ok >= len(frames) - 5, f"{name}: only {n_ok}/{len(frames)} frames tracked")
    check(devices == {"cuda"}, f"{name}: track-step / solver tensors on {sorted(devices)}")
    check(kf_ate < KF_ATE_MAX, f"{name}: keyframe ATE {kf_ate} >= {KF_ATE_MAX}")
    print(report(reset=True))
    res = {
        "frames": len(frames), "tracked": n_ok, "keyframes": len(kfs),
        "points": int(slam.map.n_points), "kf_ate": kf_ate, "frame_ate": frame_ate,
        "launches": total, "tensor_devices": sorted(devices),
        "launches_per_tracked_frame": {k: float(np.mean(v)) if v else 0.0
                                       for k, v in launches["frame"].items()},
        "launches_per_kf_insertion": {k: float(np.mean(v)) if v else 0.0
                                      for k, v in launches["kf"].items()},
        "frame_ms_median": float(np.median(frame_ms)),
        "frame_ms_p90": float(np.percentile(frame_ms, 90)),
        "kf_insert_ms_median": float(np.median(kf_ms)),
        "init_ms": init_ms, "frame_ms": frame_ms, "kf_ms": kf_ms, "kf_poses": kposes,
    }
    print(f"{name} init ms: {[round(x, 2) for x in init_ms]}")
    print(f"{name} frame ms: {[round(x, 2) for x in frame_ms]}")
    print(f"{name} KF insertion ms: {[round(x, 2) for x in kf_ms]}")
    print(f"{name}: {n_ok}/{len(frames)} tracked, {len(kfs)} KFs, {slam.map.n_points} points, "
          f"KF ATE {kf_ate:.6f}, frame ATE {frame_ate:.6f}, launches {total}, per tracked frame "
          f"{res['launches_per_tracked_frame']}, per KF insertion {res['launches_per_kf_insertion']}")
    print(f"{name} per-frame ms: median {res['frame_ms_median']:.3f}, p90 "
          f"{res['frame_ms_p90']:.3f}; KF insertion ms: median {res['kf_insert_ms_median']:.3f} "
          f"over {len(kf_ms)} insertions  [{card}]")
    return res


def _camera(torch_synth, cfg_mod):
    return cfg_mod.CameraConfig(fx=torch_synth.FX, fy=torch_synth.FY, cx=torch_synth.CX,
                                cy=torch_synth.CY, width=torch_synth.W, height=torch_synth.H,
                                fps=10.0)


def run_scene(card: str):
    """The scene-only slice's path (phase 5)."""
    import dataclasses
    import torch_synth
    from textslam_tpu_torch import config
    from textslam_tpu_torch.frontend import tracking
    from textslam_tpu_torch.ops import matching
    from textslam_tpu_torch.solver import ba
    from textslam_tpu_torch.system import TextSLAM

    frames, gt = torch_synth.render_sequence(N_SCENE_FRAMES, seed=0, kind="lateral")
    devices = set()
    watch = _watch(devices)
    orig = (tracking.fused_track_step, ba.solve_ba)
    tracking.fused_track_step, ba.solve_ba = watch(orig[0]), watch(orig[1])
    try:
        cfg = dataclasses.replace(config.TextSLAMConfig(no_text=True),
                                  camera=_camera(torch_synth, config))
        slam = TextSLAM(cfg, device="cuda")
        out = drive(slam, frames, None, {"hamming_matrix": matching.hamming_matrix})
    finally:
        tracking.fused_track_step, ba.solve_ba = orig
    res = _summary("scene", frames, *out[:4], slam, gt, *out[4:], devices, card)
    check(res["launches"]["hamming_matrix"] > 0, "scene: the Hamming kernel was never launched")
    check(res["frame_ate"] < FRAME_ATE_MAX, f"scene: frame ATE {res['frame_ate']}")
    return res


def text_setup(n_frames: int = N_TEXT_FRAMES, seed: int = 0):
    """The text run's input and system: n_frames of the rendered 640x480
    text world (world seed 0, lateral path) with ground-truth detections,
    and TextSLAM(TextSLAMConfig(seed=seed), device="cuda") with the
    renderer's camera (seed drives two-view and theta RANSAC). Returns
    (slam, frames, detections, ground-truth Tcw, world)."""
    import dataclasses
    import torch_synth
    from textslam_tpu_torch import config
    from textslam_tpu_torch.system import TextSLAM

    frames, dets, gt, world = torch_synth.render_text_sequence(n_frames, seed=0)
    cfg = dataclasses.replace(config.TextSLAMConfig(seed=seed),
                              camera=_camera(torch_synth, config))
    check(not cfg.no_text, "the default configuration runs text")
    return TextSLAM(cfg, device="cuda"), frames, dets, gt, world


def text_planes(slam, gt, world, excused=frozenset()):
    """Every GOOD object's plane normal against ground truth, held to the
    bars tests/test_e2e_text.py holds the JAX package to; `excused` objects
    (ids) are reported but their own bar is held elsewhere. Returns (GOOD
    count, [{tid, string, kf_obs, box_px, cos, bar}], [failed bars])."""
    import numpy as np
    import torch_synth
    from textslam_tpu_torch.mapper.state import TEXT_GOOD

    m = slam.map
    good = [t for t in range(m.n_texts) if m.tx_valid[t] and m.tx_state[t] == TEXT_GOOD]
    cosines = []
    for tid in good:
        boxes = [b for b in world.boxes if b[2] == m.tx_string[tid]]
        if not boxes:
            continue
        # the host's ground truth by its timestamp, the index of the rendered
        # frame (frames fed again keep theirs)
        host = m.keyframes[int(m.tx_host[tid])]
        th_gt = torch_synth.plane_theta_in_cam(world.planes[boxes[0][0]][0],
                                               gt[int(host.timestamp)])
        th = m.tx_theta[tid]
        cos = float(abs(th @ th_gt) / (np.linalg.norm(th) * np.linalg.norm(th_gt) + 1e-12))
        kf_obs = len(m.kfs_observing_text(tid))
        cosines.append({"tid": tid, "string": m.tx_string[tid], "kf_obs": kf_obs,
                        "box_px": float(np.ptp(m.tx_quad[tid][:, 0])), "cos": cos,
                        "bar": THETA_COS_MIN if kf_obs >= 3 else THETA_COS_BASIN})
    failed = [] if m.n_texts >= 2 else [f"only {m.n_texts} text objects"]
    for c in cosines:
        if not c["cos"] > c["bar"] and c["tid"] not in excused:
            failed.append(f"GOOD object {c['tid']} {c['string']} ({c['kf_obs']} KF obs, "
                          f"{c['box_px']:.1f} px wide) normal cos {c['cos']:.5f} <= {c['bar']}")
    if not any(c["kf_obs"] >= 3 for c in cosines):
        failed.append("no GOOD object with >= 3 KF observations")
    share = sum(c["cos"] > THETA_COS_CONVERGED for c in cosines) / max(len(cosines), 1)
    if share < CONVERGED_SHARE_MIN:
        failed.append(f"only {share:.0%} of GOOD planes at cos > {THETA_COS_CONVERGED}")
    return len(good), cosines, failed


# loop run: the JAX package's planes on the card's own maps, step by step
# (tests/loop_reference_steps.json, written by tests/loop_correct_compare.py
# from a chip_loop_dump.py run)
LOOP_REFERENCE = os.path.join("tests", "loop_reference_steps.json")
KF_FIELDS_DUMPED = ("kid", "frame_id", "timestamp", "kp_uv", "kp_level", "kp_angle", "kp_desc",
                    "kp_valid", "kp_point", "obs_good", "pyr_shapes", "det_quads", "det_text",
                    "det_object", "loop_edges")


def map_state(m) -> dict:
    """A deep copy of a port SlamMap's host state, in the layout
    textslam_tpu_torch.mapper.state.slam_map_from_numpy reads (keyframe
    pyramids left out)."""
    import copy
    from textslam_tpu_torch.mapper import state

    out = {name: getattr(m, name).copy() for name in state._MAP_ARRAYS}
    for name in ("n_points", "n_texts", "tx_string", "pt_obs", "tx_obs", "tx_obs_by_kid",
                 "tx_obs_by_tid", "tx_obs_good", "tx_feat_good", "saturation_drops"):
        out[name] = copy.deepcopy(getattr(m, name))
    out["keyframes"] = [{k: copy.deepcopy(getattr(kf, k)) for k in KF_FIELDS_DUMPED}
                        for kf in m.keyframes]
    return out


def map_digest(state: dict) -> str:
    """SHA-256 of a map_state() (the detection records left out: their
    quads are in det_quads): equal digests mean bit-identical maps."""
    import hashlib
    import numpy as np

    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, np.ndarray):
            h.update(f"{x.dtype}{x.shape}".encode())
            h.update(np.ascontiguousarray(x).tobytes())
        elif isinstance(x, dict):
            for k in sorted(x, key=repr):
                if k != "det_text":
                    feed(repr(k))
                    feed(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(b"[")
            for v in x:
                feed(v)
            h.update(b"]")
        else:
            h.update(repr(x).encode())

    feed(state)
    return h.hexdigest()


def _reference_misses(steps, record):
    """Hold every GOOD object that a plane-moving step of the loop run left
    outside its bar against the JAX package on the same input: the record
    of the step's input map (by digest) must hold the same object (string)
    with the JAX package's plane outside the same bar. Returns the misses
    that are not the reference's own."""
    by_digest = {r["digest"]: r for r in record["steps"]}
    bad = []
    for i, st in enumerate(steps):
        ref = by_digest.get(st["digest"])
        for c in st["misses"]:
            where = (f"step {i} ({st['name']}): GOOD object {c['tid']} {c['string']} "
                     f"({c['kf_obs']} KF obs) normal cos {c['cos']:.5f} <= {c['bar']}")
            obj = None if ref is None else ref["objects"].get(str(c["tid"]))
            if obj is None:
                bad.append(f"{where}, and {LOOP_REFERENCE} has no JAX result for this input "
                           f"(map digest {st['digest'][:16]}); rerun chip_loop_dump.py and "
                           f"tests/loop_correct_compare.py --write-record")
            elif obj["string"] != c["string"] or obj["jax"] > c["bar"]:
                bad.append(f"{where}, where the JAX package on the same map ends at "
                           f"{obj['string']} cos {obj['jax']:.5f}")
    return bad


def _planes_line(cosines):
    return f"{[(c['string'], c['kf_obs'], round(c['cos'], 5)) for c in cosines]}"


def run_text(card: str):
    """This slice's path, the default configuration with text (phase 6)."""
    from textslam_tpu_torch.frontend import text
    from textslam_tpu_torch.ops import matching, patch_sample
    from textslam_tpu_torch.solver import ba

    slam, frames, dets, gt, world = text_setup()
    devices = set()
    watch = _watch(devices)
    shapes = {}  # (groups, samples per group, level H, level W) -> sampler calls
    sample_values = ba._sample_text_values

    def census(images, tgt, uv, pair_feat):
        if pair_feat > 0:  # the grouped contract, i.e. the sampler kernel
            key = (uv.shape[0] // pair_feat, pair_feat * uv.shape[1], images.shape[1],
                   images.shape[2])
            shapes[key] = shapes.get(key, 0) + 1
        return sample_values(images, tgt, uv, pair_feat)

    orig = (text.fused_frame_chain, text.fused_ba_schedule, ba.solve_ba)
    text.fused_frame_chain, text.fused_ba_schedule, ba.solve_ba = (watch(f) for f in orig)
    ba._sample_text_values = census
    try:
        out = drive(slam, frames, dets, {"hamming_matrix": matching.hamming_matrix,
                                         "grouped_bilinear_stack":
                                             patch_sample.grouped_bilinear_stack})
    finally:
        text.fused_frame_chain, text.fused_ba_schedule, ba.solve_ba = orig
        ba._sample_text_values = sample_values
    res = _summary("text", frames, *out[:4], slam, gt, *out[4:], devices, card)
    for k, n in res["launches"].items():
        check(n > 0, f"text: the {k} kernel was never launched")
    per = (res["launches_per_tracked_frame"]["hamming_matrix"],
           res["launches_per_kf_insertion"]["hamming_matrix"])
    check(per == (HAMMING_PER_FRAME, HAMMING_PER_KF),
          f"text: Hamming launches per tracked frame / KF insertion {per}, want "
          f"{(HAMMING_PER_FRAME, HAMMING_PER_KF)} (one per search)")
    n_good, cosines, failed = text_planes(slam, gt, world)
    print(f"text objects: {slam.map.n_texts}, GOOD {n_good}; GOOD normals vs ground truth "
          f"(string, KF observations, cos): {_planes_line(cosines)}")
    check(not failed, f"text: {failed}")
    res.update(n_texts=int(slam.map.n_texts), n_good=n_good, theta_cos=cosines,
               sampler_shapes=[[*k, n] for k, n in sorted(shapes.items())])
    print(f"sampler calls by (groups, samples/group, level H, level W): {sorted(shapes.items())}")
    return res


# host milliseconds spent in phase 7's checks (loop-time kernel calls held
# against their plain versions, map digests); the closure's timers leave
# them out
CHECK_MS = [0.0]


def _sync_timer(times, key):
    """A wrapper factory adding the synchronized wall milliseconds of each
    call, less the kernel checks made inside it, to times[key]."""
    import torch

    def wrap(fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), CHECK_MS[0]
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times.setdefault(key, []).append((time.perf_counter() - t0) * 1e3
                                              - (CHECK_MS[0] - c0))
            return out
        return wrapped
    return wrap


def _kernel_checks(matching, patch_sample, label="loop"):
    """Wrap hamming_matrix, hamming_matrix_min and grouped_bilinear_stack
    (the module attributes the path calls) so that, while state["on"] is
    set, every call is also computed by its plain version on the same
    tensors and held to it: Hamming distances exactly, sampler masks exactly
    and values within SAMPLER_ATOL. The plain versions launch no kernel, so
    the launch counts stay the path's own. Returns (state, restore): state
    ["stats"] maps each wrapper to its checked calls, input shapes and max
    abs error; restore() puts the wrappers back."""
    import torch

    state = {"on": False, "stats": {}}
    names = ("hamming_matrix", "hamming_matrix_min", "grouped_bilinear_stack")
    mods = (matching, matching, patch_sample)
    orig = {n: getattr(mod, n) for n, mod in zip(names, mods)}

    class Checked:
        """The wrapper in the module's place; its `launches` is the wrapped
        function's, which the kernel launches count through the module."""

        def __init__(self, fn, call):
            self.fn, self.call = fn, call

        def __call__(self, *args, **kw):
            return self.call(*args, **kw)

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, n):
            self.fn.launches = n

    def wrap(name, mod):
        fn, plain = orig[name], getattr(mod, name + "_plain")

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if not state["on"]:
                return out
            t0 = time.perf_counter()  # the sync below is part of the check
            torch.cuda.synchronize()
            want = plain(*args, **kw)
            if name == "grouped_bilinear_stack":
                (vals, mask), (pv, pm) = out, want
                shape = (tuple(args[0].shape), tuple(args[2].shape[:2]))
                check(torch.equal(mask, pm), f"{label}: sampler masks differ from the plain "
                                             f"version at stack {shape[0]}, [G, Q] {shape[1]}")
                err = float((vals - pv).abs().max()) if vals.numel() else 0.0
                check(err <= SAMPLER_ATOL, f"{label}: sampler kernel vs plain max err {err} at "
                                           f"stack {shape[0]}, [G, Q] {shape[1]}")
            else:
                shape = (args[0].shape[0], args[-1].shape[0])
                err = float((out - want).abs().max()) if out.numel() else 0.0
                check(torch.equal(out, want), f"{label}: {name} kernel != plain at {shape} "
                                              f"(max err {err})")
            st = state["stats"].setdefault(name, {"calls": 0, "max_abs_err": 0.0, "shapes": {}})
            st["calls"] += 1
            st["max_abs_err"] = max(st["max_abs_err"], err)
            st["shapes"][shape] = st["shapes"].get(shape, 0) + 1
            CHECK_MS[0] += (time.perf_counter() - t0) * 1e3
            return out
        return Checked(fn, wrapped)

    for n, mod in zip(names, mods):
        setattr(mod, n, wrap(n, mod))

    def restore():
        for n, mod in zip(names, mods):
            setattr(mod, n, orig[n])
    return state, restore


def loop_setup():
    """The loop run's input and system: N_LOOP_FRAMES frames of the rendered
    640x480 text world's outback path (world seed 0) with ground-truth
    detections, and TextSLAM(TextSLAMConfig(), device="cuda") with the
    renderer's camera at LOOP_FPS, test_e2e_loop's loop gates and its
    amnesia hooks. Returns (slam, frames, detections, ground-truth Tcw,
    world, track), where track(img, t, detections) feeds a frame as
    track_monocular does and, at the fixture's frames, sets the amnesia:
    from the middle on, the tracker forgets the points and text objects
    hosted in the first quarter's keyframes. Setting amnesia["cutoff"] to
    None lifts it."""
    import dataclasses
    import torch_synth
    from textslam_tpu_torch import config
    from textslam_tpu_torch.system import TextSLAM

    frames, dets, gt, world = torch_synth.render_text_sequence(N_LOOP_FRAMES, seed=0,
                                                               kind="outback")
    cfg = dataclasses.replace(
        config.TextSLAMConfig(),
        camera=dataclasses.replace(_camera(torch_synth, config), fps=LOOP_FPS),
        loop=config.LoopConfig(**LOOP_GATES))
    check(not cfg.no_text, "the default configuration runs text")
    slam = TextSLAM(cfg, device="cuda")
    return slam, frames, dets, gt, world, amnesia_track(slam, N_LOOP_FRAMES // 4,
                                                        N_LOOP_FRAMES // 2)


def amnesia_track(slam, forget_before: int, from_frame: int, quarter: int | None = None):
    """tests/test_e2e_loop.py's amnesia hooks on `slam`: from frame
    `from_frame` on, the tracker forgets the points and text objects hosted
    in the keyframes made before frame `forget_before`, so a return to that
    stretch maps it again and the two eras share no landmark. Returns
    track(img, t, detections), which feeds a frame as track_monocular does
    and sets the amnesia at those frames; track.amnesia["cutoff"] = None
    lifts it. A system resumed past frame `forget_before` is given the
    keyframe count read there (`quarter`, track.amnesia["quarter"] of the
    run that saved it)."""
    import numpy as np

    amnesia = {"cutoff": None}
    if quarter is not None:
        amnesia["quarter"] = quarter

    def amnesia_hook(pt_valid):
        cut = amnesia["cutoff"]
        if cut is not None:
            n = min(slam.map.n_points, len(pt_valid))
            pt_valid[:n] &= ~(slam.map.pt_host[:n] < cut)
        return pt_valid

    def text_amnesia_mask(n_texts):
        mask = np.ones(n_texts, bool)
        if amnesia["cutoff"] is not None:
            mask &= ~(slam.map.tx_host[:n_texts] < amnesia["cutoff"])
        return mask

    slam.tracker.pt_candidate_hook = amnesia_hook
    slam.tracker.text_frontend.pool_mask_hook = text_amnesia_mask
    feed = slam.track_monocular

    def track(img, t, detections=None):
        if int(t) == forget_before:
            amnesia["quarter"] = len(slam.map.keyframes)
        if int(t) == from_frame:
            amnesia["cutoff"] = amnesia["quarter"]
        return feed(img, t, detections=detections)

    track.amnesia = amnesia
    return track


def run_loop(card: str):
    """The loop-closing slice (phase 7): test_e2e_loop's out-and-back
    fixture at 640x480 through the default configuration on the card."""
    import numpy as np
    import torch
    from textslam_tpu_torch.frontend import text
    from textslam_tpu_torch.ops import matching, patch_sample
    from textslam_tpu_torch.solver import ba, sim3_opt

    slam, frames, dets, gt, world, track = loop_setup()
    tr, lc = slam.tracker, slam.loop_closer
    counters = {"hamming_matrix": matching.hamming_matrix,
                "grouped_bilinear_stack": patch_sample.grouped_bilinear_stack}
    track_monocular = slam.track_monocular

    # instrumentation: devices of the Sim3 / pose-graph / BA tensors, the
    # closure's parts (synchronized), launches inside each closer run and
    # inside the landmark-only BA
    devices, parts = set(), {}
    watch = _watch(devices)
    runs = []
    run, local_ba = lc.run, tr._local_ba
    # every kernel call made at loop time (in the closer's runs and in
    # landmark_theta_pass) is held against its plain version on its inputs
    checks, restore_checks = _kernel_checks(matching, patch_sample)

    def run_counted(kid):
        before = {k: fn.launches for k, fn in counters.items()}
        n_parts = {k: len(v) for k, v in parts.items()}
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), CHECK_MS[0]
        checks["on"] = True
        try:
            closed = run(kid)
        finally:
            checks["on"] = False
        torch.cuda.synchronize()
        runs.append({"kid": kid, "closed": closed,
                     "ms": (time.perf_counter() - t0) * 1e3 - (CHECK_MS[0] - c0),
                     "searches": lc.n_searches,
                     "launches": {k: fn.launches - before[k] for k, fn in counters.items()},
                     "parts": {k: v[n_parts.get(k, 0):] for k, v in parts.items()
                               if len(v) > n_parts.get(k, 0)}})
        return closed

    # from the correction on, every step that can move a text plane (each
    # Tracker._local_ba, landmark_theta_pass): the digest of the map it
    # starts from and the GOOD objects it leaves outside their bars
    steps, correcting = [], [False]

    def plane_step(name, fn, *args, **kw):
        if not correcting[0]:
            return fn(*args, **kw)
        t0 = time.perf_counter()
        digest = map_digest(map_state(slam.map))
        CHECK_MS[0] += (time.perf_counter() - t0) * 1e3
        out = fn(*args, **kw)
        t0 = time.perf_counter()
        cos = text_planes(slam, gt, world)[1]
        steps.append({"name": name, "digest": digest,
                      "misses": [c for c in cos if not c["cos"] > c["bar"]]})
        CHECK_MS[0] += (time.perf_counter() - t0) * 1e3
        return out

    def local_ba_counted(window_kids, fix, init_ba=False, scene_only=False,
                         landmark_only=False):
        before = patch_sample.grouped_bilinear_stack.launches
        key = ("landmark_ba" if landmark_only else "global_ba" if scene_only
               else None)
        fn = local_ba if key is None else _sync_timer(parts, key)(local_ba)
        out = plane_step(f"local_ba {key or 'window'} over {len(window_kids)} KFs", fn,
                         window_kids, fix, init_ba=init_ba, scene_only=scene_only,
                         landmark_only=landmark_only)
        if landmark_only:
            parts.setdefault("landmark_ba_sampler_launches", []).append(
                patch_sample.grouped_bilinear_stack.launches - before)
        return out

    correct = lc.correct

    planes_before = []

    def correct_reporting(*args, **kw):
        planes_before.append(_planes_line(text_planes(slam, gt, world)[1]))
        correcting[0] = True
        return correct(*args, **kw)

    lc.run, tr._local_ba, lc.correct = run_counted, local_ba_counted, correct_reporting
    lc.detect = _sync_timer(parts, "detect")(lc.detect)
    lc.compute_sim3 = _sync_timer(parts, "compute_sim3")(lc.compute_sim3)
    lc._search_and_fuse = _sync_timer(parts, "search_and_fuse")(lc._search_and_fuse)
    orig = (text.fused_frame_chain, text.fused_ba_schedule, ba.solve_ba,
            sim3_opt.sim3_ransac_sets, sim3_opt.refine_sim3, sim3_opt.solve_pose_graph)
    text.fused_frame_chain, text.fused_ba_schedule, ba.solve_ba = (watch(f) for f in orig[:3])
    sim3_opt.sim3_ransac_sets, sim3_opt.refine_sim3, sim3_opt.solve_pose_graph = (
        _sync_timer(parts, k)(watch(f))
        for k, f in zip(("sim3_ransac", "refine_sim3", "pose_graph"), orig[3:]))
    post_hosts = []
    try:
        slam.track_monocular = track
        out = drive(slam, frames, dets, counters)
        track.amnesia["cutoff"] = None
        # post-loop re-tracking: the last frames again, amnesia lifted; the
        # hosts of the points the per-frame matcher consumes
        chain = tr._chain_frame

        def chain_recording(frame, guess, radius_scale=1.0):
            trk, hook, imm = chain(frame, guess, radius_scale)
            m = slam.map
            sel = np.nonzero(trk[2])[0]
            post_hosts.append(m.pt_host[sel[sel < m.n_points]].copy())
            return trk, hook, imm

        tr._chain_frame = chain_recording
        for i in range(N_LOOP_FRAMES - N_LOOP_REFEED, N_LOOP_FRAMES):
            track_monocular(frames[i], float(i), detections=dets[i])
        tr._chain_frame = chain
        launches_run = {k: fn.launches for k, fn in counters.items()}
    finally:
        (text.fused_frame_chain, text.fused_ba_schedule, ba.solve_ba, sim3_opt.sim3_ransac_sets,
         sim3_opt.refine_sim3, sim3_opt.solve_pose_graph) = orig
        restore_checks()
    loop_checks = checks["stats"]
    for name, st in sorted(loop_checks.items()):
        print(f"closer runs: {name} calls held against the plain version {st['calls']}, max "
              f"abs err {st['max_abs_err']:.3g}; calls by shape {st['shapes']}")
    for k in ("hamming_matrix_min", "grouped_bilinear_stack"):
        check(loop_checks.get(k, {}).get("calls", 0) > 0,
              f"loop: no loop-time {k} call was held against the plain version")
    res = _summary("loop", frames, *out[:4], slam, gt, *out[4:], devices, card)
    m = slam.map
    closed = [r for r in runs if r["closed"]]
    check(lc.closed_loops and len(closed) == len(lc.closed_loops), f"loop: no loop closed {runs}")
    cur, cand = lc.closed_loops[0]
    check(cand < cur, f"loop: closed {cur} -> {cand}, not to an older keyframe")
    check(m.pt_bad[: m.n_points].sum() > 0 or (~m.tx_valid[: m.n_texts]).sum() > 0,
          "loop: no landmark fused")
    check(res["kf_ate"] < LOOP_ATE_MAX, f"loop: post-loop keyframe ATE {res['kf_ate']}")
    K = len(m.keyframes)
    bridge = int(m.M1[: cand + 1, cand + 1: K].sum() + m.M2[: cand + 1, cand + 1: K].sum())
    check(bridge > 0, "loop: the two legs share no landmark after the closure")
    old = np.concatenate(post_hosts) if post_hosts else np.zeros(0, int)
    check((old <= cand).sum() > 0, f"loop: no first-leg point re-entered tracking "
                                   f"({np.unique(old)})")
    for r in runs:  # every closer run: one Hamming launch per search
        check(r["launches"]["hamming_matrix"] == r["searches"],
              f"loop: Hamming launches {r['launches']['hamming_matrix']} != searches "
              f"{r['searches']} at keyframe {r['kid']}")
    check(closed[0]["searches"] > 0, "loop: the closure searched no descriptors")
    lm_launches = parts.get("landmark_ba_sampler_launches", [0])
    check(all(n > 0 for n in lm_launches), f"loop: sampler launches in the landmark-only BA "
                                            f"{lm_launches}")
    print(f"GOOD normals just before the correction: {planes_before[0]}")
    # the text bars on every GOOD object; an object a step of the loop run
    # left outside its bar passes only where the JAX package, given the same
    # map (by digest), leaves it outside the same bar (_reference_misses)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), LOOP_REFERENCE)) as f:
        record = json.load(f)
    check(steps, "loop: no plane-moving step after the correction was recorded")
    check(not _reference_misses(steps, record),
          f"loop: text planes off the reference's: {_reference_misses(steps, record)}")
    n_good, cosines, failed = text_planes(slam, gt, world,
                                          excused={c["tid"] for c in steps[-1]["misses"]})
    print(f"loop text objects: {m.n_texts} ({int((~m.tx_valid[: m.n_texts]).sum())} fused "
          f"away), GOOD {n_good}; GOOD normals (string, KF observations, cos): "
          f"{_planes_line(cosines)}")
    check(not failed, f"loop: {failed}")

    # landmark_theta_pass on the post-loop map (the run reaches it only past
    # global_decompose_kfs keyframes): finite thetas within the text bars
    before = patch_sample.grouped_bilinear_stack.launches
    checks, restore_checks = _kernel_checks(matching, patch_sample)
    checks["on"] = True
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), CHECK_MS[0]
    try:
        n_upd = plane_step("landmark_theta_pass", tr.text_frontend.landmark_theta_pass)
    finally:
        restore_checks()
    torch.cuda.synchronize()
    theta_ms = (time.perf_counter() - t0) * 1e3 - (CHECK_MS[0] - c0)
    theta_launches = patch_sample.grouped_bilinear_stack.launches - before
    check(n_upd > 0 and theta_launches > 0, f"loop: landmark_theta_pass refined {n_upd} objects "
                                             f"with {theta_launches} sampler launches")
    check(np.isfinite(m.tx_theta[: m.n_texts]).all(), "loop: non-finite theta after the pass")
    check(not _reference_misses(steps[-1:], record),
          f"loop: text planes off the reference's: {_reference_misses(steps[-1:], record)}")
    _, cosines2, failed2 = text_planes(slam, gt, world,
                                       excused={c["tid"] for c in steps[-1]["misses"]})
    print(f"after landmark_theta_pass ({n_upd} objects, {theta_launches} sampler launches, "
          f"{theta_ms:.1f} ms): GOOD normals {_planes_line(cosines2)}  [{card}]")
    check(not failed2, f"loop, after landmark_theta_pass: {failed2}")
    by_digest = {r["digest"]: r for r in record["steps"]}
    ref_misses = [{"step": i, "name": st["name"], "digest": st["digest"], "tid": c["tid"],
                   "string": c["string"], "kf_obs": c["kf_obs"], "bar": c["bar"],
                   "cos": c["cos"], "jax_cos": by_digest[st["digest"]]["objects"][
                       str(c["tid"])]["jax"]}
                  for i, st in enumerate(steps) for c in st["misses"]]
    print(f"loop run, {len(steps)} plane-moving steps from the correction on; GOOD objects a "
          f"step left outside their bar, each the JAX package's own miss on the same map "
          f"(step, tid, string, KF obs, bar, cos here, JAX cos): "
          f"{[(r['step'], r['tid'], r['string'], r['kf_obs'], r['bar'], round(r['cos'], 5), round(r['jax_cos'], 5)) for r in ref_misses]}")
    print(f"map digests of the steps' inputs: {[st['digest'][:16] for st in steps]}")
    for name, st in sorted(checks["stats"].items()):
        print(f"landmark_theta_pass: {name} calls held against the plain version "
              f"{st['calls']}, max abs err {st['max_abs_err']:.3g}; calls by shape "
              f"{st['shapes']}")
    check_stats = {k: {**v, "shapes": [[str(s), n] for s, n in v["shapes"].items()]}
                   for k, v in loop_checks.items()}
    for k, v in checks["stats"].items():
        st = check_stats.setdefault(k, {"calls": 0, "max_abs_err": 0.0, "shapes": []})
        st["calls"] += v["calls"]
        st["max_abs_err"] = max(st["max_abs_err"], v["max_abs_err"])

    c = closed[0]
    part_ms = {k: float(sum(v)) for k, v in c["parts"].items()
               if k != "landmark_ba_sampler_launches"}
    print(f"loop closure at keyframe {c['kid']} -> {cand}: {c['ms']:.1f} ms synchronized wall "
          f"time; parts (ms, summed over the closure's calls): "
          f"{ {k: round(v, 2) for k, v in part_ms.items()} }; {c['searches']} descriptor "
          f"searches, launches {c['launches']}; sampler launches in the landmark-only BA "
          f"{lm_launches}  [{card}]")
    print(f"loop closer runs: {[(r['kid'], r['closed'], round(r['ms'], 1), r['searches']) for r in runs]}")
    res.update(closed_loops=[list(x) for x in lc.closed_loops], closure_ms=c["ms"],
               closure_parts_ms=part_ms, closure_searches=c["searches"],
               launches_loop_closure=c["launches"], launches_run=launches_run,
               landmark_ba_sampler_launches=lm_launches, theta_pass_objects=n_upd,
               theta_pass_sampler_launches=theta_launches, theta_pass_ms=theta_ms,
               n_texts=int(m.n_texts), n_good=n_good, theta_cos=cosines2, bridge=bridge,
               loop_kernel_checks=check_stats, reference_misses=ref_misses)
    return res


def _cli_ate(out_dir, gt):
    """(keyframe count, keyframe ATE) of a CLI run's keyframe.txt (TUM:
    Twc; timestamps are frame / fps)."""
    import torch_synth
    from textslam_tpu_torch.geometry import se3_np
    from textslam_tpu_torch.io.trajectory import read_tum

    ts, poses_wc = read_tum(os.path.join(out_dir, "keyframe.txt"))
    if len(ts) == 0:
        return 0, float("inf")
    return len(ts), torch_synth.ate_rmse(ts * CLI_FPS, se3_np.inverse(poses_wc), gt)


def check_fixtures() -> dict:
    """Decode every committed fixture of the reader (tests/jpeg/, tests/png/)
    with the port's decoders and hold it to the SHA-256, shape and dtype of
    cv2.imdecode(IMREAD_UNCHANGED) recorded by tests/jpeg_fixtures.py.
    Returns {set: files held}."""
    import hashlib
    import numpy as np
    from textslam_tpu_torch.io import dataset as tds

    out = {}
    for folder, record in FIXTURE_SETS:
        with open(os.path.join(HERE, "tests", record)) as f:
            want = json.load(f)
        t0 = time.perf_counter()
        for name, rec in sorted(want.items()):
            with open(os.path.join(HERE, "tests", folder, name), "rb") as f:
                arr = np.ascontiguousarray(tds.decode_image(f.read(), name))
            got = {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                   "shape": list(arr.shape), "dtype": str(arr.dtype)}
            check(got == rec, f"fixture {folder}/{name}: decoded {got}, cv2 recorded {rec}")
        out[folder] = len(want)
        print(f"cli: {len(want)} committed {folder} fixtures decode to cv2's recorded digests "
              f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    return out


def run_cli(card: str):
    """The CLI path (phase 8): a dataset written to disk in the reference
    layout (distorted PNG frames, OCR files, yamls), read, decoded and
    undistorted by the port's reader and driven through
    `textslam_tpu_torch.cli.main` on the card, with checkpoints and
    resumes."""
    import tempfile
    import numpy as np
    import torch
    import torch_synth
    from textslam_tpu_torch import cli
    from textslam_tpu_torch.config import load_yaml
    from textslam_tpu_torch.io import dataset as tds
    from textslam_tpu_torch.io import png
    from textslam_tpu_torch.io.trajectory import read_tum
    from textslam_tpu_torch.ops import matching, patch_sample
    from textslam_tpu_torch.system import TextSLAM

    res = {}
    with tempfile.TemporaryDirectory(prefix="textslam_cli_") as root:
        t0 = time.perf_counter()
        gt, world, written = torch_synth.write_dataset(root, N_CLI_FRAMES, seed=0, dist=CLI_DIST,
                                                       n_short=N_CLI_SHORT, fps=CLI_FPS)
        print(f"cli: wrote {N_CLI_FRAMES} distorted 640x480 frames (PNG, all five row filters), "
              f"their OCR files and the yamls in {time.perf_counter() - t0:.1f} s")
        root_jpg = os.path.join(root, "jpg")
        t0 = time.perf_counter()
        _, _, written_jpg = torch_synth.write_dataset(
            root_jpg, N_CLI_FRAMES, seed=0, dist=CLI_DIST, n_short=N_CLI_SHORT, fps=CLI_FPS,
            fmt="jpg", quality=CLI_JPEG_QUALITY)
        print(f"cli: wrote the JPEG twin (color baseline 4:2:0, quality {CLI_JPEG_QUALITY}, "
              f"torch_synth.encode_jpeg) in {time.perf_counter() - t0:.1f} s")
        # 0. the reader's committed fixtures decode to cv2's recorded digests
        res["fixtures"] = check_fixtures()
        # the JPEG twin's frames decode near the images encoded
        jerr = []
        for i, img in enumerate(written_jpg):
            with open(os.path.join(root_jpg, "images", f"{i:04d}.jpg"), "rb") as f:
                dec = tds.decode_image(f.read(), f"{i:04d}.jpg")
            check(dec.shape == img.shape and dec.dtype == np.uint8,
                  f"cli: JPEG frame {i} decodes to {dec.shape} {dec.dtype}")
            jerr.append(float(np.abs(dec.astype(np.int64) - img).mean()))
        print(f"cli: JPEG twin, mean abs error of the decode against the encoded image "
              f"{min(jerr):.3f}-{max(jerr):.3f} (BGR samples, bar {JPEG_TWIN_ERR_MAX})")
        check(max(jerr) < JPEG_TWIN_ERR_MAX, f"cli: JPEG twin decode error {max(jerr)}")
        # 1. decode: every frame exactly the uint8 image written
        for i, img in enumerate(written):
            with open(os.path.join(root, "images", f"{i:04d}.png"), "rb") as f:
                check(np.array_equal(png.decode(f.read()), img), f"cli: frame {i} decodes wrong")
        # 2. detections: read back as written (corners rounded as the
        # reference rounds them), the probe lines on frame 5
        for i, pose in enumerate(gt):
            got = tds.read_detections(tds.text_stem_for(root + "/", f"images/{i:04d}.png"))
            want = [(d.text, 0.9, 0, np.round(np.float32([float(f"{v:.2f}") for v in
                                                          d.quad.ravel()])).reshape(4, 2))
                    for d in world.detections(pose)]
            if i == 5:
                want += [("你好餐厅", 0.5, 1, np.float32([[1, 1], [9, 1], [9, 9], [1, 9]])),
                         ("#", 0.1, 0, np.float32([[11, 1], [19, 1], [19, 9], [11, 9]]))]
            check(len(got) == len(want) and all(
                (d.text, d.score, d.lang) == w[:3] and np.array_equal(d.quad, w[3])
                for d, w in zip(got, want)), f"cli: frame {i}: detections read back wrong")
        # 3. the undistorted frame: on the card, equal to the reader's on the
        # CPU, near the ideal render; a BGR frame's gray conversion on the card
        exp0 = load_yaml(os.path.join(root, "exp0.yaml"))
        with tds.Dataset(exp0, device="cuda") as ds, tds.Dataset(exp0, device="cpu") as ds_cpu:
            img, host = ds[5][0], ds_cpu[5][0]
            g = written[5].astype(np.uint8)
            bgr = np.stack([g, 255 - g, g.astype(np.int64) * 3 % 256], axis=-1).astype(np.uint8)
            bgr_dec = png.decode(torch_synth.encode_png(bgr))
            check(np.array_equal(bgr_dec, bgr), "cli: a BGR frame decodes wrong")
            b, gg, r = (bgr.astype(np.int64)[..., k] for k in range(3))
            for rgb in (False, True):
                want = ((b, r)[rgb] * 3735 + gg * 19235 + (r, b)[rgb] * 9798 + 16384) >> 15
                got = tds.to_gray(torch.from_numpy(bgr_dec).cuda(), rgb)
                check(got.is_cuda and np.array_equal(got.cpu().numpy(), want),
                      f"cli: gray conversion on the card (Camera.RGB {int(rgb)}) is not cv2's")
            color, color_host = ds.image(bgr_dec), ds_cpu.image(bgr_dec)
        check(img.is_cuda and img.dtype == torch.float32 and color.is_cuda,
              f"cli: frame on {img.device}")
        dev_err = max(float((img.cpu() - host).abs().max()),
                      float((color.cpu() - color_host).abs().max()))
        ideal = world.render(gt[5])
        c = (slice(120, 360), slice(160, 480))
        und_err = float(np.abs(img.cpu().numpy()[c] - ideal[c]).mean())
        print(f"cli: undistorted frame 5 on {img.device}: max abs difference from the reader "
              f"on the CPU {dev_err:.3e} (gray frame and a BGR one, bar {UNDISTORT_DEV_ATOL}); "
              f"central mean abs error vs the ideal render {und_err:.4f} gray (bar "
              f"{UNDISTORT_ERR_MAX})")
        check(dev_err <= UNDISTORT_DEV_ATOL, f"cli: undistortion on the card vs the CPU {dev_err}")
        check(und_err < UNDISTORT_ERR_MAX, f"cli: undistortion error {und_err}")
        res.update(undistort_err=und_err, undistort_card_vs_cpu=dev_err)

        # instruments: the reader's timings, the track and checkpoint times
        datasets, times = [], {}

        class Recorded(tds.Dataset):
            image = _sync_timer(times, "undistort")(tds.Dataset.image)

            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                datasets.append(self)

        orig = (tds.Dataset, TextSLAM.track_monocular, TextSLAM.save_checkpoint,
                TextSLAM.load_checkpoint)
        tds.Dataset = Recorded
        TextSLAM.track_monocular = _sync_timer(times, "track")(orig[1])
        TextSLAM.save_checkpoint = _sync_timer(times, "save")(orig[2])
        TextSLAM.load_checkpoint = _sync_timer(times, "load")(orig[3])
        checks, restore_checks = _kernel_checks(matching, patch_sample, label="cli")

        def run(yaml, out, *extra, at=root):
            rc = cli.main([os.path.join(at, yaml), os.path.join(at, out), *extra])
            check(rc == 0, f"cli: {yaml} -> {out} exited {rc}")

        try:
            # 4. the full CLI run, every kernel call held to its plain version
            counters = {"hamming_matrix": matching.hamming_matrix,
                        "grouped_bilinear_stack": patch_sample.grouped_bilinear_stack}
            for fn in counters.values():
                fn.launches = 0
            checks["on"] = True
            run("exp0.yaml", "out0", "--checkpoint-every", "8")
            checks["on"] = False
            launches = {k: fn.launches for k, fn in counters.items()}
            out0 = os.path.join(root, "out0")
            for name in ("keyframe.txt", "keyframe_latest.txt", "pose_F.txt", "checkpoint.npz"):
                check(os.path.exists(os.path.join(out0, name)), f"cli: {name} not written")
            n_kf, ate = _cli_ate(out0, gt)
            n_latest = len(read_tum(os.path.join(out0, "keyframe_latest.txt"))[0])
            ckpt_mb = os.path.getsize(os.path.join(out0, "checkpoint.npz")) / 2 ** 20
            stats = checks["stats"]
            res.update(
                keyframes=n_kf, kf_ate=ate, launches=launches,
                track_ms_median_checked_run=float(np.median(times["track"])),
                checkpoint_save_ms=times["save"], checkpoint_mb=ckpt_mb,
                calls_held={k: v["calls"] for k, v in stats.items()},
                max_abs_err={k: v["max_abs_err"] for k, v in stats.items()})
            print(f"cli run (exp 0, {N_CLI_FRAMES} frames, text on, --checkpoint-every 8): "
                  f"{n_kf} KFs (keyframe_latest {n_latest}), KF ATE {ate:.6f} (bar "
                  f"{CLI_ATE_MAX}), launches {launches}, calls held to the plain version "
                  f"{res['calls_held']} (max abs err {res['max_abs_err']})")
            png_read_ms = float(np.median(datasets[-1].read_ms))
            check(n_latest == n_kf, f"cli: keyframe_latest has {n_latest} KFs, keyframe {n_kf}")
            check(n_kf >= 3, f"cli: only {n_kf} keyframes")
            check(ate < CLI_ATE_MAX, f"cli: KF ATE {ate} >= {CLI_ATE_MAX}")
            for k, n in launches.items():
                check(n > 0, f"cli: the {k} kernel was never launched")
            # the same run again with the checks off, on the JPEG twin: the
            # per-frame medians
            times["track"], times["undistort"] = [], []
            for fn in counters.values():
                fn.launches = 0
            run("exp0.yaml", "out0_timed", at=root_jpg)
            launches_jpg = {k: fn.launches for k, fn in counters.items()}
            ds = datasets[-1]
            n_kf_j, ate_j = _cli_ate(os.path.join(root_jpg, "out0_timed"), gt)
            res.update(read_decode_ms_median_png=png_read_ms,
                       read_decode_ms_median=float(np.median(ds.read_ms)),
                       undistort_ms_median=float(np.median(times["undistort"])),
                       track_ms_median=float(np.median(times["track"])),
                       jpeg_keyframes=n_kf_j, jpeg_kf_ate=ate_j, jpeg_launches=launches_jpg)
            print(f"cli run on the JPEG twin (exp 0, checks off): {n_kf_j} KFs, KF ATE "
                  f"{ate_j:.6f} (bar {CLI_ATE_MAX}), launches {launches_jpg}")
            print(f"cli per-frame medians: read+decode PNG {png_read_ms:.3f} ms (the checked "
                  f"run), JPEG {res['read_decode_ms_median']:.3f} ms (host thread); on the JPEG "
                  f"run: undistort {res['undistort_ms_median']:.3f} ms (upload, gray and remap "
                  f"on the card, synchronized), track {res['track_ms_median']:.3f} ms (the "
                  f"checked PNG run, checks left out: {res['track_ms_median_checked_run']:.3f} "
                  f"ms); checkpoint save ms {[round(x, 1) for x in times['save']]}, "
                  f"{ckpt_mb:.1f} MB  [{card}]")
            check(n_kf_j >= 3, f"cli: only {n_kf_j} keyframes on the JPEG twin")
            check(ate_j < CLI_ATE_MAX, f"cli: KF ATE {ate_j} >= {CLI_ATE_MAX} on the JPEG twin")
            for k, n in launches_jpg.items():
                check(n > 0, f"cli: the {k} kernel was never launched on the JPEG twin")
            check(stats.get("grouped_bilinear_stack", {}).get("calls", 0) > 0
                  and sum(stats.get(k, {}).get("calls", 0)
                          for k in ("hamming_matrix", "hamming_matrix_min")) > 0,
                  f"cli: kernel calls not held to the plain version: {stats}")

            # 5. resume, scene only: the same keyframes as the uninterrupted run
            run("nt_full.yaml", "nt_a")
            run("nt_short.yaml", "nt_b", "--checkpoint-every", "6")
            run("nt_full.yaml", "nt_b", "--resume")
            (ts_a, p_a), (ts_b, p_b) = (read_tum(os.path.join(root, d, "keyframe.txt"))
                                        for d in ("nt_a", "nt_b"))
            same = len(ts_a) == len(ts_b) and np.allclose(ts_a, ts_b)
            diff = float(np.abs(p_a - p_b).max()) if same else float("inf")
            print(f"cli resume, scene only: {len(ts_a)} / {len(ts_b)} KFs uninterrupted / "
                  f"resumed, same timestamps {same}, max pose difference {diff:.3e} "
                  f"(bar {RESUME_POSE_DIFF})")
            check(len(ts_a) >= 3 and same and diff < RESUME_POSE_DIFF,
                  "cli: the resumed scene-only run is not the uninterrupted one")
            # 6. resume, text on
            run("t_short.yaml", "t_b", "--checkpoint-every", "6")
            run("exp0.yaml", "t_b", "--resume")
            n_kf_r, ate_r = _cli_ate(os.path.join(root, "t_b"), gt)
            print(f"cli resume, text on: {n_kf_r} KFs, KF ATE {ate_r:.6f} (bar {CLI_ATE_MAX}); "
                  f"checkpoint load ms {[round(x, 1) for x in times['load']]}  [{card}]")
            check(n_kf_r >= 3 and ate_r < CLI_ATE_MAX, f"cli: text-on resume KF ATE {ate_r}")
            # 7. experiments 1-3 over their list
            exps = {}
            for exp in (1, 2, 3):
                run(f"exp{exp}.yaml", f"out{exp}")
                exps[exp] = _cli_ate(os.path.join(root, f"out{exp}"), gt)[0]
            print(f"cli experiments 1-3 (Imshort): keyframes {exps}")
            check(all(n >= 2 for n in exps.values()), f"cli: experiments 1-3 keyframes {exps}")
        finally:
            restore_checks()
            tds.Dataset, TextSLAM.track_monocular, TextSLAM.save_checkpoint, \
                TextSLAM.load_checkpoint = orig
    res.update(resume_scene_kfs=len(ts_b), resume_scene_pose_diff=diff, resume_text_kf_ate=ate_r,
               checkpoint_load_ms=times["load"], experiment_kfs=exps)
    return res


# phase 9: scale-out. The machine has one card, so the mesh is two shards on
# cuda:0 (the sharded path on one card, as the JAX tests run it on virtual
# CPU devices); NCCL between two cards is not exercised
MESH_SHARDS = 2
# bench.py's problem: a 20-KF window, 8,192 points, 512 observations per KF,
# 32 texts x 64 features (10,240 scene and 20,480 text rows)
BENCH_PROBLEM = dict(n_kf=20, n_pts=8192, obs_per_kf=512, n_text=32, text_feat=64,
                     with_text=True)
BA_ITERS = 10
LM_COST_RTOL = 1e-3  # whole solves: final cost (tests/test_torch_parallel.py)
LM_POSE_ATOL = 1e-4
MESH_POSE_DIFF = 5e-3  # mesh text run vs phase 6's (up to scale): tests/test_e2e_mesh.py's bar
# the mesh text runs' Sim3 scale against phase 6's: a gauge the LM moves
# along (chip_mesh_scale.py), so this factor either way catches a collapsed
# or exploded map, not drift
MESH_SCALE_BAND = 1.5
COVIS_KS = (5, 64, 200, 512)  # keyframes; 512 x 32768 is the default pools' cap
COVIS_POINTS = 32768
COVIS_DENSITY = 0.03  # share of the pool a keyframe observes (~1,000 points)
MP_TIMEOUT_S = 300  # each spawned process group, set-up included


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def wall_ms(fn, reps: int = 3):
    """(median synchronized wall milliseconds of fn over reps calls after
    one warm-up call, the last result)."""
    import statistics

    out = fn()
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        out = fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _violations(got, want, rtol: float, atol: float):
    """(count, worst |got - want|) of entries outside atol + rtol |want|."""
    import torch

    got, want = got.double(), want.double().to(got.device)
    d = (got - want).abs()
    bad = d > atol + rtol * want.abs()
    return int(bad.sum()), float(d.max()) if d.numel() else 0.0


def _single_systems(prob):
    """One device's scene and text systems: ((Hcc, bc, W, Hll, bl, cost),
    (Hcc, bc, Wt, Ht, bt, cost))."""
    from textslam_tpu_torch.solver import ba

    K, P, T = prob.poses.shape[0], prob.rho.shape[0], prob.theta.shape[0]
    s, t = prob.scene, prob.text
    ts = ba.scene_terms(prob, 2.447)
    scene = (*ba.assemble_camera_system(ts, s.tgt, s.host, K),
             *ba.assemble_landmark_system(ts, s.tgt, s.host, s.point, P, K, 1), ts["cost"].sum())
    tt = ba.text_terms(prob, 3.0)
    text = (*ba.assemble_camera_system(tt, t.tgt, t.host, K),
            *ba.assemble_landmark_system(tt, t.tgt, t.host, t.text, T, K, 3), tt["cost"].sum())
    return scene, text


def _hold_assembly(label, got, want, tols):
    """Hold a sharded assembly to one device's, block by block, at
    tests/test_parallel.py's tolerances; returns {block: worst abs diff}."""
    out = {}
    for name, g, w, (rtol, atol) in zip(("Hcc", "bc", "W", "Hll", "bl"), got, want, tols):
        n_bad, worst = _violations(g, w, rtol, atol)
        check(n_bad == 0, f"{label}: sharded {name} differs from one device's at {n_bad} "
                          f"entries (worst {worst}; rtol {rtol}, atol {atol})")
        out[name] = worst
    c, c0 = float(got[5]), float(want[5])
    check(abs(c - c0) <= 1e-4 * max(1.0, abs(c0)), f"{label}: sharded cost {c} vs {c0}")
    return out


def run_sharded_ba(card: str, device="cuda"):
    """Phase 9(a): bench.py's problem on a 2-shard mesh of one card: one
    sharded assembly against one device's, solve_ba_sharded against
    solve_ba, the landmark-sharded step against the observation-sharded
    one, and the synchronized wall time of each solve."""
    import numpy as np
    import torch
    import torch_synth
    from textslam_tpu_torch.parallel import ba_sharded
    from textslam_tpu_torch.parallel.mesh import Mesh
    from textslam_tpu_torch.solver import ba

    dev = torch.device(device)
    mesh = Mesh([dev] * MESH_SHARDS)
    prob = ba.ba_problem_from_numpy(torch_synth.ba_problem_arrays(**BENCH_PROBLEM), device=dev)
    res = {"problem": {k: v for k, v in BENCH_PROBLEM.items() if k != "with_text"},
           "scene_rows": int(prob.scene.tgt.shape[0]), "text_rows": int(prob.text.tgt.shape[0]),
           "shards": [str(d) for d in mesh.devices]}
    # one assembly, scene and text, at tests/test_parallel.py:32-35's
    # tolerances (Hcc, bc, W: rtol 5e-4, atol 2e-3; Hll: atol 1e-4)
    one_scene, one_text = _single_systems(prob)
    tols = [(5e-4, 2e-3)] * 3 + [(5e-4, 1e-4), (5e-4, 2e-3)]
    res["assembly_worst_abs_diff"] = {
        "scene": _hold_assembly("9a scene", ba_sharded.sharded_scene_normal_eqs(prob, mesh, 2.447),
                                one_scene, tols),
        "text": _hold_assembly("9a text", ba_sharded.sharded_text_normal_eqs(prob, mesh, 3.0),
                               one_text, tols)}
    # the LM: sharded against one device with the same sampling (per-feature
    # patches), and the fused schedule's solve (region sampler) for time
    F = BENCH_PROBLEM["text_feat"]
    ms = {}
    ms["solve_ba"], st1 = wall_ms(lambda: ba.solve_ba(prob, n_iters=BA_ITERS))
    ms["solve_ba_pair_feat"], stf = wall_ms(
        lambda: ba.solve_ba(prob, n_iters=BA_ITERS, text_pair_feat=F))
    ms["solve_ba_sharded"], st2 = wall_ms(
        lambda: ba_sharded.solve_ba_sharded(prob, mesh, n_iters=BA_ITERS))
    c1, c2, cf = float(st1.cost), float(st2.cost), float(stf.cost)
    pose_diff = float((st2.poses - st1.poses).abs().max())
    check(abs(c2 - c1) <= LM_COST_RTOL * max(1.0, c1),
          f"9a: solve_ba_sharded cost {c2} vs solve_ba {c1}")
    check(pose_diff <= LM_POSE_ATOL, f"9a: solve_ba_sharded poses {pose_diff} from solve_ba's")
    # the landmark-sharded step against the observation-sharded step (scene)
    sp = prob._replace(text=None, theta=None, theta_free=None, images=None)
    ms["sharded_ba_step"], (p0, r0, k0) = wall_ms(lambda: ba_sharded.sharded_ba_step(sp, mesh))
    ms["sharded_ba_step_landmark"], (p1, r1, k1) = wall_ms(
        lambda: ba_sharded.sharded_ba_step_landmark(sp, mesh))
    lm = {"cost": abs(float(k1) - float(k0)) / max(1.0, abs(float(k0))),
          "poses": _violations(p1, p0, 1e-4, 1e-5), "rho": _violations(r1, r0, 1e-4, 1e-5)}
    check(lm["cost"] <= 1e-5 and lm["poses"][0] == 0 and lm["rho"][0] == 0,
          f"9a: landmark-sharded step vs observation-sharded step {lm}")
    res.update(cost_solve_ba=c1, cost_solve_ba_sharded=c2, cost_solve_ba_pair_feat=cf,
               pose_diff=pose_diff, landmark_step_vs_obs_step=lm, ms=ms)
    print(f"9a sharded BA on {mesh.size} shards ({', '.join(res['shards'])}), bench.py's problem "
          f"({res['scene_rows']} scene + {res['text_rows']} text rows), {BA_ITERS} LM iterations: "
          f"assembly worst abs diff vs one device {res['assembly_worst_abs_diff']}; final cost "
          f"sharded {c2:.6f}, solve_ba {c1:.6f} (region-sampler solve {cf:.6f}), poses max diff "
          f"{pose_diff:.3e}; landmark-sharded step vs observation-sharded {lm}")
    print(f"9a wall ms (synchronized, median of 3): solve_ba {ms['solve_ba']:.3f}, "
          f"solve_ba(text_pair_feat={F}) (the fused schedule's solve, region sampler kernel) "
          f"{ms['solve_ba_pair_feat']:.3f}, solve_ba_sharded {ms['solve_ba_sharded']:.3f}; "
          f"sharded_ba_step {ms['sharded_ba_step']:.3f}, sharded_ba_step_landmark "
          f"{ms['sharded_ba_step_landmark']:.3f}  [{card}]")
    return res


def _kf_pose_diff(k_ref, k, label: str):
    """Keyframe poses k [N, 7] against k_ref, up to the windowed BA's free
    scale: with one fixed pose its cost is flat along scale (a gauge), the
    LM's steps move along it, and where a run stops on it follows every
    input the solves see (chip_mesh_scale.py), so the camera centres are
    Sim3-aligned to k_ref's before MESH_POSE_DIFF is applied; the rotations,
    which scale does not touch, are compared as they are. Returns {raw,
    centres_sim3, rotations, scale}."""
    import numpy as np
    import torch_synth
    from textslam_tpu_torch.geometry import se3_np

    check(k_ref.shape == k.shape, f"{label}: {len(k)} keyframes, phase 6 made {len(k_ref)}")
    c0, c1 = se3_np.inverse(k_ref)[:, 4:7], se3_np.inverse(k)[:, 4:7]
    scale, R, t = torch_synth._horn_alignment(c0.astype(np.float64), c1.astype(np.float64))
    diff = {"raw": float(np.abs(k - k_ref).max()),
            "centres_sim3": float(np.linalg.norm(scale * c1 @ R.T + t - c0, axis=-1).max()),
            "rotations": float(np.abs(k[:, :4] - k_ref[:, :4]).max()), "scale": float(scale)}
    check(diff["centres_sim3"] <= MESH_POSE_DIFF and diff["rotations"] <= MESH_POSE_DIFF,
          f"{label}: keyframe poses vs phase 6's {diff} (bar {MESH_POSE_DIFF})")
    check(1.0 / MESH_SCALE_BAND <= scale <= MESH_SCALE_BAND,
          f"{label}: Sim3 scale {scale} against phase 6's outside the factor {MESH_SCALE_BAND}")
    return diff


def _mesh_text_run(card: str, n_shards: int, hold_kernels: bool):
    """Phase 6's text run with the tracker's and the map's mesh set to
    n_shards shards of cuda:0, through drive() and _summary() (phase 6's
    tracking and ATE bars), with the text-plane bars; with hold_kernels every
    Hamming and sampler call is held to its plain version. Returns (summary,
    sharded solve counts, text-plane result)."""
    import torch
    from textslam_tpu_torch.ops import matching, patch_sample
    from textslam_tpu_torch.parallel import ba_sharded
    from textslam_tpu_torch.parallel.mesh import Mesh

    label = f"mesh text {n_shards} shards"
    slam, frames, dets, gt, world = text_setup()
    mesh = Mesh([torch.device("cuda", 0)] * n_shards)
    slam.tracker.mesh = slam.map._covis_mesh = mesh
    devices = set()
    watch = _watch(devices)
    solves = {"calls": 0, "with_text": 0}
    orig = ba_sharded.solve_ba_sharded

    def counted(prob, m, **kw):
        solves["calls"] += 1
        solves["with_text"] += prob.text is not None
        return orig(prob, m, **kw)

    ba_sharded.solve_ba_sharded = watch(counted)
    checks, restore_checks = _kernel_checks(matching, patch_sample, label=label)
    checks["on"] = hold_kernels
    try:
        out = drive(slam, frames, dets, {"hamming_matrix": matching.hamming_matrix,
                                         "grouped_bilinear_stack":
                                             patch_sample.grouped_bilinear_stack})
    finally:
        checks["on"] = False
        restore_checks()
        ba_sharded.solve_ba_sharded = orig
    res = _summary(label, frames, *out[:4], slam, gt, *out[4:], devices, card)
    for k, n in res["launches"].items():
        check(n > 0, f"{label}: the {k} kernel was never launched")
    check(solves["calls"] > 0 and solves["with_text"] > 0,
          f"{label}: sharded solves {solves} (none, or none with text rows)")
    n_good, cosines, failed = text_planes(slam, gt, world)
    print(f"{label} objects: {slam.map.n_texts}, GOOD {n_good}; GOOD normals vs ground truth "
          f"(string, KF observations, cos): {_planes_line(cosines)}")
    check(not failed, f"{label}: {failed}")
    res.update(solves=solves, n_good=n_good, theta_cos=cosines)
    if hold_kernels:
        stats = checks["stats"]
        res.update(calls_held={k: v["calls"] for k, v in stats.items()},
                   max_abs_err={k: v["max_abs_err"] for k, v in stats.items()})
    return res


def run_mesh_text(card: str, text_res: dict):
    """Phase 9(b): phase 6's text run with the tracker's and the map's mesh
    set to 2 shards of cuda:0 (every windowed BA runs the sharded LM level
    by level, every kernel call held to its plain version), then to 4
    shards; each meets phase 6's bars, and its keyframe poses lie near
    phase 6's up to the windowed BA's free scale (_kf_pose_diff), whose
    factor is printed and held within MESH_SCALE_BAND."""
    k6 = text_res["kf_poses"]
    res = _mesh_text_run(card, MESH_SHARDS, hold_kernels=True)
    diff = _kf_pose_diff(k6, res["kf_poses"], "mesh text")
    res4 = _mesh_text_run(card, 2 * MESH_SHARDS, hold_kernels=False)
    diff4 = _kf_pose_diff(k6, res4["kf_poses"], "4-shard mesh text")
    res.update(kf_pose_diff_vs_phase6=diff, four_shards={
        "kf_pose_diff_vs_phase6": diff4, "kf_ate": res4["kf_ate"], "tracked": res4["tracked"],
        "solves": res4["solves"], "frame_ms_median": res4["frame_ms_median"],
        "kf_insert_ms_median": res4["kf_insert_ms_median"]})
    for n, (r, d) in ((MESH_SHARDS, (res, diff)), (2 * MESH_SHARDS, (res4, diff4))):
        print(f"mesh text {n} shards: {r['solves']['calls']} sharded solves "
              f"({r['solves']['with_text']} with text rows); keyframe poses vs phase 6's: camera "
              f"centres within {d['centres_sim3']:.3e} after Sim3 alignment (scale "
              f"{d['scale']:.5f}), quaternions within {d['rotations']:.3e}, raw {d['raw']:.3e}")
    print(f"mesh text: kernel calls held to the plain version {res['calls_held']} (max abs err "
          f"{res['max_abs_err']})")
    print(f"mesh text vs phase 6 medians: per frame {res['frame_ms_median']:.3f} (4 shards "
          f"{res4['frame_ms_median']:.3f}) vs {text_res['frame_ms_median']:.3f} ms, KF insertion "
          f"{res['kf_insert_ms_median']:.3f} (4 shards {res4['kf_insert_ms_median']:.3f}) vs "
          f"{text_res['kf_insert_ms_median']:.3f} ms  [{card}]")
    return res


def run_covis(card: str, device="cuda"):
    """Phase 9(c): the sharded covisibility product on a 2-shard mesh,
    plain and weighted, bit-equal to the exact product (float64 BLAS:
    every count is an integer far below 2^53), timed at each K against the
    host product SlamMap runs below covis_min_kfs (numpy int32; once, it
    takes seconds at K = 512); prints the crossover K."""
    import numpy as np
    import torch
    from textslam_tpu_torch.parallel import covis_sharded
    from textslam_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh([torch.device(device)] * MESH_SHARDS)
    rng = np.random.default_rng(9)
    rows, crossover = [], None
    for K in COVIS_KS:
        inc = rng.random((K, COVIS_POINTS)) < COVIS_DENSITY
        w = rng.integers(0, 65, COVIS_POINTS)  # level-0 text feature counts (F = 64)
        inc_i = inc.astype(np.int32)
        _sync()
        t0 = time.perf_counter()
        M_host = inc_i @ inc_i.T  # SlamMap._covis_product's host path
        np.fill_diagonal(M_host, 0)
        t_host = (time.perf_counter() - t0) * 1e3
        row = {"K": K, "points": COVIS_POINTS, "host_ms": t_host}
        f = inc.astype(np.float64)
        for weighted in (False, True):
            wk = w if weighted else None
            t_dev, M_dev = wall_ms(lambda: covis_sharded.covis_product(inc, mesh, w=wk))
            want = (f * wk[None, :] if weighted else f) @ f.T
            np.fill_diagonal(want, 0)
            want = want.astype(np.int32)
            check(M_dev.dtype == np.int32 and np.array_equal(M_dev, want),
                  f"9c: covis_product K={K} weighted={weighted} differs from the exact product")
            if not weighted:
                check(np.array_equal(M_host, want), f"9c: host product K={K} is not exact")
            row["weighted_device_ms" if weighted else "device_ms"] = t_dev
        rows.append(row)
        if crossover is None and row["device_ms"] < t_host:
            crossover = K
    for r in rows:
        print(f"9c covis_product K={r['K']} x {r['points']}: {MESH_SHARDS}-shard device "
              f"{r['device_ms']:.3f} ms plain, {r['weighted_device_ms']:.3f} ms weighted (upload, "
              f"product, readback; bit-equal) vs host numpy int32 {r['host_ms']:.3f} ms")
    print(f"9c crossover: the device product wins from K = {crossover} of {COVIS_KS} (config "
          f"default covis_min_kfs = 384, the JAX package's)  [{card}]")
    return {"rows": rows, "crossover_k": crossover}


def _mp_worker(rank: int, world: int, backend: str, port: int, out_dir: str, device: str):
    """One process of phase 9(d): a 1-shard mesh on `device` in a `backend`
    process group; one sharded assembly (scene + text) and one
    solve_ba_sharded of bench.py's problem; rank 0 writes the results."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch_synth
    from textslam_tpu_torch.parallel import ba_sharded
    from textslam_tpu_torch.parallel.mesh import Mesh
    from textslam_tpu_torch.solver import ba

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=MP_TIMEOUT_S))
    try:
        mesh = Mesh([dev], group=dist.group.WORLD)
        prob = ba.ba_problem_from_numpy(torch_synth.ba_problem_arrays(**BENCH_PROBLEM), device=dev)
        Hcc, bc, _, Hll, bl, c1 = ba_sharded.sharded_scene_normal_eqs(prob, mesh, 2.447)
        H2, b2, _, Ht, bt, c2 = ba_sharded.sharded_text_normal_eqs(prob, mesh, 3.0)
        st = ba_sharded.solve_ba_sharded(prob, mesh, n_iters=BA_ITERS)
        if rank == 0:
            out = dict(Hcc=Hcc + H2, bc=bc + b2, Hll=Hll, bl=bl, Ht=Ht, bt=bt, cost0=c1 + c2,
                       poses=st.poses, rho=st.rho, theta=st.theta, cost=st.cost)
            np.savez(os.path.join(out_dir, f"{backend}_{world}.npz"),
                     **{k: v.cpu().numpy() for k, v in out.items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(world: int, backend: str, out_dir: str, device: str = "cuda:0"):
    """Run _mp_worker in `world` spawned processes (CUDA does not survive
    fork); every process is stopped before this returns."""
    import socket
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(_mp_worker, args=(world, backend, port, out_dir, device),
                             nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + MP_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() < deadline,
                  f"9d: {world} {backend} processes outlived {MP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def run_two_process(card: str):
    """Phase 9(d): two spawned processes, each a 1-shard mesh on cuda:0 in a
    gloo group (CUDA tensors through gloo: NCCL refuses two ranks on one
    card), held against the same 2-shard mesh in one process (one assembly,
    tightly) and against solve_ba (the LM, by final cost); then NCCL with a
    world size of 1, which must equal the 1-shard mesh without a group."""
    import tempfile
    import numpy as np
    import torch
    import torch_synth
    from textslam_tpu_torch.parallel import ba_sharded
    from textslam_tpu_torch.parallel.mesh import Mesh
    from textslam_tpu_torch.solver import ba

    dev = torch.device("cuda", 0)
    prob = ba.ba_problem_from_numpy(torch_synth.ba_problem_arrays(**BENCH_PROBLEM), device=dev)
    mesh2 = Mesh([dev] * 2)
    Hcc, bc, _, Hll, bl, c1 = ba_sharded.sharded_scene_normal_eqs(prob, mesh2, 2.447)
    H2, b2, _, Ht, bt, c2 = ba_sharded.sharded_text_normal_eqs(prob, mesh2, 3.0)
    same = dict(Hcc=Hcc + H2, bc=bc + b2, Hll=Hll, bl=bl, Ht=Ht, bt=bt, cost0=c1 + c2)
    st1 = ba.solve_ba(prob, n_iters=BA_ITERS)
    one = ba_sharded.solve_ba_sharded(prob, Mesh([dev]), n_iters=BA_ITERS)
    res = {}
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        _spawn(2, "gloo", out_dir)
        res["gloo_s"] = time.perf_counter() - t0
        z = np.load(os.path.join(out_dir, "gloo_2.npz"))
        worst = {}
        for k, v in same.items():
            ref = v.cpu().numpy()
            scale = max(1.0, float(np.abs(ref).max()))
            d = np.abs(z[k] - ref)
            check(bool((d <= 1e-5 * np.abs(ref) + 1e-6 * scale).all()),
                  f"9d gloo: {k} differs from the in-process 2-shard assembly by {d.max()}")
            worst[k] = float(d.max())
        c, c_ref = float(z["cost"]), float(st1.cost)
        check(abs(c - c_ref) <= LM_COST_RTOL * max(1.0, c_ref),
              f"9d gloo: solve_ba_sharded cost {c} vs solve_ba {c_ref}")
        res.update(gloo_assembly_worst_abs_diff=worst, gloo_cost=c, solve_ba_cost=c_ref)
        t0 = time.perf_counter()
        _spawn(1, "nccl", out_dir)
        res["nccl_s"] = time.perf_counter() - t0
        z = np.load(os.path.join(out_dir, "nccl_1.npz"))
        for k in ("poses", "rho", "theta", "cost"):
            ref = getattr(one, k).cpu().numpy()
            check(np.allclose(z[k], ref, rtol=1e-6, atol=1e-7),
                  f"9d nccl: world size 1 {k} differs from the 1-shard mesh without a group by "
                  f"{np.abs(z[k] - ref).max()}")
        res["nccl_cost"] = float(z["cost"])
    print(f"9d two gloo processes x 1 shard of cuda:0: assembly worst abs diff vs the same 2 "
          f"shards in one process {res['gloo_assembly_worst_abs_diff']}; LM final cost "
          f"{res['gloo_cost']:.6f} vs solve_ba {res['solve_ba_cost']:.6f} ({res['gloo_s']:.1f} s "
          f"with spawn); NCCL world size 1: equal to the 1-shard mesh ({res['nccl_s']:.1f} s). "
          f"NCCL between two cards: not run (one card)  [{card}]")
    return res


# the long runs (phase 10(b); chip_scale.py): the rendered worlds, the
# render pool, the derived configuration and run_long with its snapshots
LONG_KINDS = ("outback2", "ring", "ring_drift")
LONG_FPS = 10.0
RENDER_WORKERS = 4
RENDER_AHEAD = 12  # frames rendered ahead of the tracker


def host_rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    raise RuntimeError("no VmRSS line in /proc/self/status")


def world_spec(kind: str, n_frames: int, small: bool = False, boxes_per_plane: int = 4) -> dict:
    """What make_world builds, as a plain dict the render workers receive."""
    if kind not in LONG_KINDS:
        raise ValueError(f"kind must be one of {LONG_KINDS}, got {kind!r}")
    return {"kind": kind, "n": n_frames, "small": small, "boxes": boxes_per_plane}


def make_world(spec: dict):
    """(world, ground-truth Tcw [n, 7], render(i) -> (frame, detections))."""
    import numpy as np
    import torch_synth

    kind, n = spec["kind"], spec["n"]
    K = torch_synth.K.copy()
    size = None
    if spec["small"]:
        K[:2] /= 2
        size = (320, 240)
    if kind == "outback2":
        world = torch_synth.TextWorld(seed=3, boxes_per_plane=spec["boxes"])
    elif kind == "ring":
        world = torch_synth.ring_world(seed=3)
    else:
        world = torch_synth.ring_world(seed=3, box_px=((80, 130), (50, 80)))
    poses = torch_synth.camera_path(n, "outback2" if kind == "outback2" else "ring")
    g = torch_synth.degrade_schedule(n) if kind == "ring_drift" else np.zeros(n, np.float32)
    eps = 0.04 * np.clip((g - 0.3) / 0.7, 0.0, 1.0)

    def render(i: int):
        dets = world.detections(poses[i], K_mat=K, size=size)
        if eps[i] > 0:
            Km = K.copy()
            Km[:2, :2] *= 1.0 + eps[i]
            img = world.render(poses[i], K_mat=Km, size=size)
        else:
            img = world.render(poses[i], K_mat=K, size=size)
        if g[i] > 0:
            img = torch_synth.degrade_frame(img, np.random.default_rng([9, i]), float(g[i]))
        return img, (dets if g[i] < 0.3 else [])

    return world, poses, render


_WORKER = {}


def _init_worker(spec: dict):
    _WORKER["render"] = make_world(spec)[2]


def _render(i: int):
    return _WORKER["render"](i)


def frame_stream(spec: dict, stop: int | None = None, workers: int = RENDER_WORKERS,
                 ahead: int = RENDER_AHEAD, start: int = 0):
    """Yield (frame, detections) for frames start..stop-1 (stop: the
    sequence's end by default) in order, rendered by `workers` spawned
    processes (started with this process's sys.path) at most `ahead` frames
    ahead. The pool stops when the generator ends or is closed."""
    import concurrent.futures
    import multiprocessing

    stop = spec["n"] if stop is None else stop
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_init_worker, initargs=(spec,)) as ex:
        pending = collections.deque()
        try:
            for i in range(start, stop):
                while len(pending) < ahead and i + len(pending) < stop:
                    pending.append(ex.submit(_render, i + len(pending)))
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()


def long_config(n_frames: int, small: bool = False, decompose_kfs: int | None = None):
    """TextSLAMConfig() with text on, the renderer's camera at LONG_FPS, the
    pools derived from the sequence length, and optionally
    solver.global_decompose_kfs."""
    import dataclasses
    import torch_synth
    from textslam_tpu_torch import config

    if small:
        cfg = config.TextSLAMConfig(
            camera=config.CameraConfig(fx=torch_synth.FX / 2, fy=torch_synth.FY / 2,
                                       cx=torch_synth.CX / 2, cy=torch_synth.CY / 2,
                                       width=320, height=240, fps=LONG_FPS),
            orb=config.ORBConfig(n_features=500, n_features_init=1500))
    else:
        cfg = config.TextSLAMConfig(camera=config.CameraConfig(
            fx=torch_synth.FX, fy=torch_synth.FY, cx=torch_synth.CX, cy=torch_synth.CY,
            width=torch_synth.W, height=torch_synth.H, fps=LONG_FPS))
    cfg = dataclasses.replace(cfg, map=config.MapConfig.derive(n_frames, LONG_FPS, cfg.map))
    if decompose_kfs is not None:
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, global_decompose_kfs=decompose_kfs))
    return cfg


def _sync_device(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_long(slam, frames, gt, every: int, card: str, check_ms=lambda: 0.0, census=None,
             log=print, start: int = 0) -> dict:
    """Feed `frames` ((frame, detections) pairs of frames start, start + 1,
    ..., ground truth `gt`) to `slam` and take a snapshot every `every`
    frames. Host times are
    synchronized and leave out check_ms() (checks made inside, as in
    chip_smoke.drive). census(), if given, returns a line printed in each
    snapshot. Returns the run's results."""
    import numpy as np
    import torch
    import torch_synth
    from textslam_tpu_torch.utils.profiling import report

    dev = slam.device
    m, tr, lc = slam.map, slam.tracker, slam.loop_closer
    tf = tr.text_frontend
    closures, narrow = [], {"calls": 0, "min_candidates": None}
    run, narrow_fn = lc.run, tr._narrow_to_local_map
    theta_pass = tf.landmark_theta_pass if tf is not None else None
    theta_calls = [0]

    def run_timed(kid):
        n_theta, K = theta_calls[0], len(m.keyframes)
        _sync_device(dev)
        t0, c0 = time.perf_counter(), check_ms()
        closed = run(kid)
        _sync_device(dev)
        if closed:
            closures.append({"kid": kid, "K": K, "loop": list(lc.closed_loops[-1]),
                             "ms": (time.perf_counter() - t0) * 1e3 - (check_ms() - c0),
                             "decomposed": theta_calls[0] > n_theta})
        return closed

    def theta_counted():
        theta_calls[0] += 1
        return theta_pass()

    def narrow_counted(frame, pt_valid):
        out = narrow_fn(frame, pt_valid)
        n = int(out[: m.n_points].sum())
        narrow["calls"] += 1
        narrow["min_candidates"] = n if narrow["min_candidates"] is None else min(
            narrow["min_candidates"], n)
        return out

    lc.run, tr._narrow_to_local_map = run_timed, narrow_counted
    if tf is not None:
        tf.landmark_theta_pass = theta_counted
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    report(reset=True)
    snaps, init_ms, frame_ms, kf_ms, n_ok = [], [], [], [], 0
    rss_start = host_rss_mb()
    block = {"frame": [], "kf": [], "closures": 0, "narrow": 0}
    t_start = time.perf_counter()
    try:
        for i, (img, dets) in enumerate(frames, start):
            n_kf, tracking = len(m.keyframes), tr.state == 1
            _sync_device(dev)
            t0, c0 = time.perf_counter(), check_ms()
            pose = slam.track_monocular(img, float(i), detections=dets)
            _sync_device(dev)
            dt = (time.perf_counter() - t0) * 1e3 - (check_ms() - c0)
            n_ok += pose is not None
            if not tracking:
                init_ms.append(dt)
            else:
                kind = "kf" if len(m.keyframes) > n_kf else "frame"
                (kf_ms if kind == "kf" else frame_ms).append(dt)
                block[kind].append(dt)
            if (i + 1) % every == 0:
                snap = {
                    "frame": i + 1,
                    "frame_ms_median": float(np.median(block["frame"])) if block["frame"] else None,
                    "kf_insert_ms_median": float(np.median(block["kf"])) if block["kf"] else None,
                    "kf_insertions": len(block["kf"]),
                    "keyframes": len(m.keyframes), "points": int(m.n_points),
                    "texts": int(m.n_texts), "saturation_drops": dict(m.saturation_drops),
                    "loops": len(lc.closed_loops),
                    "closures": [(c["K"], round(c["ms"], 1), c["decomposed"])
                                 for c in closures[block["closures"]:]],
                    "narrowing_calls": narrow["calls"] - block["narrow"],
                    "rss_mb": host_rss_mb(),
                    "host_bytes_mb": {k: v / 2 ** 20 for k, v in m.host_bytes().items()},
                    "device_mb": (torch.cuda.memory_allocated(dev) / 2 ** 20
                                  if dev.type == "cuda" else None),
                    "device_peak_mb": (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                                       if dev.type == "cuda" else None),
                }
                snaps.append(snap)
                fmt = {k: (round(v, 3) if isinstance(v, float) else v) for k, v in snap.items()}
                fmt["host_bytes_mb"] = {k: round(v, 1) for k, v in snap["host_bytes_mb"].items()}
                log(f"[scale] {fmt}  [{card}]")
                log(report(reset=True))  # the block's host time by phase
                if census is not None:
                    log(f"[scale] frame {i + 1} text planes: {census()}")
                block = {"frame": [], "kf": [], "closures": len(closures),
                         "narrow": narrow["calls"]}
    finally:
        lc.run, tr._narrow_to_local_map = run, narrow_fn
        if tf is not None:
            tf.landmark_theta_pass = theta_pass
    wall = time.perf_counter() - t_start
    traj = tr.trajectory
    est = np.stack([p for _, p in traj])
    ts = [t for t, _ in traj]
    kfs = m.keyframes
    return {
        "frames": len(frame_ms) + len(kf_ms) + len(init_ms), "tracked": n_ok, "wall_s": wall,
        "ate": torch_synth.ate_rmse(ts, est, gt),
        "kf_ate": torch_synth.ate_rmse([kf.timestamp for kf in kfs],
                                       np.stack([m.kf_pose[kf.kid] for kf in kfs]), gt),
        "keyframes": len(kfs), "kf_pool_cap": slam.cfg.map.max_keyframes,
        "points": int(m.n_points), "point_pool_cap": slam.cfg.map.max_points,
        "texts": int(m.n_texts), "saturation_drops": dict(m.saturation_drops),
        "loops": [list(x) for x in lc.closed_loops], "closures": closures,
        "narrowing": narrow, "theta_passes": theta_calls[0],
        "frame_ms_median": float(np.median(frame_ms)) if frame_ms else None,
        "kf_insert_ms_median": float(np.median(kf_ms)) if kf_ms else None,
        "frame_ms_median_by_block": [s["frame_ms_median"] for s in snaps],
        "rss_start_mb": rss_start, "rss_mb": [s["rss_mb"] for s in snaps], "snapshots": snaps,
        "trajectory_ts": ts, "trajectory": est,
    }


# phase 10: the long-sequence regime. (a) the native host routines on the
# card's host; (b) tests/test_scale_rehearsal.py's fixture through the port
# (run_long); (c) tests/test_long_regime.py's two fixtures
LEV_LENGTHS = ((128, 12, 16), (256, 8, 10))  # (padded L, queries, targets)
LONG_FRAMES = 200  # the rehearsal's N: test_scale_rehearsal.py's default
LONG_DECOMPOSE_KFS = 16  # its solver.global_decompose_kfs
LONG_EVERY = 50  # frames per snapshot (and per RSS reading, as the test takes them)
# the JAX package's run of the same fixture on the CPU
# (tests/rehearsal_reference.py --write-record): its loops and its closer's
# runs, against which a port run that closes no loop is held
REHEARSAL_REFERENCE = os.path.join("tests", "rehearsal_reference.json")
# the amnesia run: tests/test_e2e_loop.py's amnesia at its fractions of the
# run (from the second excursion, frame N/2, the tracker forgets the
# landmarks hosted in the keyframes made before frame N/4, the first outward
# leg), the same fixture stopped at LONG_AMNESIA_STOP, some frames past the
# return to the start and the closure there (KF 23 -> 2 at about frame 110)
LONG_AMNESIA = (LONG_FRAMES // 4, LONG_FRAMES // 2)
LONG_AMNESIA_STOP = 5 * LONG_FRAMES // 8
# phase 10(b-c) runs in a process of its own (LongSide) beside phases
# 5-10(a), on the same card; it takes ~7 minutes
LONG_SIDE_TIMEOUT_S = 900
LONG_ATE_MAX = 0.06  # its online-trajectory ATE bar
# its host-memory bar: the RSS at the end below 1.6 x the mid-run RSS + 500 MB
LONG_RSS_FACTOR, LONG_RSS_SLACK_MB = 1.6, 500.0
# tests/test_long_regime.py: (frames, world seed, point pool), scene-only
NARROW_FIXTURE = (30, 4, 2048)
CAP_FIXTURE = (20, 5, 1024)
NARROW_MIN_CANDIDATES = 50
NARROW_ATE_MAX = 0.02


def _lev_words(rng, n: int, L: int):
    """n strings: empty, ASCII, CJK and mixed, up to L codepoints, one of
    exactly L."""
    alpha = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-#") + list("咖啡店出口酒店東京駅")
    out = ["", "EXIT", "咖啡店", "".join(rng.choice(alpha, L))]
    while len(out) < n:
        out.append("".join(rng.choice(alpha, int(rng.integers(1, L + 1)))))
    return out[:n]


def run_native(card: str, covis: dict):
    """Phase 10(a): the native host routines (csrc/native.cpp, built with the
    host C++ compiler) on the card's host. covis_product on phase 9(c)'s
    incidences (the same generator draws) held bit-equal to the exact product
    (float64 BLAS), to which 9(c) held the numpy int32 product, so the two
    host products are equal; its milliseconds beside 9(c)'s numpy and device
    times. levenshtein_batch exactly equal to the Python DP (its plain
    version) at L = 128 and 256 with empty, ASCII and CJK strings."""
    import numpy as np
    from textslam_tpu_torch import native
    from textslam_tpu_torch.ops import cuda_lib, levenshtein

    t0 = time.perf_counter()
    lib = cuda_lib.build("native")
    print(f"10a built {os.path.basename(lib)} in {time.perf_counter() - t0:.2f} s "
          f"({os.path.basename(cuda_lib.find_cxx())}, {os.cpu_count()} host cores)")
    rng = np.random.default_rng(9)  # run_covis's draws
    rows = []
    for K, r9 in zip(COVIS_KS, covis["rows"]):
        inc = rng.random((K, COVIS_POINTS)) < COVIS_DENSITY
        rng.integers(0, 65, COVIS_POINTS)
        f = inc.astype(np.float64)
        want = f @ f.T
        np.fill_diagonal(want, 0)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = native.covis_product(inc)
            times.append((time.perf_counter() - t0) * 1e3)
        check(got.dtype == np.int32 and np.array_equal(got, want.astype(np.int32)),
              f"10a: native covis_product K={K} differs from the exact product")
        rows.append({"K": K, "points": COVIS_POINTS, "native_ms": float(np.median(times)),
                     "numpy_ms": r9["host_ms"], "device_ms": r9["device_ms"]})
        print(f"10a covis_product K={K} x {COVIS_POINTS}: native {rows[-1]['native_ms']:.3f} ms "
              f"(median of 3; bit-equal), numpy int32 {r9['host_ms']:.3f} ms, "
              f"{MESH_SHARDS}-shard device {r9['device_ms']:.3f} ms (9c)  [{card}]")
    lev = []
    for L, nq, nt in LEV_LENGTHS:
        qa, qlen = levenshtein.encode(_lev_words(rng, nq, L), L)
        ta, tlen = levenshtein.encode(_lev_words(rng, nt, L), L)
        t0 = time.perf_counter()
        got = native.levenshtein_batch(qa, qlen, ta, tlen)
        t_native = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = native.levenshtein_batch_plain(qa, qlen, ta, tlen)
        t_plain = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(got, want), f"10a: native levenshtein_batch L={L} differs from "
                                         f"the Python DP")
        lev.append({"L": L, "pairs": nq * nt, "native_ms": t_native, "plain_ms": t_plain})
        print(f"10a levenshtein_batch L={L}, {nq} x {nt} strings: native {t_native:.3f} ms, "
              f"Python DP {t_plain:.3f} ms, exactly equal  [{card}]")
    return {"covis": rows, "levenshtein": lev}


def _watch_closer(slam, runs: list):
    """Record every loop-closer run past its gates on `slam`: the keyframe
    count K, the keyframes M1/M2/M3-covisible with the current one, those left
    eligible as candidates, and the candidates. Returns a function that
    removes the watch."""
    lc = slam.loop_closer
    thresh_words, detect = lc._thresh_words, lc.detect

    def thresh_spy(kid):
        out = thresh_words(kid)
        if out[2]:
            m, K = lc.map, len(lc.map.keyframes)
            covis = int(((m.M1[kid, :K] > 0) | (m.M2[kid, :K] > 0) | (m.M3[kid, :K] > 0)).sum())
            runs.append({"kid": kid, "K": K, "covisible": covis, "eligible": K - 1 - covis,
                         "candidates": None})
        return out

    def detect_spy(kid, min_words, connects=frozenset()):
        out = detect(kid, min_words, connects)
        runs[-1]["candidates"] = list(out)
        return out

    lc._thresh_words, lc.detect = thresh_spy, detect_spy

    def unwatch():
        lc._thresh_words, lc.detect = thresh_words, detect

    return unwatch


def run_long_regime(card: str, checkpoint: str):
    """Phase 10(b): tests/test_scale_rehearsal.py's fixture through the port
    on the card (run_long): LONG_FRAMES frames of the text world (seed 3, 3
    boxes per plane) on the outback2 path, TextSLAMConfig() with the pools
    derived from the sequence length and global_decompose_kfs 16. Its bars,
    and the port's: every closure past 16 keyframes took the decomposed
    landmark pass, every kernel call equal to its plain version, the
    tracking / solver / Sim3 tensors on the GPU. A run that closes no loop
    passes only as the JAX package's own result on this fixture
    (REHEARSAL_REFERENCE): it closed none either, and in both packages the
    covisibility exclusion left no keyframe eligible at any closer run.
    Snapshots every 50 frames, with the text-plane census of phase 6
    (printed, not held). Saves the system at `checkpoint` just before frame
    LONG_AMNESIA[1], with the keyframe count at frame LONG_AMNESIA[0] (what
    the amnesia run forgets), for run_long_amnesia. The save is left out of
    the frame times."""
    from textslam_tpu_torch.frontend import text
    from textslam_tpu_torch.ops import matching, patch_sample
    from textslam_tpu_torch.solver import ba, sim3_opt
    from textslam_tpu_torch.system import TextSLAM

    spec = world_spec("outback2", LONG_FRAMES, boxes_per_plane=3)
    world, gt, _ = make_world(spec)
    cfg = long_config(LONG_FRAMES, decompose_kfs=LONG_DECOMPOSE_KFS)
    check(not cfg.no_text, "the default configuration runs text")
    print(f"10b: {LONG_FRAMES} frames of outback2; derived pools: keyframes "
          f"{cfg.map.max_keyframes}, points {cfg.map.max_points}, texts {cfg.map.max_texts}")
    slam = TextSLAM(cfg, device="cuda")
    devices = set()
    watch = _watch(devices)
    orig = (text.fused_frame_chain, text.fused_ba_schedule, ba.solve_ba,
            sim3_opt.refine_sim3, sim3_opt.solve_pose_graph)
    (text.fused_frame_chain, text.fused_ba_schedule, ba.solve_ba, sim3_opt.refine_sim3,
     sim3_opt.solve_pose_graph) = (watch(f) for f in orig)
    checks, restore_checks = _kernel_checks(matching, patch_sample, label="long run")
    counters = {"hamming_matrix": matching.hamming_matrix,
                "grouped_bilinear_stack": patch_sample.grouped_bilinear_stack}
    for fn in counters.values():
        fn.launches = 0
    checks["on"] = True
    closer_runs = []
    unwatch = _watch_closer(slam, closer_runs)

    def census():
        n_good, cosines, failed = text_planes(slam, gt, world)
        return f"GOOD {n_good}: {_planes_line(cosines)}; outside the text bars: {failed}"

    feed, saved = slam.track_monocular, {}

    def track(img, t, detections=None):
        if int(t) == LONG_AMNESIA[0]:
            saved["quarter"] = len(slam.map.keyframes)
        if int(t) == LONG_AMNESIA[1]:
            _sync_device(slam.device)
            t0 = time.perf_counter()
            slam.save_checkpoint(checkpoint, extra={"amnesia_quarter": saved["quarter"]})
            saved["ms"] = (time.perf_counter() - t0) * 1e3
            CHECK_MS[0] += saved["ms"]
        return feed(img, t, detections=detections)

    slam.track_monocular = track

    try:
        res = run_long(slam, frame_stream(spec), gt, LONG_EVERY, card,
                       check_ms=lambda: CHECK_MS[0], census=census,
                       log=lambda s: print(s, flush=True))
    finally:
        checks["on"] = False
        restore_checks()
        unwatch()
        (text.fused_frame_chain, text.fused_ba_schedule, ba.solve_ba, sim3_opt.refine_sim3,
         sim3_opt.solve_pose_graph) = orig
    res.pop("trajectory_ts"), res.pop("trajectory")
    res["launches"] = {k: fn.launches for k, fn in counters.items()}
    res["calls_held"] = {k: v["calls"] for k, v in checks["stats"].items()}
    res["max_abs_err"] = {k: v["max_abs_err"] for k, v in checks["stats"].items()}
    res["tensor_devices"] = sorted(devices)
    res["closer_runs"] = closer_runs
    res["checkpoint_save_ms"] = saved["ms"]
    res["checkpoint_mb"] = os.path.getsize(checkpoint) / 2 ** 20
    for name, st in sorted(checks["stats"].items()):
        print(f"10b: {name} calls held against the plain version {st['calls']}, max abs err "
              f"{st['max_abs_err']:.3g}")
    closures = res["closures"]
    print(f"10b: {res['tracked']}/{res['frames']} tracked, {res['keyframes']} KFs (cap "
          f"{res['kf_pool_cap']}), {res['points']} points (cap {res['point_pool_cap']}), "
          f"{res['texts']} texts, drops {res['saturation_drops']}, loops {res['loops']}, "
          f"online ATE {res['ate']:.6f}, KF ATE {res['kf_ate']:.6f}, narrowing "
          f"{res['narrowing']}; closures (K, ms, decomposed) "
          f"{[(c['K'], round(c['ms'], 1), c['decomposed']) for c in closures]}; per-frame "
          f"medians by {LONG_EVERY} frames {[round(x, 3) for x in res['frame_ms_median_by_block']]}"
          f"; RSS MB {res['rss_start_mb']:.1f} before the first frame, then "
          f"{[round(x, 1) for x in res['rss_mb']]}; launches {res['launches']}  [{card}]")
    n = LONG_FRAMES
    check(res["keyframes"] >= n // 8, f"10b: only {res['keyframes']} KFs over {n} frames")
    check(res["keyframes"] < res["kf_pool_cap"], f"10b: {res['keyframes']} KFs reach the cap")
    check(not any(res["saturation_drops"].values()), f"10b: pools saturated "
                                                     f"{res['saturation_drops']}")
    check(closer_runs, "10b: the loop closer never ran past its gates")
    print(f"10b: {len(closer_runs)} closer runs past the gates, K = {closer_runs[0]['K']}.."
          f"{closer_runs[-1]['K']}; keyframes eligible as candidates (not covisible with the "
          f"current one): at most {max(r['eligible'] for r in closer_runs)}; candidates "
          f"{sum(bool(r['candidates']) for r in closer_runs)} runs")
    if not res["loops"]:
        with open(REHEARSAL_REFERENCE) as f:
            ref = json.load(f)
        ref_runs = ref["closer_runs"]
        check(ref["frames"] == n and not ref["loops"] and ref_runs
              and not any(r["eligible"] for r in ref_runs + closer_runs),
              f"10b: the out-and-back-twice sequence closed no loop, and that is not the JAX "
              f"package's result on this fixture ({REHEARSAL_REFERENCE}: loops {ref['loops']}, "
              f"at most {max((r['eligible'] for r in ref_runs), default=None)} eligible "
              f"keyframes; the port: at most {max(r['eligible'] for r in closer_runs)})")
        res["loop_miss_as_reference"] = True
        print(f"10b: no loop closed, as in the JAX package on this fixture ({REHEARSAL_REFERENCE}:"
              f" {ref['keyframes']} KFs, no loop, {len(ref_runs)} closer runs at K = "
              f"{ref_runs[0]['K']}..{ref_runs[-1]['K']}, none with an eligible keyframe; objects "
              f"observed by every keyframe {ref['texts_seen_by_every_kf']}): the text objects "
              f"that every keyframe observes make every keyframe M2-covisible with every other, "
              f"and the closer excludes covisible keyframes. The amnesia run must close one.")
    check(res["ate"] < LONG_ATE_MAX, f"10b: online-trajectory ATE {res['ate']}")
    rss = res["rss_mb"]
    mid, end = rss[len(rss) // 2 - 1], rss[-1]
    check(end < mid * LONG_RSS_FACTOR + LONG_RSS_SLACK_MB, f"10b: RSS grew {mid} -> {end} MB")
    late = [c for c in closures if c["K"] > LONG_DECOMPOSE_KFS]
    res["decomposed_closures"] = sum(c["decomposed"] for c in late)
    check(all(c["decomposed"] for c in late),
          f"10b: a closure past {LONG_DECOMPOSE_KFS} KFs skipped the decomposed pass {late}")
    check(devices == {"cuda"}, f"10b: tracking / solver / Sim3 tensors on {sorted(devices)}")
    for k in counters:
        check(res["launches"][k] > 0, f"10b: {k} never launched")
    check(sum(res["calls_held"].get(k, 0) for k in ("hamming_matrix", "hamming_matrix_min"))
          == res["launches"]["hamming_matrix"]
          and res["calls_held"].get("grouped_bilinear_stack", 0)
          == res["launches"]["grouped_bilinear_stack"],
          f"10b: calls held {res['calls_held']} != launches {res['launches']}")
    print(f"10b: {len(closures)} closure(s), {res['decomposed_closures']} of {len(late)} past "
          f"{LONG_DECOMPOSE_KFS} KFs through the decomposed pass; RSS mid {mid:.1f} MB, end "
          f"{end:.1f} MB (bar {mid * LONG_RSS_FACTOR + LONG_RSS_SLACK_MB:.1f})  [{card}]")
    return res


def run_long_amnesia(card: str, checkpoint: str):
    """Phase 10(b), the amnesia run, resumed: the rehearsal's fixture again,
    frames 0..LONG_AMNESIA_STOP - 1, with tests/test_e2e_loop.py's amnesia
    from frame LONG_AMNESIA[1] on (the landmarks of the keyframes made
    before frame LONG_AMNESIA[0] forgotten), so the second excursion maps the
    start again and the closer has keyframes that are not covisible with the
    current one. Until frame LONG_AMNESIA[1] the amnesia run is the
    rehearsal (its hooks forget nothing before it), so the system that
    run_long_regime saved there at `checkpoint`, with the keyframe count the
    amnesia reads at frame LONG_AMNESIA[0], is loaded into a fresh TextSLAM,
    which takes the remaining frames. Bars: at least one loop closed, every
    closure past 16 keyframes through the decomposed pass, no saturation
    drop, tracking, online-trajectory ATE < 0.06. The kernel calls are not
    held again."""
    from textslam_tpu_torch.system import TextSLAM

    spec = world_spec("outback2", LONG_FRAMES, boxes_per_plane=3)
    _, gt, _ = make_world(spec)
    cfg = long_config(LONG_FRAMES, decompose_kfs=LONG_DECOMPOSE_KFS)
    save_at = LONG_AMNESIA[1]
    print(f"10b amnesia: frames 0..{LONG_AMNESIA_STOP - 1}, the landmarks of the KFs made "
          f"before frame {LONG_AMNESIA[0]} forgotten from frame {save_at} on; resumed in a new "
          f"TextSLAM from the rehearsal's checkpoint at frame {save_at}", flush=True)
    ckpt_mb = os.path.getsize(checkpoint) / 2 ** 20
    slam = TextSLAM(cfg, device="cuda")
    t0 = time.perf_counter()
    ex = slam.load_checkpoint(checkpoint)
    _sync_device(slam.device)
    load_ms = (time.perf_counter() - t0) * 1e3
    check(ex.get("frame_count") == save_at, f"10b amnesia: the checkpoint holds "
                                            f"{ex.get('frame_count')} frames, not {save_at}")
    slam.track_monocular = amnesia_track(slam, *LONG_AMNESIA, quarter=ex["amnesia_quarter"])
    res = run_long(slam, frame_stream(spec, LONG_AMNESIA_STOP, start=save_at), gt,
                   LONG_EVERY // 2, card, log=lambda s: print(s, flush=True), start=save_at)
    res.pop("trajectory_ts"), res.pop("trajectory")
    res.update(checkpoint_load_ms=load_ms, checkpoint_mb=ckpt_mb)
    closures = res["closures"]
    late = [c for c in closures if c["K"] > LONG_DECOMPOSE_KFS]
    res["decomposed_closures"] = sum(c["decomposed"] for c in late)
    print(f"10b amnesia: checkpoint at frame {save_at} {ckpt_mb:.1f} MB, load {load_ms:.1f} ms; "
          f"resumed: {res['tracked']}/{res['frames']} tracked, "
          f"{res['keyframes']} KFs, {res['points']} points, {res['texts']} texts, drops "
          f"{res['saturation_drops']}, loops {res['loops']}, online ATE {res['ate']:.6f}, KF ATE "
          f"{res['kf_ate']:.6f}; closures (K, ms, decomposed) "
          f"{[(c['K'], round(c['ms'], 1), c['decomposed']) for c in closures]}; per-frame "
          f"medians by {LONG_EVERY // 2} frames "
          f"{[round(x, 3) for x in res['frame_ms_median_by_block']]}  [{card}]")
    check(len(res["loops"]) >= 1, "10b amnesia: the resumed amnesia run closed no loop")
    check(all(c["decomposed"] for c in late),
          f"10b amnesia: a closure past {LONG_DECOMPOSE_KFS} KFs skipped the decomposed pass")
    check(not any(res["saturation_drops"].values()),
          f"10b amnesia: pools saturated {res['saturation_drops']}")
    check(res["tracked"] >= res["frames"] - 5,
          f"10b amnesia: {res['tracked']} of {res['frames']} frames tracked")
    check(res["ate"] < LONG_ATE_MAX, f"10b amnesia: online-trajectory ATE {res['ate']}")
    return res


class LongSide:
    """Phase 10(b-c) in a process of its own, `chip_smoke.py --long-side
    OUT`, on the same card beside phases 5-10(a): the rehearsal (its kernel
    launches counted and its calls held in that process), the amnesia run,
    then 10(c). It has a session of its own, so that stop() also stops its
    render pools."""

    def __init__(self):
        import tempfile

        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_long_")
        self.log, self.out = (os.path.join(self.tmp, f) for f in ("long.log", "long.json"))
        self.t0 = time.perf_counter()
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--long-side", self.out],
                stdout=log, stderr=subprocess.STDOUT, start_new_session=True)

    def finish(self):
        """Wait for it (at most LONG_SIDE_TIMEOUT_S from its start), print its
        output and return (rehearsal, amnesia, narrowing); fails if it
        failed or outlived its time."""
        try:
            rc = self.proc.wait(max(1.0, LONG_SIDE_TIMEOUT_S - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            rc = None
        self._kill()
        with open(self.log) as f:
            print(f.read(), end="", flush=True)
        print(f"10b-c: the process of the long runs took {time.perf_counter() - self.t0:.1f} s "
              f"(exit code {rc})")
        check(rc is not None, f"10b-c: the long runs outlived {LONG_SIDE_TIMEOUT_S} s")
        check(rc == 0, f"10b-c: the long runs failed (exit code {rc}; their output above)")
        with open(self.out) as f:
            res = json.load(f)
        return res["rehearsal"], res["amnesia"], res["narrowing"]

    def _kill(self):
        """Stop every process of its session that is left."""
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()

    def stop(self):
        """_kill(), and its files removed."""
        import shutil

        self._kill()
        shutil.rmtree(self.tmp, ignore_errors=True)


def run_long_side(card: str, out_path: str):
    """The process of LongSide (--long-side): the rehearsal, the amnesia
    run, then phase 10(c); writes their results to out_path."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "rehearsal_at_amnesia.npz")
        res = {"rehearsal": run_long_regime(card, checkpoint=ckpt),
               "amnesia": run_long_amnesia(card, checkpoint=ckpt)}
    res["narrowing"] = run_narrowing(card)
    with open(out_path, "w") as f:
        json.dump(res, f, default=float)


def run_narrowing(card: str):
    """Phase 10(c): tests/test_long_regime.py's two fixtures at 640x480,
    scene-only: the local-map narrowing past max_points // 2 of a 2,048-point
    pool (it runs, leaves more than 50 candidates at every call, tracking
    holds, KF ATE < 0.02), and a 1,024-point pool that triangulation fills
    and never passes."""
    import dataclasses
    import numpy as np
    import torch_synth
    from textslam_tpu_torch import config
    from textslam_tpu_torch.system import TextSLAM

    res = {}
    for name, (n, seed, cap) in (("narrowing", NARROW_FIXTURE), ("point_cap", CAP_FIXTURE)):
        frames, gt = torch_synth.render_sequence(n, seed=seed, kind="lateral")
        cfg = dataclasses.replace(config.TextSLAMConfig(no_text=True),
                                  camera=_camera(torch_synth, config),
                                  map=config.MapConfig(max_points=cap))
        slam = TextSLAM(cfg, device="cuda")
        tr, m = slam.tracker, slam.map
        calls = []
        narrow = tr._narrow_to_local_map

        def spy(frame, pt_valid):
            out = narrow(frame, pt_valid)
            calls.append(int(out[: m.n_points].sum()))
            return out

        tr._narrow_to_local_map = spy
        t0 = time.perf_counter()
        for i, img in enumerate(frames):
            slam.track_monocular(img, float(i))
        kfs = m.keyframes
        kf_ate = torch_synth.ate_rmse([kf.timestamp for kf in kfs],
                                      np.stack([m.kf_pose[kf.kid] for kf in kfs]), gt)
        r = {"frames": n, "max_points": cap, "points": int(m.n_points), "keyframes": len(kfs),
             "narrowing_calls": len(calls), "min_candidates": min(calls) if calls else None,
             "kf_ate": kf_ate, "tracking": tr.state == 1,
             "saturation_drops": dict(m.saturation_drops), "s": time.perf_counter() - t0}
        res[name] = r
        print(f"10c {name}: {n} frames, pool {cap}: {r['points']} points, {len(kfs)} KFs, "
              f"narrowing calls {len(calls)} (fewest candidates {r['min_candidates']}), KF ATE "
              f"{kf_ate:.6f}, tracking {r['tracking']}, drops {r['saturation_drops']} "
              f"({r['s']:.1f} s)  [{card}]")
        check(r["tracking"], f"10c {name}: tracking lost")
        if name == "narrowing":
            check(m.n_points > cap // 2, f"10c: the fixture never crossed the cap: {m.n_points}")
            check(calls, "10c: the narrowing never ran")
            check(min(calls, default=0) > NARROW_MIN_CANDIDATES,
                  f"10c: narrowing left {min(calls, default=0)} candidates")
            check(kf_ate < NARROW_ATE_MAX, f"10c: narrowed-map KF ATE {kf_ate}")
        else:
            check(m.n_points <= cap, f"10c: {m.n_points} points in a pool of {cap}")
    return res


def run_text_seeds(seeds, card: str):
    """The text run again under other RANSAC seeds (TextSLAMConfig.seed):
    tracking, keyframe ATE and the text-plane bars of every run; fails
    when any run misses one."""
    import numpy as np
    import torch_synth

    misses = []
    for seed in seeds:
        t0 = time.perf_counter()
        slam, frames, dets, gt, world = text_setup(seed=seed)
        n_ok = sum(slam.track_monocular(img, float(i), detections=dets[i]) is not None
                   for i, img in enumerate(frames))
        kfs = slam.map.keyframes
        kf_ate = torch_synth.ate_rmse([kf.timestamp for kf in kfs],
                                      np.stack([slam.map.kf_pose[kf.kid] for kf in kfs]), gt)
        _, cosines, failed = text_planes(slam, gt, world)
        if n_ok < len(frames) - 5:
            failed.append(f"only {n_ok}/{len(frames)} frames tracked")
        if not kf_ate < KF_ATE_MAX:
            failed.append(f"keyframe ATE {kf_ate:.6f} >= {KF_ATE_MAX}")
        misses += [(seed, f) for f in failed]
        print(f"text seed {seed}: {'passed' if not failed else 'FAILED ' + str(failed)}; "
              f"{n_ok}/{len(frames)} tracked, {len(kfs)} KFs, KF ATE {kf_ate:.6f}, GOOD normals "
              f"{_planes_line(cosines)} ({time.perf_counter() - t0:.1f} s)  [{card}]", flush=True)
    print(f"text seeds: {len(seeds) - len({s for s, _ in misses})}/{len(seeds)} passed every bar")
    check(not misses, f"text seeds: {misses}")


def _long_summary(native: dict, longrun: dict, amnesia: dict, narrowing: dict) -> dict:
    """Phase 10's numbers for its JSON line."""
    keys = ("frames", "tracked", "keyframes", "kf_pool_cap", "points", "point_pool_cap", "texts",
            "saturation_drops", "loops", "ate", "kf_ate", "frame_ms_median",
            "kf_insert_ms_median", "frame_ms_median_by_block", "rss_start_mb", "rss_mb",
            "narrowing", "decomposed_closures", "wall_s")
    runs = longrun["closer_runs"]

    def closures(res):
        return [{k: c[k] for k in ("K", "ms", "decomposed", "loop")} for c in res["closures"]]

    return {"native": native,
            "rehearsal": {**{k: longrun[k] for k in keys},
                          "loop_miss_as_reference": longrun.get("loop_miss_as_reference", False),
                          "closer_runs": len(runs),
                          "closer_max_eligible": max(r["eligible"] for r in runs)},
            "closures": closures(longrun), "snapshots": longrun["snapshots"],
            "amnesia_run": {**{k: amnesia[k] for k in keys}, "closures": closures(amnesia),
                            "checkpoint_mb": amnesia["checkpoint_mb"],
                            "checkpoint_load_ms": amnesia["checkpoint_load_ms"],
                            "checkpoint_save_ms": longrun["checkpoint_save_ms"]},
            "narrowing": narrowing}


def _seeds(text: str):
    """'1,2,5-8' -> [1, 2, 5, 6, 7, 8]."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> int:
    import argparse
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed-study", metavar="SEEDS",
                    help="only run the text pipeline under these RANSAC seeds (e.g. 0-15) and "
                         "hold each run to the text bars")
    ap.add_argument("--long-only", action="store_true",
                    help="only run phase 9(c) and phase 10, the long regime (prints no result "
                         "line)")
    ap.add_argument("--long-side", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    from textslam_tpu_torch.ops import cuda_lib, matching, patch_sample

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if args.long_side:
        run_long_side(card, args.long_side)
        return 0
    if args.seed_study:
        run_text_seeds(_seeds(args.seed_study), card)
        return 0

    t0 = time.perf_counter()
    # the two kernels (nvcc) and the reader's host routines (g++), all started together
    names = ("hamming", "patch_sample", "jpeg_decode", "png_unfilter")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        libs = list(ex.map(cuda_lib.build, names))
    print(f"built {[os.path.relpath(p, root) for p in libs]} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc and g++ in parallel)")
    if args.long_only:
        side = LongSide()
        try:
            native = run_native(card, run_covis(card))
            longrun, amnesia, narrowing = side.finish()
        finally:
            side.stop()
        print(json.dumps({"long_regime": _long_summary(native, longrun, amnesia, narrowing)}))
        return 0
    for lib in libs:  # ptxas -v: registers, shared memory and spills of each kernel
        with open(lib + ".log") as f:
            print("\n".join(f"  {os.path.basename(lib)}: {line.strip()}" for line in f
                            if "ptxas info" in line or "spill" in line))
    # the Hamming kernel's distances come from the tensor cores' binary MMA
    sass = subprocess.run([os.path.join(os.path.dirname(cuda_lib.find_nvcc()), "cuobjdump"),
                           "-sass", libs[0]], capture_output=True, text=True, check=True).stdout
    n_bmma = sum("BMMA" in line for line in sass.splitlines())
    n_popc = sum(" POPC " in line for line in sass.splitlines())
    print(f"  {os.path.basename(libs[0])}: {n_bmma} BMMA (binary tensor-core MMA) and {n_popc} "
          f"POPC instructions in the SASS of both instantiations (cuobjdump)")
    check(n_bmma > 0, "the Hamming kernel has no BMMA instruction")

    hamming_rows = timed("3 hamming", compare_hamming, matching, card)
    sampler_rows = timed("4 sampler", compare_sampler, patch_sample, card)
    # phase 10(b-c) from here on in a process of its own, beside phases 5-10(a)
    side = LongSide()
    try:
        scene = timed("5 scene", run_scene, card)
        textrun = timed("6 text", run_text, card)
        looprun = timed("7 loop", run_loop, card)
        clirun = timed("8 cli", run_cli, card)
        # phase 9: scale-out
        sharded = timed("9a sharded BA", run_sharded_ba, card)
        meshrun = timed("9b mesh text", run_mesh_text, card, textrun)
        covis = timed("9c covisibility", run_covis, card)
        twoproc = timed("9d two processes", run_two_process, card)
        # phase 10: the long regime
        native = timed("10a native", run_native, card, covis)
        longrun, amnesia, narrowing = timed("10b-c (waiting for their process)", side.finish)
    finally:
        side.stop()
    print(f"[time] phases 1-10: {time.perf_counter() - T_START:.1f} s", flush=True)

    ham = hamming_rows[0]  # [4096, 1000]: every tracked frame below 4096 points
    # loop-time calls held against the plain version (phase 7)
    lchk = looprun["loop_kernel_checks"]
    ham_loop = [lchk[k] for k in ("hamming_matrix", "hamming_matrix_min") if k in lchk]
    smp_loop = lchk["grouped_bilinear_stack"]
    cli_err, mesh_err, long_err = (r["max_abs_err"] for r in (clirun, meshrun, longrun))
    ham = dict(ham, max_abs_err=max([r["max_abs_err"] for r in hamming_rows]
                                    + [v["max_abs_err"] for v in ham_loop]
                                    + [e.get(k, 0.0) for e in (cli_err, mesh_err, long_err)
                                       for k in ("hamming_matrix", "hamming_matrix_min")]))
    # level 0 of one frame's pyramid, G = 16: most of the path's launches
    smp = next(r for r in sampler_rows if r["case"] == "frame level view" and r["level"] == 0
               and r["groups"] == 16)
    smp = dict(smp, max_abs_err=max([r["max_abs_err"] for r in sampler_rows]
                                    + [smp_loop["max_abs_err"], cli_err["grouped_bilinear_stack"],
                                       mesh_err["grouped_bilinear_stack"],
                                       long_err["grouped_bilinear_stack"]]))
    path = [r for r in sampler_rows if r["on_path"]]
    print(f"sampler wrapper / grid_sample on the path: G=16 level 0 "
          f"{smp['ms'] / smp['library_ms']:.2f}, worst "
          f"{max(r['ms'] / r['library_ms'] for r in path):.2f} over {len(path)} cases  [{card}]")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": "hamming_matrix", "route": "cuda", "source": "textslam_tpu_torch/csrc/hamming.cu",
         "replaces": "textslam_tpu/ops/pallas_kernels.py:52",
         "launches": textrun["launches"]["hamming_matrix"],
         **{k: ham[k] for k in keys},
         **{k: ham[k] for k in ("ms_alt", "bound_alt_ms", "old_path_ms", "bf16_matmul_ms",
                                "device_ms", "device_ms_alt", "device_old_path_ms",
                                "device_bf16_matmul_ms")},
         "shape": ham["shape"],
         "launches_per_tracked_frame": textrun["launches_per_tracked_frame"]["hamming_matrix"],
         "launches_per_kf_insertion": textrun["launches_per_kf_insertion"]["hamming_matrix"],
         "launches_scene_run": scene["launches"]["hamming_matrix"],
         "launches_loop_run": looprun["launches_run"]["hamming_matrix"],
         "launches_loop_closure": looprun["launches_loop_closure"]["hamming_matrix"],
         "loop_calls_held_to_plain": sum(v["calls"] for v in ham_loop),
         "launches_cli_run": clirun["launches"]["hamming_matrix"],
         "cli_calls_held_to_plain": sum(clirun["calls_held"].get(k, 0)
                                        for k in ("hamming_matrix", "hamming_matrix_min")),
         "launches_mesh_run": meshrun["launches"]["hamming_matrix"],
         "mesh_calls_held_to_plain": sum(meshrun["calls_held"].get(k, 0)
                                         for k in ("hamming_matrix", "hamming_matrix_min")),
         "launches_long_run": longrun["launches"]["hamming_matrix"],
         "long_calls_held_to_plain": sum(longrun["calls_held"].get(k, 0)
                                         for k in ("hamming_matrix", "hamming_matrix_min"))},
        {"name": "grouped_bilinear_stack", "route": "cuda",
         "source": "textslam_tpu_torch/csrc/patch_sample.cu",
         "replaces": "textslam_tpu/ops/pallas_kernels.py:193",
         "launches": textrun["launches"]["grouped_bilinear_stack"],
         **{k: smp[k] for k in keys},
         **{k: smp[k] for k in ("launch_ms", "device_ms", "regions_ms")},
         "shape": {"stack": smp["stack"], "groups": smp["groups"], "Q": smp["Q"]},
         "launches_loop_run": looprun["launches_run"]["grouped_bilinear_stack"],
         "launches_loop_closure": looprun["launches_loop_closure"]["grouped_bilinear_stack"],
         "loop_calls_held_to_plain": smp_loop["calls"],
         "launches_cli_run": clirun["launches"]["grouped_bilinear_stack"],
         "cli_calls_held_to_plain": clirun["calls_held"]["grouped_bilinear_stack"],
         "launches_mesh_run": meshrun["launches"]["grouped_bilinear_stack"],
         "mesh_calls_held_to_plain": meshrun["calls_held"]["grouped_bilinear_stack"],
         "launches_long_run": longrun["launches"]["grouped_bilinear_stack"],
         "long_calls_held_to_plain": longrun["calls_held"]["grouped_bilinear_stack"]},
    ]
    print(json.dumps({"scale_out": {
        "sharded_ba_ms": sharded["ms"], "sharded_ba_costs": [sharded["cost_solve_ba"],
                                                             sharded["cost_solve_ba_sharded"]],
        "mesh_text": {k: meshrun[k] for k in ("kf_ate", "frame_ms_median", "kf_insert_ms_median",
                                               "solves", "kf_pose_diff_vs_phase6",
                                               "four_shards")},
        "covis": covis, "two_process": twoproc}}))
    print(json.dumps({"long_regime": _long_summary(native, longrun, amnesia, narrowing)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Benchmark of textslam_tpu_torch: one cell, one run.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the system from the cell's configuration, renders the world
of its traffic on the card (its strings drawn from the seed), and feeds the
sequence from frame 0 through the two-view initialisation and a fixed count
of tracked frames. The window then hands over one frame after another, each as soon
as the previous call returned (a closed loop, one client), until
`--seconds` have passed or the sequence ends. With `--trace 0` the last line
of standard output is the result with the cell's end-to-end metrics; with
`--trace 1` the per-layer metrics, from synchronised spans over the window
and the profiler over a fixed range of its frames. Every run then holds
what its timed path produced to the plain reference (lib/check.py) and
prints each compared number beside its limit, last, on standard error and
in the result line.
"""

import time

T_START = time.perf_counter()  # set-up counts from here, before the heavy imports

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(BENCH_DIR, "_cache")
# build and kernel caches at fixed paths in the checkout, so that only a
# cell's first run there builds
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
# one host thread for the BLAS and OpenMP pools: the loop is paced by one
# Python thread, and pools that spin on a host shared with other work
# spread the runs
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "textslam_tpu")
PROFILE_FRAMES = (1, 4)  # window frames [first, last) under the profiler


def forbidden_modules(modules=None) -> list:
    """Loaded modules (default: sys.modules) whose top-level name is one of
    FORBIDDEN, compared whole (textslam_tpu_torch is not textslam_tpu)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def program_config(config: dict, n_frames: int):
    """The program's configuration: the repository's yaml that the
    configuration file names, read by the program's own loader (the run
    refuses a yaml whose bytes are not the ones the file pins), then the
    file's `overrides` (TextSLAMConfig fields) and `settings` (groups of
    fields the yaml does not hold), with the pools derived from the
    sequence length as the program's command line does."""
    from textslam_tpu_torch.config import MapConfig, load_yaml

    path = os.path.join(ROOT, config["yaml_file"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != config["yaml_sha256"]:
        raise RuntimeError(f"{config['yaml_file']} is not the yaml this configuration was "
                           f"measured with (sha256 {digest})")
    cfg = dataclasses.replace(load_yaml(path), **config["overrides"])
    groups = {k: dataclasses.replace(getattr(cfg, k), **v) for k, v in config["settings"].items()}
    cfg = dataclasses.replace(cfg, **groups)
    return dataclasses.replace(cfg, map=MapConfig.derive(n_frames, cfg.camera.fps, cfg.map))


def run(args, c: dict, device: str = "cuda") -> dict:
    """One run of cell `c` on `device`; returns the result line's fields."""
    import numpy as np
    import torch
    from slambench.lib import check, probe, spec, trace
    from slambench.lib.world import Walk
    from textslam_tpu_torch.frontend.frame import TextDetection
    from textslam_tpu_torch.frontend.tracking import OK
    from textslam_tpu_torch.system import TextSLAM

    config, traffic = c["config"], c["traffic"]
    n_frames = int(config["sequence_frames"])
    cfg = program_config(config, n_frames)
    text_on = not cfg.no_text
    cam = dataclasses.asdict(cfg.camera)
    walk = Walk(traffic, args.seed, cam, n_frames, device, TextDetection)
    slam = TextSLAM(cfg, device=device)
    rec = probe.Recorder(sync=args.trace)
    undo = []
    if args.trace:
        undo.append(probe.install(spec.spans(c["per_layer"], c["bench_dir"]), slam, rec))
    cap = check.Capture({f + PROFILE_FRAMES[1] for f in check.checked_frames(args.seed)}, rec)
    undo += cap.install()

    # set-up: from frame 0 through the initialisation and the warm-up frames
    i = 0
    while slam.tracker.state != OK:
        if i >= min(int(traffic["init_max_frames"]), n_frames):
            raise RuntimeError(f"the system did not initialise within {i} frames")
        img, dets = walk.frame(i)
        slam.track_monocular(img, float(i), detections=dets)
        i += 1
    init_frame = i - 1
    for _ in range(int(traffic["warmup_tracked_frames"])):
        img, dets = walk.frame(i)
        slam.track_monocular(img, float(i), detections=dets)
        i += 1
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    # the window
    attempted = failed = stuck = 0
    last_pose = None
    prof = win_range = None
    rec.tracing = bool(args.trace)
    t0 = time.perf_counter()
    while i < n_frames:
        k = attempted
        over = time.perf_counter() - t0 >= args.seconds
        if over and not (args.trace and k < PROFILE_FRAMES[1]):
            break
        rec.frame = k
        if args.trace and k == PROFILE_FRAMES[0]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            rec.profiling = True
            win_range = torch.profiler.record_function(trace.WINDOW_RANGE)
            win_range.__enter__()
        with rec.span("bench.render"):
            img, dets = walk.frame(i)
        pose = slam.track_monocular(img, float(i), detections=dets)
        if pose is None:
            failed += 1
        elif last_pose is not None and np.array_equal(pose, last_pose):
            stuck += 1  # the camera moved, the pose did not
        last_pose = pose
        attempted += 1
        i += 1
        if prof is not None and k == PROFILE_FRAMES[1] - 1:
            if device == "cuda":
                torch.cuda.synchronize()
            win_range.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            rec.profiling = False
    if device == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    rec.tracing = False
    rec.frame = None
    for u in reversed(undo):
        u()
    found = forbidden_modules()
    if found:
        raise ImportError(f"loaded after the window: {', '.join(found)}")

    out = {"attempted": attempted, "failed": failed, "window_s": window_s, "setup_s": setup_s,
           "init_frame": init_frame, "last_frame": i - 1,
           "rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    if device == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_reserved()
        out["kind"] = torch.cuda.get_device_name(0)
    else:
        out["memory_peak_bytes"] = 0
        out["kind"] = "cpu"
    red = trace.reduce(prof) if prof is not None else None
    ctx = dict(out, spans=rec.spans, calls=rec.calls, trace=red,
               profiled_frames=PROFILE_FRAMES[1] - PROFILE_FRAMES[0] if red else 0)
    metrics = {}
    for m in (c["per_layer"] if args.trace else c["end_to_end"]):
        v = spec.metric_reader(m["name"], c["bench_dir"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if red is not None:
        a, b = red["window_us"]
        out["busy_s"] = trace.busy_us(red) * 1e-6
        out["traced_window_s"] = (b - a) * 1e-6
        out["breakdown"] = trace.breakdown(red)
    out["metrics"] = metrics

    # the check, with the system freed
    outputs = check.program_outputs(slam)
    rec.calls.clear()
    del slam, prof, red, ctx
    walk.textures = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = check.stage_numbers(cap, cfg, text_on)
    numbers["stuck_frames"] = float(stuck)
    numbers.update(check.accuracy_numbers(outputs, walk.layout, walk.poses, text_on))
    out["numbers"] = numbers
    out["correct"], out["checks"] = check.judge(numbers, config["limits"], config["stages"])
    out["n_texts"] = outputs["n_texts"]
    out["kf_frames"] = outputs["kf_ids"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from slambench.lib import spec

    bench = spec.load_benchmark(ROOT)
    c = spec.cell(bench, args.workload, ROOT)
    chips = int(c["workload"]["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    res = run(args, c)
    found = forbidden_modules()
    if found:
        print(f"slambench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    info = {k: res[k] for k in ("init_frame", "last_frame", "window_s", "setup_s",
                                "kf_frames", "n_texts")}
    print("slambench: " + json.dumps(info), file=sys.stderr)
    print("slambench: numbers " + json.dumps(res["numbers"]), file=sys.stderr)
    device = {"platform": "gpu", "kind": res["kind"], "count": chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "device": device}
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["traced_window_s"]
        line["breakdown"] = res["breakdown"]
    # last: each compared number beside its limit (a number that is not
    # finite is written as null, and fails)
    line["checks"] = {name: {"value": v if math.isfinite(v) else None, "limit": lim}
                      for name, v, lim in res["checks"]}
    for name, v, lim in res["checks"]:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

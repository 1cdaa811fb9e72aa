"""Helpers of the benchmark's own tests: run.py as a module, and tiny copies
of a cell that the CPU runs in well under a minute."""

import copy
import importlib.util
import os
import types

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_run_module():
    spec = importlib.util.spec_from_file_location("slambench_run", os.path.join(BENCH_DIR, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny(c: dict) -> dict:
    """A cell cut to a size the CPU runs in about a minute: 320x240 at the
    configuration's field of view and 10 frames a second (the camera moves
    six times as far a frame, and keyframes come every 5 frames), 500 /
    1,500 features, a 512-px texture, 3 warm-up frames."""
    c = copy.deepcopy(c)
    y = c["config"]["yaml"]
    cam = {k: y[f"Camera.{k}"] / 2 for k in ("fx", "fy", "cx", "cy")}
    cam.update(width=320, height=240, fps=10.0)  # a keyframe every 5 frames
    c["config"]["settings"] = {"orb": {"n_features": 500, "n_features_init": 1500},
                               "camera": cam}
    c["config"]["sequence_frames"] = 14
    c["traffic"].update({"texture_px": 512, "px_per_m": 250.0, "blobs": 1500,
                         "box_px": [[70, 110], [35, 55]], "speed_mps": 0.5,
                         "warmup_tracked_frames": 3, "init_max_frames": 30})
    return c


def tiny_run(cell_name: str, seed: int = 5, trace: int = 0, root: str = ROOT,
             bench_dir: str = BENCH_DIR) -> dict:
    """One run of a tiny copy of a cell on the CPU, through run.run: its
    window runs to the 14th frame of the sequence, frame 1 of it profiled
    and two of frames 2..5 checked."""
    from slambench.lib import check, spec

    c = tiny(spec.cell(spec.load_benchmark(root), cell_name, root, bench_dir))
    args = types.SimpleNamespace(seed=seed, seconds=1e9, trace=trace)
    run = load_run_module()
    run.PROFILE_FRAMES = (1, 2)
    saved = check.FIRST_FRAMES, check.CHECKED_FRAMES
    check.FIRST_FRAMES, check.CHECKED_FRAMES = 4, 2
    try:
        return run.run(args, c, device="cpu")
    finally:
        check.FIRST_FRAMES, check.CHECKED_FRAMES = saved

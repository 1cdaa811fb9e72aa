"""The check that decides `correct`: what the timed path produced, held to
the plain reference.

While the window runs, calls of the timed path are kept as they happen, at
the timed sizes: of a few window frames drawn from the seed, the frame the
benchmark handed over with the keypoints the frame build made of it, every
Hamming matrix the matcher computed and every pose solve of the track step;
of the whole window, the first grouped sampler calls and the first solves
of the windowed bundle adjustment. Once the window has closed and the
system is freed, the reference (`reference/`) works each of them out again
from the same inputs: the frame build from the benchmark's frame, the
matcher and the sampler on the program's own inputs, and each solve as the
plain float64 Levenberg-Marquardt solve of the problem the program built,
to convergence, against which the program's solution is held by the share
of the achievable decrease of the cost that it leaves. The run also counts
the window frames whose pose did not move while the camera did, and a
stage of the configuration's `stages` that compared nothing fails.

The accuracy of the run against the renderer's ground truth (the tracked
and keyframe poses, the text planes) is worked out and printed beside the
compared numbers, and is not compared (PERF.md).
"""

from __future__ import annotations

import inspect
import math
from typing import Dict, List

import numpy as np
import torch

from . import probe
from ..reference import ba_plain, groundtruth, hamming_plain, orb_plain, sampler_plain

CHECKED_FRAMES = 3  # window frames whose calls are kept
FIRST_FRAMES = 12  # ... drawn from the first this many of the window
SAMPLER_CALLS = 48  # most sampler calls kept in a run
BA_CALLS = 8  # most solves of the windowed BA kept in a run
MIN_DECREASE = 1e-4  # a solve counts where its optimum lies this far below its start


def checked_frames(seed: int) -> set:
    from .world import seed64

    rng = np.random.default_rng([seed64(seed), 0x5EED])
    return {int(i) for i in rng.choice(FIRST_FRAMES, CHECKED_FRAMES, replace=False)}


class Capture:
    """Keeps the calls of the checked frames (rec.frame in `frames`)."""

    def __init__(self, frames: set, rec: probe.Recorder):
        self.frames = frames
        self.rec = rec
        self.builds: List[dict] = []
        self.hamming: List[tuple] = []
        self.sampler: List[tuple] = []
        self.pose: List[tuple] = []  # (problem dict, program poses, program rho)
        self.ba: List[tuple] = []

    def _on(self) -> bool:
        return self.rec.frame in self.frames

    def _window(self) -> bool:
        return self.rec.frame is not None

    def install(self) -> list:
        from textslam_tpu_torch import system
        from textslam_tpu_torch.ops import matching, patch_sample
        from textslam_tpu_torch.solver import ba

        cap = self

        def build(orig):
            def f(cfg, img, *a, **kw):
                out = orig(cfg, img, *a, **kw)
                if cap._on():
                    dets = kw.get("detections") or []
                    cap.builds.append({
                        "frame": cap.rec.frame, "img": img.detach().clone(),
                        "quads": np.stack([d.quad for d in dets]) if dets else None,
                        "n_features": kw.get("n_features"),
                        "kp": out.kp_packed_dev.detach().clone()})
                return out
            return f

        def ham(orig):
            def f(*args):
                out = orig(*args)
                if cap._on():
                    cap.hamming.append(tuple(a.detach().clone() for a in args) + (out.clone(),))
                return out
            return f

        def samp(orig):
            def f(imgs, group_k, uv, *a, **kw):
                vals, mask = orig(imgs, group_k, uv, *a, **kw)
                if cap._window() and len(cap.sampler) < SAMPLER_CALLS and not a and not kw:
                    cap.sampler.append((imgs, imgs._version, group_k.clone(), uv.clone(),
                                        vals.clone(), mask.clone()))
                return vals, mask
            return f

        def solve(orig):
            defaults = {k: p.default for k, p in inspect.signature(orig).parameters.items()}

            def f(problem, *a, **kw):
                d = None
                if cap._window() and problem.scene is not None and problem.text is None and not a:
                    arg = dict(defaults, **kw)
                    d = scene_problem(problem, arg["huber_scene"])
                    if arg["no_free_poses"]:  # the solver holds every pose
                        d["pose_free"] = torch.zeros_like(d["pose_free"])
                    schedule = {k: arg[k] for k in ("n_iters", "lam0", "lam_up", "lam_down",
                                                    "lam_min", "lam_max")}
                    one_pose = int(d["pose_free"].sum()) == 1 and not bool(d["rho_free"].any())
                    if not (cap._on() if one_pose else len(cap.ba) < BA_CALLS):
                        d = None
                st = orig(problem, *a, **kw)
                if d is not None:
                    (cap.pose if one_pose else cap.ba).append(
                        (d, schedule, st.poses.detach().clone(), st.rho.detach().clone()))
                return st
            return f

        return [probe.patch(system, "build_frame", build),
                probe.patch(matching, "hamming_matrix", ham),
                probe.patch(matching, "hamming_matrix_min", ham),
                probe.patch(patch_sample, "grouped_bilinear_stack", samp),
                probe.patch(ba, "solve_ba", solve)]


def scene_problem(problem, huber: float) -> dict:
    """The program's scene-only BA problem as the reference's plain dict,
    copied at the call."""
    s = problem.scene
    d = {"poses": problem.poses, "pose_free": problem.pose_free, "rho": problem.rho,
         "rho_free": problem.rho_free, "tgt": s.tgt, "host": s.host,
         "host_pose": s.host_frozen_pose, "host_in_window": s.host_in_window,
         "point": s.point, "ray": s.ray, "uv": s.uv, "weight": s.weight, "valid": s.valid}
    d = {k: v.detach().clone() for k, v in d.items()}
    d.update(fx=float(problem.fx), fy=float(problem.fy), cx=float(problem.cx),
             cy=float(problem.cy), huber=float(huber))
    return d


def program_outputs(slam) -> dict:
    """What the run produced, copied out of the system before it is freed:
    tracked poses by frame, keyframe poses by frame, and the good text
    objects (plane, host frame, string)."""
    from textslam_tpu_torch.mapper.state import TEXT_GOOD

    m = slam.map
    traj = slam.tracker.trajectory
    kfs = [kf for kf in m.keyframes if m.kf_valid[kf.kid]]
    texts = [(m.tx_theta[t].copy(), int(round(m.keyframes[int(m.tx_host[t])].timestamp)),
              m.tx_string[t], len(m.kfs_observing_text(t)))
             for t in range(m.n_texts) if m.tx_valid[t] and m.tx_state[t] == TEXT_GOOD]
    return {"frame_ids": [int(round(t)) for t, _ in traj],
            "poses": np.stack([p for _, p in traj]) if traj else np.zeros((0, 7)),
            "kf_ids": [int(round(kf.timestamp)) for kf in kfs],
            "kf_poses": np.stack([m.kf_pose[kf.kid] for kf in kfs]) if kfs else np.zeros((0, 7)),
            "texts": texts, "n_texts": int(m.n_texts)}


def unpack_kp(packed: torch.Tensor) -> dict:
    return {"uv": packed[:, 0:2], "level": packed[:, 2].round().to(torch.int32),
            "valid": packed[:, 5] > 0.5,
            "desc": packed[:, 6:14].contiguous().view(torch.int32)}


def stage_numbers(cap: Capture, cfg, text_on: bool, control: bool = False) -> Dict[str, float]:
    """The frame build, the matcher and the sampler of the checked frames
    against the reference. With `control`, the reference computed in the
    next lower precision stands in the program's place."""
    orb_cfg = cfg.orb
    mism = comp = 0
    for b in cap.builds:
        kw = dict(n_features=b["n_features"] or orb_cfg.n_features, n_levels=orb_cfg.n_levels,
                  scale=orb_cfg.scale_factor, threshold=float(orb_cfg.fast_threshold_min),
                  quads=(b["quads"][:cfg.text.max_detections_per_frame]
                         if text_on and b["quads"] is not None and orb_cfg.n_box_features > 0
                         else None),
                  n_box=orb_cfg.n_box_features, shrink=orb_cfg.box_boundary_margin)
        ref = orb_plain.orb(b["img"], **kw)
        prog = (orb_plain.orb(b["img"], storage=torch.bfloat16, **kw) if control
                else unpack_kp(b["kp"]))
        m, c = orb_plain.keypoint_mismatch(prog, ref)
        mism, comp = mism + m, comp + c
    out = {"orb_mismatch_pct": 100.0 * mism / comp if comp else math.nan,
           "frames_checked": float(len(cap.builds))}
    if not control:
        worst = 0
        for call in cap.hamming:
            *ins, got = call
            d1, d2, alt = (ins[0], ins[1], None) if len(ins) == 2 else (ins[0], ins[2], ins[1])
            want = hamming_plain.hamming(d1, d2, alt)
            if got.numel():
                worst = max(worst, int((got.long() - want.long()).abs().max()))
        out["hamming_max_diff"] = float(worst)
        out["hamming_calls"] = float(len(cap.hamming))
    if text_on:
        err, mdiff = 0.0, 0
        for imgs, version, gk, uv, vals, mask in cap.sampler:
            if imgs._version != version:
                raise RuntimeError("a kept sampler input was changed in place after the call")
            ref_v, ref_m = sampler_plain.sample(imgs, gk, uv)
            if control:
                vals, mask = sampler_plain.sample(imgs, gk, uv, dtype=torch.float32,
                                                  storage=torch.bfloat16)
            e, d = sampler_plain.sample_error(vals, mask, ref_v, ref_m)
            err, mdiff = max(err, e), mdiff + d
        out["sampler_rel_err"] = err
        out["sampler_mask_diff"] = float(mdiff)
        out["sampler_calls"] = float(len(cap.sampler))
    for stage, calls in (("pose", cap.pose), ("ba", cap.ba)):
        worst, n = solve_gaps(calls, control)
        out[f"{stage}_gap"] = worst
        out[f"{stage}_calls"] = float(n)
    return out


def solve_gaps(calls: List[tuple], control: bool = False) -> tuple:
    """(widest gap, solves compared) of kept solves: each problem solved by
    the plain float64 LM on the program's schedule, the program's solution
    (with `control`, the same LM with its data and parameters in bfloat16)
    held to it by ba_plain.gap. A solve whose reference lies less than
    MIN_DECREASE of its start's cost below the start is not counted: there
    the share swings with rounding alone."""
    worst, n = 0.0, 0
    for d, schedule, poses, rho in calls:
        d = {k: (v.to(torch.float64) if torch.is_tensor(v) and v.is_floating_point() else v)
             for k, v in d.items()}
        ref = ba_plain.solve(d, **schedule)
        if control:
            low = ba_plain.solve(d, dtype=torch.float32, storage=torch.bfloat16, **schedule)
            got = tuple(a.to(torch.float64) for a in low)
        else:
            got = ba_plain.state_of(d, poses, rho)
        g, dec = ba_plain.gap(d, got, ref)
        if not dec >= MIN_DECREASE:
            continue
        n += 1
        worst = g if not g <= worst else worst  # NaN sticks
    return worst, n


def accuracy_numbers(outputs: dict, walk_layout: dict, gt_poses: np.ndarray,
                     text_on: bool) -> Dict[str, float]:
    """Tracked and keyframe ATE against ground truth; with text on, the
    plane errors of the good text objects (1 - |cos| of the normals).
    Printed, not compared (the module's docstring says why)."""
    out = {"track_ate_m": (groundtruth.ate_rmse(outputs["frame_ids"], outputs["poses"], gt_poses)
                           if len(outputs["frame_ids"]) >= 3 else math.inf),
           "kf_ate_m": (groundtruth.ate_rmse(outputs["kf_ids"], outputs["kf_poses"], gt_poses)
                        if len(outputs["kf_ids"]) >= 3 else math.inf)}
    if text_on:
        wall_of = {s: w for w, _, s in walk_layout["boxes"]}
        texts = [t for t in outputs["texts"] if t[2] in wall_of]
        objs = [(th, host, wall_of[s]) for th, host, s, _ in texts]
        errs = groundtruth.plane_errors(objs, walk_layout["walls"], gt_poses)
        out["plane_err_median"] = float(np.median(errs)) if errs else math.inf
        out["good_texts"] = float(len(errs))
        # (plane error, keyframes observing the object) of each good object
        out["plane_errs"] = [(round(e, 6), t[3]) for e, t in zip(errs, texts)]
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float], stages=()) -> tuple:
    """(correct, [(name, value, limit)]) for every number that has a limit;
    a number that is NaN or missing fails. `stages_empty` counts the
    stages of `stages` whose `<stage>_calls` (the frame build's
    `frames_checked`) is missing or 0."""
    count = {"orb": "frames_checked"}
    numbers = dict(numbers, stages_empty=float(sum(
        1 for s in stages if not numbers.get(count.get(s, f"{s}_calls"), 0) > 0)))
    rows = []
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        good = v <= limit  # NaN compares false
        ok = ok and good
        rows.append((name, v, limit))
    return ok, rows

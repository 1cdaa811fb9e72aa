#!/usr/bin/env python3
"""Where the windowed BA's scale goes on a device mesh.

    python3 chip_mesh_scale.py [--shards 1,2,4] [--frames 24] [--capture 7] [--out F.json]
    python3 chip_mesh_scale.py --device cpu --small   # 320x240 rehearsal

Monocular SLAM fixes one pose of each windowed BA (Tracker._local_ba's
window[:1]); while every host of the window's points and text objects is in
the window, scaling the world about that pose's centre (camera centres
moved, rho and theta divided) leaves every residual unchanged: the scale is
a gauge. This script measures how far each solve moves along it.

It runs chip_smoke.py's text run (its text_setup: the rendered 640x480 text
world, seed 0, the default config; with --small the 320x240 world of
tests/test_torch_e2e_mesh.py) without a mesh and with the tracker's and the
map's mesh set to each shard count (Mesh([device] * n)), and prints:

- per run: keyframes, KF ATE, and the keyframe poses against the run
  without a mesh (raw, Sim3 scale, Sim3-aligned centres, quaternions);
- per windowed solve of each mesh run: its level, final lam and cost, and
  the gauge factor g, the least-squares scale of the free keyframes' camera
  centres about the fixed one's, after the solve against before (1.0: no
  move along the gauge), with the largest centre motion g leaves unexplained;
- for the first --capture solves of the first mesh run: the same problem
  solved again on every shard count with n_iters = 0, 1, ..., N (the LM is
  deterministic, so this is its path), each iterate's g, lam and cost; and
  the relative cost change when the solution is scaled by 1.1 about the
  fixed pose (zero for an exact gauge).

With --out, writes everything as JSON to that file too. Exits non-zero
without a CUDA device unless --device cpu. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "tests"))
sys.path.insert(0, HERE)


def centres(poses):
    """Camera centres [K, 3] (float64) of world-to-camera poses [K, 7]."""
    import numpy as np
    from textslam_tpu_torch.geometry import se3_np

    return se3_np.inverse(np.asarray(poses, np.float32))[:, 4:7].astype(np.float64)


def gauge_factor(before, after, free):
    """(g, rest): the least-squares scale of the free camera centres about
    slot 0's (the fixed pose) after against before, and the largest centre
    motion that scale leaves unexplained."""
    import numpy as np

    c0, c1 = centres(before), centres(after)
    d0, d1 = c0[free] - c0[0], c1[free] - c1[0]
    if not len(d0):
        return float("nan"), float("nan")
    g = float((d1 * d0).sum() / max((d0 * d0).sum(), 1e-300))
    return g, float(np.linalg.norm(d1 - g * d0, axis=-1).max())


def rescaled(prob, s: float):
    """`prob` with the world scaled by s about slot 0's camera centre:
    centres moved, rotations kept, rho and theta divided by s (hosts outside
    the window move too, so the map is the same map at another scale)."""
    import numpy as np
    import torch
    from textslam_tpu_torch.geometry import se3_np

    c_f = centres(prob.poses.cpu().numpy()[:1])[0]

    def move(p):
        a = p.detach().cpu().numpy().astype(np.float64)
        R = np.stack([se3_np.qto_matrix(q) for q in a[:, :4]])
        c = -np.einsum("kji,kj->ki", R, a[:, 4:7])
        t = -np.einsum("kij,kj->ki", R, c_f + s * (c - c_f))
        return torch.as_tensor(np.concatenate([a[:, :4], t], 1), dtype=p.dtype, device=p.device)

    out = prob._replace(poses=move(prob.poses), rho=prob.rho / s)
    if prob.scene is not None:
        out = out._replace(scene=prob.scene._replace(
            host_frozen_pose=move(prob.scene.host_frozen_pose)))
    if prob.text is not None:
        out = out._replace(theta=prob.theta / s, text=prob.text._replace(
            host_frozen_pose=move(prob.text.host_frozen_pose)))
    return out


def setup(args, dev):
    """(slam factory, frames, detections, ground truth)."""
    import dataclasses
    import torch_synth
    from textslam_tpu_torch import config
    from textslam_tpu_torch.system import TextSLAM

    if not args.small:
        import chip_smoke

        _, frames, dets, gt, _ = chip_smoke.text_setup(args.frames)
        cfg = dataclasses.replace(config.TextSLAMConfig(),
                                  camera=chip_smoke._camera(torch_synth, config))
    else:
        K = torch_synth.K.copy()
        K[:2] /= 2
        frames, dets, gt, _ = torch_synth.render_text_sequence(args.frames, K_mat=K,
                                                               size=(320, 240))
        cfg = config.TextSLAMConfig(
            camera=config.CameraConfig(fx=210.0, fy=210.0, cx=160.0, cy=120.0, width=320,
                                       height=240, fps=10.0),
            orb=config.ORBConfig(n_features=500, n_features_init=1500))
    return (lambda: TextSLAM(cfg, device=dev)), frames, dets, gt


def run(make, frames, dets, mesh, log, capture: int):
    """Feed the frames; every Tracker._solve appends its row to log, and the
    first `capture` solves keep (problem, kwargs)."""
    from textslam_tpu_torch.frontend import tracking

    orig = tracking.Tracker._solve
    kept = []

    def solve(self, prob, **kw):
        st = orig(self, prob, **kw)
        free = prob.pose_free.cpu().numpy()
        g, rest = gauge_factor(prob.poses.cpu().numpy(), st.poses.cpu().numpy(), free)
        log.append({"text": prob.text is not None,
                    "level": None if prob.text is None else int(prob.text.level),
                    "free_kfs": int(free.sum()), "lam": float(st.lam), "cost": float(st.cost),
                    "g": g, "rest": rest})
        if len(kept) < capture:
            kept.append((prob, kw))
        return st

    slam = make()
    if mesh is not None:
        slam.tracker.mesh = slam.map._covis_mesh = mesh
    tracking.Tracker._solve = solve
    try:
        for i, img in enumerate(frames):
            slam.track_monocular(img, float(i), detections=dets[i])
    finally:
        tracking.Tracker._solve = orig
    return slam, kept


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", default="1,2,4")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--capture", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch_synth
    from textslam_tpu_torch.parallel import ba_sharded
    from textslam_tpu_torch.parallel.mesh import Mesh

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("chip_mesh_scale: no CUDA device", file=sys.stderr)
        return 2
    card = "cpu"
    if dev.type == "cuda":
        import chip_smoke

        card = chip_smoke.card_line()
        print(card)
    shards = [int(s) for s in args.shards.split(",")]
    make, frames, dets, gt = setup(args, dev)
    out = {"card": card, "frames": len(frames), "small": args.small, "runs": {}}

    ref = None
    captured = None
    for n in [0] + shards:
        log = []
        t0 = time.perf_counter()
        slam, kept = run(make, frames, dets, None if n == 0 else Mesh([dev] * n), log,
                         args.capture if captured is None and n else 0)
        if n and captured is None:
            captured = (n, kept)
        kfs = slam.map.keyframes
        kp = np.stack([slam.map.kf_pose[kf.kid] for kf in kfs])
        r = {"shards": n, "kfs": len(kfs), "s": time.perf_counter() - t0,
             "kf_ate": torch_synth.ate_rmse([kf.timestamp for kf in kfs], kp, gt),
             "solves": log, "g_product": float(np.prod([e["g"] for e in log if e["free_kfs"]]))
             if log else None}
        if ref is None:
            ref = kp
        elif kp.shape == ref.shape:
            s, R, t = torch_synth._horn_alignment(centres(ref), centres(kp))
            r["vs_no_mesh"] = {
                "raw": float(np.abs(kp - ref).max()), "sim3_scale": float(s),
                "centres_sim3": float(np.linalg.norm(s * centres(kp) @ R.T + t - centres(ref),
                                                     axis=-1).max()),
                "rotations": float(np.abs(kp[:, :4] - ref[:, :4]).max())}
        name = "no mesh" if n == 0 else f"{n}-shard mesh"
        print(f"== {name}: {r['kfs']} KFs, KF ATE {r['kf_ate']:.6f}, {r['s']:.1f} s; vs no mesh "
              f"{r.get('vs_no_mesh')}; product of gauge factors {r['g_product']}")
        for i, e in enumerate(log):
            print(f"   solve {i:2d} level {e['level']} free KFs {e['free_kfs']}: g "
                  f"{e['g']:.6f} (rest {e['rest']:.2e}), lam {e['lam']:.3g}, cost {e['cost']:.7g}")
        out["runs"][name] = r

    # the captured solves again on every shard count, iterate by iterate
    n0, kept = captured
    out["paths"] = []
    for i, (prob, kw) in enumerate(kept):
        kw = {k: v for k, v in kw.items() if k != "no_free_poses"}
        free = prob.pose_free.cpu().numpy()
        one = Mesh([dev])
        path = {"solve": i, "level": None if prob.text is None else int(prob.text.level),
                "n_iters": kw["n_iters"], "by_shards": {}}
        for n in shards:
            mesh = Mesh([dev] * n)
            rows = []
            for it in range(kw["n_iters"] + 1):
                st = ba_sharded.solve_ba_sharded(prob, mesh, **dict(kw, n_iters=it))
                g, _ = gauge_factor(prob.poses.cpu().numpy(), st.poses.cpu().numpy(), free)
                rows.append((g, float(st.lam), float(st.cost)))
            path["by_shards"][n] = rows
            if n == shards[0]:
                sol = prob._replace(poses=st.poses, rho=st.rho, theta=st.theta)
                c1 = float(ba_sharded.solve_ba_sharded(sol, one, **dict(kw, n_iters=0)).cost)
                c2 = float(ba_sharded.solve_ba_sharded(rescaled(sol, 1.1), one,
                                                       **dict(kw, n_iters=0)).cost)
                path["cost_change_at_scale_1.1"] = (c2 - c1) / max(abs(c1), 1e-30)
        out["paths"].append(path)
        print(f"== solve {i} of the {n0}-shard run again (level {path['level']}, "
              f"{kw['n_iters']} iterations), per iterate g / lam / cost; cost change at scale "
              f"1.1: {path['cost_change_at_scale_1.1']:.3e}")
        for n, rows in path["by_shards"].items():
            print(f"   {n} shards: " + " ".join(f"{it}:{g:.5f}/{lam:.0e}/{c:.7g}"
                                              for it, (g, lam, c) in enumerate(rows)))

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())

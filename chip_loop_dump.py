#!/usr/bin/env python3
"""The map states of the port's loop run on one GPU, for replaying each
step that moves text planes in both packages on the CPU.

    python3 chip_loop_dump.py [OUT]      (default tmp/loop_dump.pkl.gz)

Runs chip_smoke.py's loop run (its loop_setup: the 640x480 outback fixture
with amnesia, the default configuration; then the last 3 frames again with
the amnesia lifted, and landmark_theta_pass once) on the card, and from the
loop correction on records every step that can move a text plane: the
correction (LoopCloser.correct), each Tracker._local_ba (the landmark-only
BA inside the correction, then the windowed BAs of the later keyframes)
and landmark_theta_pass. For each step it keeps the host map at its entry,
its arguments and the thetas, inverse depths, poses and text flags it left,
and prints the digest of the map it starts from (chip_smoke.map_digest) and
the GOOD text objects whose plane normal moved against ground truth. Writes them as a gzipped pickle: {"steps": [{"name", "args", "map",
"after"}, ...]}; keyframe pyramids are left out (tests/loop_correct_compare.py
rebuilds them from the rendered frames and replays each step in the JAX
package and the port). Imports neither jax nor the JAX package; exits
non-zero without a CUDA device or when no loop closes.
"""

from __future__ import annotations

import copy
import gzip
import os
import pickle
import sys


def after_state(m) -> dict:
    """What a step may change: thetas, inverse depths, poses, text flags."""
    return {"tx_theta": m.tx_theta.copy(), "pt_rho": m.pt_rho.copy(),
            "kf_pose": m.kf_pose.copy(), "tx_valid": m.tx_valid.copy(),
            "tx_state": m.tx_state.copy(), "tx_obs_good": dict(m.tx_obs_good),
            "tx_feat_good": copy.deepcopy(m.tx_feat_good)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_loop_dump: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    from chip_smoke import (N_LOOP_FRAMES, N_LOOP_REFEED, card_line, check, loop_setup,
                            map_digest, map_state, text_planes)

    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(root, "tmp",
                                                                 "loop_dump.pkl.gz")
    card = card_line()
    print(card)
    slam, frames, dets, gt, world, track = loop_setup()
    lc, tr, m = slam.loop_closer, slam.tracker, slam.map
    tf = tr.text_frontend
    steps, active = [], [False]

    def planes():
        return {c["tid"]: c for c in text_planes(slam, gt, world)[1]}

    def recorded(name, fn):
        def wrapped(*args, **kw):
            active[0] |= name == "correct"
            if not active[0]:
                return fn(*args, **kw)
            step = {"name": name, "args": copy.deepcopy((args, kw)), "map": map_state(m)}
            before = planes()
            out = fn(*args, **kw)
            step["after"] = after_state(m)
            steps.append(step)
            after = planes()
            moved = [(t, a["string"], a["kf_obs"], round(before[t]["cos"], 5) if t in before
                      else None, round(a["cos"], 5)) for t, a in after.items()
                     if t not in before or abs(a["cos"] - before[t]["cos"]) > 0.01]
            print(f"step {len(steps) - 1} {name} {kw or ''}, input map digest "
                  f"{map_digest(step['map'])[:16]}: GOOD objects whose normal moved (tid, string, "
                  f"KF obs, cos before, after): {moved}", flush=True)
            return out
        return wrapped

    lc.correct = recorded("correct", lc.correct)
    tr._local_ba = recorded("local_ba", tr._local_ba)
    for i, img in enumerate(frames):
        track(img, float(i), detections=dets[i])
    check(lc.closed_loops, "the loop run closed no loop")
    track.amnesia["cutoff"] = None
    for i in range(N_LOOP_FRAMES - N_LOOP_REFEED, N_LOOP_FRAMES):
        slam.track_monocular(frames[i], float(i), detections=dets[i])
    recorded("landmark_theta_pass", tf.landmark_theta_pass)()
    print(f"loop closed {lc.closed_loops}; GOOD objects at the end (tid, string, KF obs, cos): "
          f"{[(t, c['string'], c['kf_obs'], round(c['cos'], 5)) for t, c in planes().items()]}"
          f"  [{card}]")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with gzip.open(out_path, "wb") as f:
        pickle.dump({"steps": steps}, f)
    print(f"wrote {os.path.relpath(out_path, root)} ({os.path.getsize(out_path) / 2**20:.1f} MiB, "
          f"{len(steps)} steps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The JAX package on tests/test_scale_rehearsal.py's fixture, for reference.

    JAX_PLATFORMS=cpu python tests/rehearsal_reference.py [--frames 200] [--write-record]

Runs textslam_tpu (the reference) on the CPU, on an 8-device virtual mesh as
the test suite does, through test_scale_rehearsal's fixture: N frames of the
text world (seed 3, 3 boxes per plane) on the `outback2` path, the default
configuration with the pools derived from the sequence length and
global_decompose_kfs 16, the one-hot camera assembly forced off. The loop
closer is watched at every run past its gates: the keyframe count K, how
many keyframes are M1/M2/M3-covisible with the current one, how many are
left eligible as candidates, the word threshold and the candidates. Prints
a line every 10 frames and the result; --write-record writes it to
tests/rehearsal_reference.json, which chip_smoke.py phase 10(b) reads: a
port run that closes no loop on this fixture passes only where this record
closes none either and, as in the port, the covisibility exclusion left no
keyframe eligible at any run. Takes ~2 h at 200 frames.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RECORD = os.path.join(HERE, "rehearsal_reference.json")
FIXTURE = ("tests/test_scale_rehearsal.py: outback2, TextWorld(seed=3, boxes_per_plane=3), "
           "MapConfig.derive(N, 10.0), global_decompose_kfs 16, ONEHOT_MAX_PAIR_BUCKETS 1")


def build_record(n_frames, closer_runs, census, keyframes, loops, ate, drops):
    """The record phase 10(b) reads: the run's result, the closer's runs and
    the text objects every keyframe observes at the end (census: one dict per
    object with its string `s` and observing-keyframe count `nkf`)."""
    return {
        "fixture": FIXTURE, "package": "textslam_tpu on the CPU (8-device virtual mesh)",
        "frames": n_frames, "keyframes": keyframes, "loops": [list(p) for p in loops],
        "ate": ate, "saturation_drops": drops,
        "closer_runs": [{"kid": r["kid"], "K": r["K"], "covisible": r["any"],
                         "eligible": r["K"] - 1 - r["any"], "min_words": r.get("min_words"),
                         "candidates": r.get("cands")} for r in closer_runs if r["enough"]],
        "texts_seen_by_every_kf": sorted(t["s"] for t in census if t["nkf"] == keyframes),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--write-record", action="store_true")
    args = ap.parse_args()
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import numpy as np
    import synth
    from textslam_tpu.config import CameraConfig, MapConfig, TextSLAMConfig
    from textslam_tpu.loop import closing
    from textslam_tpu.solver import ba
    from textslam_tpu.system import TextSLAM

    n = args.frames
    world = synth.TextWorld(seed=3, boxes_per_plane=3)
    poses = synth.camera_path(n, "outback2")
    cfg = TextSLAMConfig(no_text=False, camera=CameraConfig(
        fx=synth.FX, fy=synth.FY, cx=synth.CX, cy=synth.CY, width=synth.W, height=synth.H,
        fps=10.0))
    cfg = dataclasses.replace(cfg, map=MapConfig.derive(n, cfg.camera.fps, cfg.map),
                              solver=dataclasses.replace(cfg.solver, global_decompose_kfs=16))
    ba.ONEHOT_MAX_PAIR_BUCKETS = 1
    runs = []
    thresh_words, detect = closing.LoopCloser._thresh_words, closing.LoopCloser.detect

    def thresh_spy(self, kid):
        out = thresh_words(self, kid)
        m, K = self.map, len(self.map.keyframes)
        covis = (m.M1[kid, :K] > 0) | (m.M2[kid, :K] > 0) | (m.M3[kid, :K] > 0)
        runs.append({"kid": kid, "K": K, "enough": out[2], "any": int(covis.sum())})
        return out

    def detect_spy(self, kid, min_words, connects=frozenset()):
        out = detect(self, kid, min_words, connects)
        runs[-1].update(min_words=min_words, cands=out)
        return out

    closing.LoopCloser._thresh_words, closing.LoopCloser.detect = thresh_spy, detect_spy
    slam = TextSLAM(cfg)
    t0 = time.time()
    for i in range(n):
        slam.track_monocular(world.render(poses[i]), float(i), detections=world.detections(poses[i]))
        if (i + 1) % 10 == 0:
            print(f"frame {i + 1}: {len(slam.map.keyframes)} KFs, loops "
                  f"{slam.loop_closer.closed_loops}, {time.time() - t0:.0f} s", flush=True)
    m = slam.map
    K = len(m.keyframes)
    census = [{"s": m.tx_string[t], "nkf": int(m.tx_inc[t, :K].sum())} for t in range(m.n_texts)]
    traj = slam.tracker.trajectory
    ate = synth.ate_rmse([t for t, _ in traj], np.stack([p for _, p in traj]), poses)
    rec = build_record(n, runs, census, K, slam.loop_closer.closed_loops, ate,
                       dict(m.saturation_drops))
    print(json.dumps(rec))
    if args.write_record:
        with open(RECORD, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()

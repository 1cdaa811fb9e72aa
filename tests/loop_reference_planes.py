"""The JAX package on chip_smoke.py phase 7's fixture, for reference.

    JAX_PLATFORMS=cpu python tests/loop_reference_planes.py

Runs textslam_tpu (the reference) on the CPU through tests/test_e2e_loop.py's
out-and-back fixture at 640x480 (32 frames of the `outback` path, world seed
0, fps 6, the fixture's loop gates and amnesia, then the last 3 frames again)
with the default configuration otherwise, as chip_smoke.py phase 7 runs the
port on the card. Prints the closed loops, the keyframe ATE and every GOOD
text object's plane normal against ground truth with its box width in the
host keyframe (the quantities phase 7 holds the port to). Takes ~6 min.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import synth  # noqa: E402
import torch_synth  # noqa: E402
from textslam_tpu import config  # noqa: E402
from textslam_tpu.mapper.state import TEXT_GOOD  # noqa: E402
from textslam_tpu.system import TextSLAM  # noqa: E402

N_FRAMES = 32


def main():
    frames, dets, gt, _ = synth.render_text_sequence(n_frames=N_FRAMES, seed=0, kind="outback")
    world = torch_synth.TextWorld(seed=0)  # the same boxes, strings and planes
    cfg = config.TextSLAMConfig(
        camera=config.CameraConfig(fx=synth.FX, fy=synth.FY, cx=synth.CX, cy=synth.CY,
                                   width=synth.W, height=synth.H, fps=6.0),
        loop=config.LoopConfig(min_kfs_before_loop=6, min_kfs_between_loops=5,
                               num_covis_for_thresh=3))
    slam = TextSLAM(cfg)
    cutoff = {"now": None, "quarter": None}

    def amnesia(pt_valid):
        if cutoff["now"] is not None:
            n = min(slam.map.n_points, len(pt_valid))
            pt_valid[:n] &= ~(slam.map.pt_host[:n] < cutoff["now"])
        return pt_valid

    def text_amnesia(n_texts):
        mask = np.ones(n_texts, bool)
        if cutoff["now"] is not None:
            mask &= ~(slam.map.tx_host[:n_texts] < cutoff["now"])
        return mask

    slam.tracker.pt_candidate_hook = amnesia
    slam.tracker.text_frontend.pool_mask_hook = text_amnesia
    for i, img in enumerate(frames):
        if i == N_FRAMES // 4:
            cutoff["quarter"] = len(slam.map.keyframes)
        if i == N_FRAMES // 2:
            cutoff["now"] = cutoff["quarter"]
        slam.track_monocular(img, float(i), detections=dets[i])
    cutoff["now"] = None
    for i in range(N_FRAMES - 3, N_FRAMES):
        slam.track_monocular(frames[i], float(i), detections=dets[i])

    m = slam.map
    kfs = m.keyframes
    ate = torch_synth.ate_rmse([kf.timestamp for kf in kfs],
                               np.stack([m.kf_pose[kf.kid] for kf in kfs]), gt)
    print(f"closed loops {slam.loop_closer.closed_loops}, {len(kfs)} KFs, keyframe ATE {ate:.6f}")
    for tid in range(m.n_texts):
        if not (m.tx_valid[tid] and m.tx_state[tid] == TEXT_GOOD):
            continue
        box = next(b for b in world.boxes if b[2] == m.tx_string[tid])
        th_gt = torch_synth.plane_theta_in_cam(world.planes[box[0]][0],
                                               gt[kfs[int(m.tx_host[tid])].frame_id])
        th = m.tx_theta[tid]
        cos = abs(th @ th_gt) / (np.linalg.norm(th) * np.linalg.norm(th_gt) + 1e-12)
        print(f"GOOD object {tid} {m.tx_string[tid]}: host KF {int(m.tx_host[tid])}, "
              f"{len(m.kfs_observing_text(tid))} KF observations, box "
              f"{np.ptp(m.tx_quad[tid][:, 0]):.1f} px wide, normal cos {cos:.5f}")


if __name__ == "__main__":
    main()

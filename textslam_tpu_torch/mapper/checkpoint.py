"""Map + tracker state checkpointing (crash-durable resume). Port of
textslam_tpu/mapper/checkpoint.py.

The reference's only durable artifact is the rewritten trajectory file
(keyframe_latest.txt, src/tracking.cc:2564-2586) — not a resumable map.
Here the full SoA map state (poses, landmark pools, observations,
covisibility, text reference data) and the tracker's motion state serialize
to a single compressed npz; `load` restores a runnable system mid-sequence.

The file is the JAX package's: the same keys and the same `__meta__` JSON,
so a checkpoint written by either package loads in the other (each ignores
the keys it does not know). Keyframe pyramids are read back from the device
to be saved; on load the last `ba_window + 8` keyframes' pyramids go back
to `device`.

Beyond the JAX package's keys, the port saves three pieces of the text
frontend's state that the JAX package drops, so that a resumed run repeats
the uninterrupted one: the text-row count of the latest refinement
(`tf_last_text_rows`, which picks the next frame's pose chi2 gate), the
maturation budget's round-robin cursor (`tf_imm_rr`) and the KLT
accumulator of the latest keyframe's new boxes (`tf_klt_*`: its tracks and
the packed pyramid levels they were last tracked on), as
TextFrontend.resume_state returns them. A checkpoint without them (the JAX
package's, or an older one) starts them afresh, as the JAX package's load
does: no tracks until the next keyframe, cursor and count 0.

Random streams: the port draws its RANSAC sets from torch.Generators, not
JAX keys. It saves each generator's state (`tf_gen_state` for the text
frontend's theta RANSAC, `lc_gen_state` for the loop closer's Sim3 RANSAC)
with the generators' device type in `__meta__["generators"]`, and restores
a state only onto a generator of the same device type. A checkpoint of the
JAX package (its `tf_key`) or of another device type cannot continue the
saved stream: the generator then starts again from its seed (cfg.seed + 1,
+ 2), and a warning says so.
"""

from __future__ import annotations

import json
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from .state import SlamMap, Keyframe, TEXT_GOOD
from ..frontend.frame import TextDetection, host_pyr

log = logging.getLogger(__name__)

_MAP_FIELDS = ("pt_host", "pt_ray", "pt_rho", "pt_valid", "pt_bad", "pt_desc",
               "pt_desc_latest", "pt_desc_second",
               "pt_good_obs", "pt_bad_obs", "pt_n_obs",
               "tx_host", "tx_theta", "tx_state", "tx_valid", "tx_quad",
               "tx_score", "tx_sem_score", "tx_lang", "tx_good_obs", "tx_bad_obs",
               "tx_num_obvs", "tx_cov",
               "tx_feat_uv", "tx_feat_ref", "tx_feat_valid",
               "M1", "M2", "M3")
# generator-state key -> (owner attribute, seed offset from cfg.seed)
_GENERATORS = {"tf_gen_state": ("text_frontend", 1), "lc_gen_state": ("loop_closer", 2)}


def save(path: str, slam_map: SlamMap, tracker=None, text_frontend=None,
         extra: Optional[dict] = None, loop_closer=None):
    blobs = {}
    m = slam_map
    blobs["kf_pose"] = m.kf_pose
    blobs["kf_valid"] = m.kf_valid
    for name in _MAP_FIELDS:
        blobs[name] = getattr(m, name)
    blobs["n_points"] = np.asarray(m.n_points)
    blobs["n_texts"] = np.asarray(m.n_texts)
    blobs["tx_obs_keys"] = np.asarray([[k, t] for (k, t) in m.tx_obs], np.int32).reshape(-1, 2)
    blobs["tx_obs_vals"] = np.asarray(list(m.tx_obs.values()), np.int32)
    # per-observation good flags + per-(KF, feature) flags (aligned with
    # tx_obs_keys order)
    blobs["tx_obs_good"] = np.asarray(
        [m.tx_obs_good.get(k, True) for k in m.tx_obs], bool)
    if m.tx_obs:
        blobs["tx_feat_good"] = np.stack(
            [m.tx_feat_good.get(k, np.ones_like(m.tx_feat_valid[0]))
             for k in m.tx_obs])

    meta = {
        "tx_string": m.tx_string[: m.n_texts],
        "n_keyframes": len(m.keyframes),
        "extra": extra or {},
    }
    kf_meta = []
    for i, kf in enumerate(m.keyframes):
        kf_meta.append({
            "kid": kf.kid, "frame_id": kf.frame_id, "timestamp": kf.timestamp,
            "loop_edges": kf.loop_edges,
            "det_text": [
                {"text": d.text, "score": d.score, "lang": d.lang}
                for d in (kf.det_text or [])
            ],
        })
        blobs[f"kf{i}_kp_uv"] = kf.kp_uv
        blobs[f"kf{i}_kp_level"] = kf.kp_level
        blobs[f"kf{i}_kp_angle"] = kf.kp_angle
        blobs[f"kf{i}_kp_desc"] = kf.kp_desc
        blobs[f"kf{i}_kp_valid"] = kf.kp_valid
        blobs[f"kf{i}_kp_point"] = kf.kp_point
        blobs[f"kf{i}_obs_good"] = kf.obs_good
        if host_pyr(kf) is not None:
            blobs[f"kf{i}_pyr_data"] = kf.pyr_data
            blobs[f"kf{i}_pyr_shapes"] = kf.pyr_shapes
        if kf.det_quads is not None:
            blobs[f"kf{i}_det_quads"] = kf.det_quads
            blobs[f"kf{i}_det_object"] = kf.det_object
    meta["keyframes"] = kf_meta

    if tracker is not None:
        meta["tracker"] = {
            "state": int(tracker.state),
            "last_kf_frame_id": int(tracker.last_kf_frame_id),
            "n_tracked_last_kf": int(tracker.n_tracked_last_kf),
        }
        if tracker.last_pose is not None:
            blobs["trk_last_pose"] = tracker.last_pose
        if tracker.velocity is not None:
            blobs["trk_velocity"] = tracker.velocity
        if tracker.trajectory:
            blobs["trk_traj_ts"] = np.asarray([t for t, _ in tracker.trajectory])
            blobs["trk_traj_poses"] = np.stack([p for _, p in tracker.trajectory])
    if text_frontend is not None:
        blobs["tf_box_uv"] = text_frontend.tx_box_uv
        blobs["tf_box_int"] = text_frontend.tx_box_int
        blobs["tf_box_valid"] = text_frontend.tx_box_valid
        blobs["tf_host_stats"] = text_frontend.tx_host_stats
        blobs.update(text_frontend.resume_state())
    owners = {"text_frontend": text_frontend, "loop_closer": loop_closer}
    gen_device = None
    for key, (owner, _) in _GENERATORS.items():
        if owners[owner] is not None:
            gen = owners[owner]._gen
            blobs[key] = gen.get_state().numpy()
            gen_device = gen.device.type
    if gen_device is not None:
        meta["generators"] = {"device": gen_device}

    blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **blobs)


def _restore_generator(gen: torch.Generator, z, key: str, saved_device, seed: int, path: str):
    """Continue the saved stream of `key` on `gen`, or start it again from
    `seed` (with a warning) when the checkpoint holds no state for this
    device type."""
    if key in z and saved_device == gen.device.type:
        gen.set_state(torch.from_numpy(z[key].copy()))
        return
    why = (f"no {key} (a JAX-package checkpoint keeps PRNG keys)" if key not in z
           else f"{key} is a {saved_device} generator's state, not {gen.device.type}")
    log.warning("%s: %s; the %s random stream restarts from seed %d", path, why, key, seed)
    gen.manual_seed(seed)


def load(path: str, cfg, tracker=None, text_frontend=None, loop_closer=None, *,
         device) -> Tuple[SlamMap, dict]:
    """The map of a checkpoint (either package's) and the caller-supplied
    `extra` dict saved with it; restores the tracker's, text frontend's and
    loop closer's state where they are given."""
    from ..frontend.frame import check_device

    dev = check_device(device, "checkpoint.load")
    with np.load(path, allow_pickle=False) as npz:
        z = {k: npz[k] for k in npz.files}
    meta = json.loads(bytes(z["__meta__"]).decode())
    m = SlamMap(cfg, device=dev)
    m.kf_pose = z["kf_pose"].copy()
    m.kf_valid = z["kf_valid"].copy()
    # fields added after a checkpoint was written keep their SlamMap.__init__
    # defaults (forward-compatible loads; pt_n_obs is recomputed below)
    for name in _MAP_FIELDS:
        if name in z:
            setattr(m, name, z[name].copy())
    m.n_points = int(z["n_points"])
    m.n_texts = int(z["n_texts"])
    for t, s in enumerate(meta["tx_string"]):
        m.tx_string[t] = s
    keys = z["tx_obs_keys"].reshape(-1, 2)
    vals = z["tx_obs_vals"]
    m.tx_obs = {(int(k), int(t)): int(v) for (k, t), v in zip(keys, vals)}
    if "tx_obs_good" in z:
        for (k, t), g in zip(keys, z["tx_obs_good"]):
            m.tx_obs_good[(int(k), int(t))] = bool(g)
    if "tx_feat_good" in z:
        for i, (k, t) in enumerate(keys):
            m.tx_feat_good[(int(k), int(t))] = z["tx_feat_good"][i].copy()
    else:
        for (k, t) in m.tx_obs:
            m.tx_feat_good[(k, t)] = m.tx_feat_valid[t].copy()

    for i, km in enumerate(meta["keyframes"]):
        dets = [
            TextDetection(quad=np.zeros((4, 2), np.float32), text=d["text"],
                          score=d["score"], lang=d["lang"])
            for d in km["det_text"]
        ]

        def opt(name):
            return z[name].copy() if name in z else None

        kf = Keyframe(
            kid=km["kid"], frame_id=km["frame_id"], timestamp=km["timestamp"],
            kp_uv=z[f"kf{i}_kp_uv"].copy(),
            kp_level=z[f"kf{i}_kp_level"].copy(),
            kp_angle=z[f"kf{i}_kp_angle"].copy(),
            kp_desc=z[f"kf{i}_kp_desc"].copy(),
            kp_valid=z[f"kf{i}_kp_valid"].copy(),
            kp_point=z[f"kf{i}_kp_point"].copy(),
            obs_good=z[f"kf{i}_obs_good"].copy(),
            pyr_data=opt(f"kf{i}_pyr_data"),
            pyr_shapes=opt(f"kf{i}_pyr_shapes"),
            det_quads=opt(f"kf{i}_det_quads"),
            det_text=dets,
            det_object=opt(f"kf{i}_det_object"),
        )
        if kf.det_quads is not None:
            for d, det in enumerate(dets):
                det.quad = kf.det_quads[d]
        kf.loop_edges = list(km["loop_edges"])
        m.keyframes.append(kf)

    if "pt_n_obs" not in z:
        # legacy checkpoint: recompute per-point observing-KF counts from the
        # restored keyframe observation registries — a zeroed pt_n_obs would
        # silently disable the KF-policy c2 condition. Count REGISTERED
        # observations (kp_point set), not just good ones: the live counter
        # increments at registration and never decrements when BA gating
        # later flags an observation bad
        for kf in m.keyframes:
            pids = kf.kp_point[kf.kp_point >= 0]
            np.add.at(m.pt_n_obs, np.unique(pids), 1)
    # derived indexes (never serialized): per-point observation registry and
    # the per-KF/per-object text observation indexes
    m.rebuild_text_obs_index()
    for kf in m.keyframes:
        sel = np.nonzero(kf.kp_point >= 0)[0]
        for i in sel:
            m.pt_obs.setdefault(int(kf.kp_point[i]), {})[kf.kid] = int(i)
    if "pt_desc_latest" not in z:
        m.pt_desc_latest[: m.n_points] = m.pt_desc[: m.n_points]
        m.pt_desc_second[: m.n_points] = m.pt_desc[: m.n_points]
    if "tx_num_obvs" not in z:
        # legacy checkpoint: backfill the frame-cadence maturation counter so
        # in-flight IMMATURE objects don't restart their min_obs_promote wait
        # after resume; the good-observation counter is the best proxy, and
        # objects already GOOD get the promotion threshold outright
        n = m.n_texts
        m.tx_num_obvs[:n] = m.tx_good_obs[:n]
        promoted = m.tx_state[:n] == TEXT_GOOD
        m.tx_num_obvs[:n][promoted] = np.maximum(
            m.tx_num_obvs[:n][promoted], cfg.text.min_obs_promote)
    # device pyramid residency for the BA-window KFs (pyr_dev is never
    # serialized; leaving it None would upload each pyramid again on every
    # post-resume BA build)
    keep = cfg.solver.ba_window + 8
    for kf in m.keyframes[-keep:]:
        if kf.pyr_data is not None:
            kf.pyr_dev = torch.as_tensor(kf.pyr_data, dtype=torch.float32, device=dev)

    if tracker is not None and "tracker" in meta:
        tm = meta["tracker"]
        tracker.state = tm["state"]
        tracker.last_kf_frame_id = tm["last_kf_frame_id"]
        tracker.n_tracked_last_kf = tm["n_tracked_last_kf"]
        tracker.map = m
        if "trk_last_pose" in z:
            tracker.last_pose = z["trk_last_pose"].copy()
        if "trk_velocity" in z:
            tracker.velocity = z["trk_velocity"].copy()
        if "trk_traj_ts" in z:
            tracker.trajectory = [
                (float(t), p.copy()) for t, p in zip(z["trk_traj_ts"], z["trk_traj_poses"])
            ]
    if text_frontend is not None and "tf_box_uv" in z:
        text_frontend.tx_box_uv = z["tf_box_uv"].copy()
        text_frontend.tx_box_int = z["tf_box_int"].copy()
        text_frontend.tx_box_valid = z["tf_box_valid"].copy()
        text_frontend.tx_host_stats = z["tf_host_stats"].copy()
        text_frontend.map = m
        text_frontend._pool_version += 1  # invalidate the device pool cache
        text_frontend.restore_resume_state(z)
    saved_device = meta.get("generators", {}).get("device")
    owners = {"text_frontend": text_frontend, "loop_closer": loop_closer}
    for key, (owner, offset) in _GENERATORS.items():
        if owners[owner] is not None:
            _restore_generator(owners[owner]._gen, z, key, saved_device, cfg.seed + offset, path)
    return m, meta.get("extra", {})

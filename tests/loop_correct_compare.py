"""The port's loop run against the JAX package, step by step, on the maps
the port built on the card.

    python3 chip_loop_dump.py            (on a GPU: writes tmp/loop_dump.pkl.gz)
    JAX_PLATFORMS=cpu python tests/loop_correct_compare.py [DUMP] [--write-record]
    JAX_PLATFORMS=cpu python tests/loop_correct_compare.py [DUMP] --write-test-map STEP

Loads the steps chip_loop_dump.py recorded in chip_smoke.py's phase 7 (the
640x480 outback loop run: from the loop correction on, every step that can
move a text plane), rebuilds the keyframe pyramids from the rendered frames
on the CPU, and for each step puts the map it started from into a JAX
SlamMap and a port SlamMap (device "cpu") and replays it in both packages:
LoopCloser.correct with the card's measured Sim3 and fusion pairs, a
Tracker._local_ba with the card's window, or landmark_theta_pass. Prints
every GOOD text object's plane normal against ground truth (cos) before the
step, after it on the card, after the port on the CPU and after the JAX
package. With --write-record it writes the JAX package's planes of every
replayed step, keyed by the digest of the step's input map
(chip_smoke.map_digest), to tests/loop_reference_steps.json, which
chip_smoke.py phase 7 reads. All steps take ~5 min on the CPU. With
--write-test-map it writes only the given step, reduced, to
tests/loop_card_map.pkl.gz (tests/test_torch_loop.py's full-size case).
"""

import argparse
import copy
import dataclasses
import gzip
import json
import os
import pickle
import sys
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import torch_synth  # noqa: E402
from textslam_tpu import config as jcfg  # noqa: E402
from textslam_tpu.frontend.frame import TextDetection as JTextDetection  # noqa: E402
from textslam_tpu.frontend.text import TextFrontend as JTextFrontend  # noqa: E402
from textslam_tpu.frontend.tracking import Tracker as JTracker  # noqa: E402
from textslam_tpu.loop import closing as jclosing  # noqa: E402
from textslam_tpu.mapper import state as jstate  # noqa: E402
from textslam_tpu_torch import config as tcfg  # noqa: E402
from textslam_tpu_torch.frontend.text import TextFrontend as TTextFrontend  # noqa: E402
from textslam_tpu_torch.frontend.tracking import Tracker as TTracker  # noqa: E402
from textslam_tpu_torch.loop import closing as tclosing  # noqa: E402
from textslam_tpu_torch.mapper import state as tstate  # noqa: E402
from textslam_tpu_torch.ops import pyramid  # noqa: E402


def configs():
    """(JAX, port) configurations of chip_smoke.py's loop run."""
    out = []
    for mod in (jcfg, tcfg):
        cam = mod.CameraConfig(fx=torch_synth.FX, fy=torch_synth.FY, cx=torch_synth.CX,
                               cy=torch_synth.CY, width=torch_synth.W, height=torch_synth.H,
                               fps=chip_smoke.LOOP_FPS)
        out.append(dataclasses.replace(mod.TextSLAMConfig(), camera=cam,
                                       loop=mod.LoopConfig(**chip_smoke.LOOP_GATES)))
    return out


def world_and_path():
    """The loop run's text world (seed 0) and its ground-truth Tcw per frame."""
    return (torch_synth.TextWorld(seed=0),
            torch_synth.camera_path(chip_smoke.N_LOOP_FRAMES, "outback"))


def pyramids(state, levels):
    """Each keyframe's packed pyramid, built from its rendered frame (the
    keyframe's timestamp is the frame's index)."""
    world, gt = world_and_path()
    out = []
    for kf in state["keyframes"]:
        img = torch.tensor(world.render(gt[int(kf["timestamp"])]), dtype=torch.float32)
        imgs, grads = pyramid.build_pyramid(img, levels=levels)
        out.append(pyramid.pack_pyramid(imgs, grads)["data"].numpy())
    return out


def test_map(step) -> dict:
    """A recorded step reduced to what a BA replay reads: descriptors zeroed
    and detection records dropped (their quads stay), so the pickle holds
    only numpy arrays and builtins."""
    state = copy.deepcopy(step["map"])
    for name in ("pt_desc", "pt_desc_latest", "pt_desc_second"):
        state[name][...] = 0
    for kf in state["keyframes"]:
        kf["kp_desc"] = np.zeros_like(kf["kp_desc"])
        kf["det_text"] = None
    return {"name": step["name"], "args": step["args"], "map": state,
            "after": {k: step["after"][k] for k in ("tx_theta", "tx_valid", "tx_state")}}


def jax_map(state, cfg, pyrs):
    m = jstate.SlamMap(cfg)
    for name in tstate._MAP_ARRAYS:
        getattr(m, name)[...] = state[name]
    m.n_points, m.n_texts = int(state["n_points"]), int(state["n_texts"])
    m.tx_string = list(state["tx_string"])
    for name in ("pt_obs", "tx_obs", "tx_obs_by_kid", "tx_obs_by_tid", "tx_obs_good",
                 "tx_feat_good"):
        setattr(m, name, copy.deepcopy(state[name]))
    m.saturation_drops.update(state["saturation_drops"])
    for kf, pyr in zip(state["keyframes"], pyrs):
        rec = copy.deepcopy(kf)
        if rec["det_text"] is not None:
            rec["det_text"] = [JTextDetection(quad=np.asarray(d.quad, np.float32), text=d.text,
                                              score=float(d.score), lang=int(d.lang))
                               for d in rec["det_text"]]
        m.keyframes.append(jstate.Keyframe(**rec, pyr_data=pyr, pyr_dev=jnp.asarray(pyr)))
    return m


def port_map(state, cfg, pyrs):
    fields = dict(state, keyframes=[dict(copy.deepcopy(kf), pyr_data=p, pyr_dev=p)
                                    for kf, p in zip(state["keyframes"], pyrs)])
    return tstate.slam_map_from_numpy(fields, cfg, device="cpu")


def systems(state, pyrs):
    """(JAX side, port side), each (map, tracker, closer)."""
    jc, tc = configs()
    jm, tm = jax_map(state, jc, pyrs), port_map(state, tc, pyrs)
    jtr = JTracker(jc, jm)
    jtr.text_frontend = JTextFrontend(jc, jm, jtr)
    ttr = TTracker(tc, tm, device="cpu")
    ttr.text_frontend = TTextFrontend(tc, tm, ttr, device="cpu")
    jlc, tlc = jclosing.LoopCloser(jc, jm), tclosing.LoopCloser(tc, tm, device="cpu")
    jlc.tracker, tlc.tracker = jtr, ttr
    return (jm, jtr, jlc), (tm, ttr, tlc)


def planes(m, gt, world):
    """{tid: (string, KF observations, box px, cos, bar)} of the GOOD objects."""
    cosines = chip_smoke.text_planes(types.SimpleNamespace(map=m), gt, world)[1]
    return {c["tid"]: (c["string"], c["kf_obs"], c["box_px"], c["cos"], c["bar"])
            for c in cosines}


def replay(step, side):
    """Run a recorded step on one side's (map, tracker, closer)."""
    m, tr, lc = side
    args, kw = copy.deepcopy(step["args"])
    if step["name"] == "correct":
        lc.correct(*args, **kw)
    elif step["name"] == "local_ba":
        tr._local_ba(*args, **kw)
    else:
        tr.text_frontend.landmark_theta_pass()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dump", nargs="?", default=os.path.join(ROOT, "tmp",
                                                            "loop_dump.pkl.gz"))
    ap.add_argument("--write-test-map", type=int, metavar="STEP",
                    help="write that step, reduced, to tests/loop_card_map.pkl.gz and stop")
    ap.add_argument("--write-record", action="store_true",
                    help=f"write every replayed step's JAX planes to {chip_smoke.LOOP_REFERENCE}")
    args = ap.parse_args()
    torch.set_num_threads(4)
    with gzip.open(args.dump, "rb") as f:
        steps = pickle.load(f)["steps"]
    world, gt = world_and_path()
    levels = max(configs()[1].pyramid.init_ba_levels) + 1
    if args.write_test_map is not None:
        path = os.path.join(HERE, "loop_card_map.pkl.gz")
        with gzip.open(path, "wb", compresslevel=9) as f:
            pickle.dump(test_map(steps[args.write_test_map]), f)
        print(f"wrote {os.path.relpath(path, ROOT)} ({os.path.getsize(path) / 2**20:.2f} MiB)")
        return
    record = []
    for n, step in enumerate(steps):
        state = step["map"]
        jax_side, port_side = systems(state, pyramids(state, levels))
        tm, jm = port_side[0], jax_side[0]
        before = planes(tm, gt, world)
        on_card = copy.copy(tm)
        for k, v in step["after"].items():
            setattr(on_card, k, v)
        times = {}
        for name, side in (("jax", jax_side), ("port", port_side)):
            t0 = time.perf_counter()
            replay(step, side)
            times[name] = time.perf_counter() - t0
        after = {"card": planes(on_card, gt, world), "port": planes(tm, gt, world),
                 "jax": planes(jm, gt, world)}
        kw = step["args"][1]
        print(f"step {n} {step['name']} {kw or ''} (port on the CPU {times['port']:.1f} s, JAX on "
              f"the CPU {times['jax']:.1f} s): GOOD objects, cos of the plane normal to ground "
              f"truth")
        print(f"  {'tid':>4} {'string':>8} {'obs':>4} {'box px':>7} {'before':>8} "
              f"{'card':>8} {'port':>8} {'jax':>8}")
        for tid in sorted(set(before) | set(after["jax"]) | set(after["port"])):
            row = [after[k].get(tid) for k in ("card", "port", "jax")]
            ref = before.get(tid) or next(r for r in row if r)
            cells = [f"{r[3]:8.5f}" if r else f"{'-':>8}" for r in [before.get(tid)] + row]
            print(f"  {tid:>4} {ref[0]:>8} {ref[1]:>4} {ref[2]:7.1f} " + " ".join(cells))
        n_t = tm.n_texts
        dth = (np.abs(tm.tx_theta[:n_t] - jm.tx_theta[:n_t]).max(-1)
               / (np.abs(jm.tx_theta[:n_t]).max(-1) + 1e-12))
        print(f"  theta port vs JAX, largest relative difference per object: "
              f"{np.round(dth, 5).tolist()}", flush=True)
        record.append({
            "name": step["name"], "args": repr(kw or step["args"][0]),
            "digest": chip_smoke.map_digest(state),
            "objects": {str(t): {"string": j[0], "kf_obs": j[1], "bar": j[4],
                                 "before": before[t][3] if t in before else None,
                                 "card": after["card"][t][3] if t in after["card"] else None,
                                 "port_cpu": after["port"][t][3] if t in after["port"] else None,
                                 "jax": j[3]}
                        for t, j in sorted(after["jax"].items())}})
    if args.write_record:
        path = os.path.join(ROOT, chip_smoke.LOOP_REFERENCE)
        with open(path, "w") as f:
            json.dump({"written_by": "tests/loop_correct_compare.py --write-record",
                       "from": "chip_loop_dump.py on the card (chip_smoke.py phase 7's run)",
                       "steps": record}, f, indent=1)
        print(f"wrote {os.path.relpath(path, ROOT)} ({len(record)} steps)")


if __name__ == "__main__":
    main()

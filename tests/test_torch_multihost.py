"""The port's sharded BA across processes: two OS processes, each with two
local CPU shards, joined by a gloo process group into one 4-shard mesh
(tests/torch_multihost_worker.py), as tests/test_multihost.py runs the JAX
package's global mesh.

1. ONE sharded assembly, whose Mesh.all_sum crosses the process boundary,
   is held tightly against the same 4-shard assembly in one process
   (rtol 1e-5: the two differ only in how the four partial sums pair up)
   and against the single-device assembly to tests/test_multihost.py's
   tolerances.
2. The full sharded LM is held by final cost against the single-device
   solve_ba (an accept/reject schedule could flip on reduction-order ulps;
   equal-quality minima are the invariant), with test_multihost.py's
   tolerances.
3. Batched ORB extraction gathered across the processes equals the
   per-frame extraction.

Each worker gets its own timeout, and the rendezvous port and the process
group's timeout go through the environment; nothing sleeps.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from test_solver_ba import make_ba_problem
from textslam_tpu_torch.ops import orb
from textslam_tpu_torch.parallel import ba_sharded
from textslam_tpu_torch.parallel.mesh import Mesh
from textslam_tpu_torch.solver import ba

import torch_synth

torch.set_num_threads(2)

_HERE = os.path.dirname(os.path.abspath(__file__))
WORKER_TIMEOUT_S = 600  # per process; a run takes ~10 s unloaded


def _to_numpy(x):
    if x is None or isinstance(x, (int, float)):
        return x
    if hasattr(x, "_asdict"):
        return {k: _to_numpy(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _frames():
    K = torch_synth.K.copy()
    K[:2] /= 4
    frames, _ = torch_synth.render_sequence(3, K_mat=K, size=(160, 120))
    return np.stack(frames).astype(np.float32)


def _run_workers(tmp_path, arrays, frames, world=2):
    inp = str(tmp_path / "problem.pkl")
    with open(inp, "wb") as f:
        pickle.dump({"problem": arrays, "frames": frames}, f)
    out = str(tmp_path / "result.npz")
    worker = os.path.join(_HERE, "torch_multihost_worker.py")
    for attempt in range(2):  # a second port if another process took the first
        env = dict(os.environ, TEXTSLAM_MH_PORT=str(_free_port()),
                   TEXTSLAM_MH_TIMEOUT=str(WORKER_TIMEOUT_S))
        procs = [subprocess.Popen([sys.executable, worker, str(r), str(world), inp, out],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            pytest.fail(f"a worker outlived its {WORKER_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(p.returncode == 0 for p in procs):
            break
        if attempt == 0 and any("Address already in use" in log for log in logs):
            continue
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"worker {r} failed (rc={p.returncode}):\n{log[-4000:]}"
    assert os.path.exists(out), f"no result written:\n{logs[0][-4000:]}"
    return dict(np.load(out))


def _assembly(problem, mesh):
    """The worker's one assembly, on `mesh` (None: one device)."""
    if mesh is None:
        ts = ba.scene_terms(problem, 2.447)
        K, P = problem.poses.shape[0], problem.rho.shape[0]
        Hcc, bc = ba.assemble_camera_system(ts, problem.scene.tgt, problem.scene.host, K)
        _, Hll, bl = ba.assemble_landmark_system(ts, problem.scene.tgt, problem.scene.host,
                                                 problem.scene.point, P, K, 1)
        cost = ts["cost"].sum()
        if problem.text is not None:
            tt = ba.text_terms(problem, 3.0)
            H2, b2 = ba.assemble_camera_system(tt, problem.text.tgt, problem.text.host, K)
            Hcc, bc, cost = Hcc + H2, bc + b2, cost + tt["cost"].sum()
    else:
        Hcc, bc, _, Hll, bl, cost = ba_sharded.sharded_scene_normal_eqs(problem, mesh, 2.447)
        if problem.text is not None:
            H2, b2, _, _, _, c2 = ba_sharded.sharded_text_normal_eqs(problem, mesh, 3.0)
            Hcc, bc, cost = Hcc + H2, bc + b2, cost + c2
    return dict(Hcc=Hcc.numpy(), bc=bc.numpy(), Hll_d=Hll[:, 0, 0].numpy(),
                bl_d=bl[:, 0].numpy(), cost0=float(cost))


def _hold(z, arrays, frames):
    problem = ba.ba_problem_from_numpy(arrays, device="cpu")
    # (1) tight: the same 4 shards in one process; then one device
    same = _assembly(problem, Mesh(["cpu"] * 4))
    for k in ("Hcc", "bc", "Hll_d", "bl_d"):
        scale = max(1.0, float(np.abs(same[k]).max()))
        np.testing.assert_allclose(z[k], same[k], rtol=1e-5, atol=1e-6 * scale, err_msg=k)
    assert abs(float(z["cost0"]) - same["cost0"]) <= 1e-5 * max(1.0, same["cost0"])
    one = _assembly(problem, None)
    scale = max(1.0, float(np.abs(one["Hcc"]).max()))
    np.testing.assert_allclose(z["Hcc"], one["Hcc"], atol=1e-4 * scale)
    np.testing.assert_allclose(z["bc"], one["bc"], atol=1e-4 * max(1.0, np.abs(one["bc"]).max()))
    np.testing.assert_allclose(z["Hll_d"], one["Hll_d"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(z["bl_d"], one["bl_d"], rtol=1e-4, atol=1e-5)
    cost0 = one["cost0"]
    assert abs(float(z["cost0"]) - cost0) <= 1e-4 * max(1.0, cost0)

    # (2) path-insensitive: the full LM reaches an equal-quality minimum
    st = ba.solve_ba(problem, n_iters=6)
    c_single, c_multi = float(st.cost), float(z["cost"])
    assert np.isfinite(c_multi)
    assert c_multi <= cost0 * (1 + 1e-5) + 1e-3, f"LM worsened the cost: {c_multi} vs {cost0}"
    assert abs(c_multi - c_single) <= 5e-3 * max(1.0, c_single), (c_multi, c_single)
    np.testing.assert_allclose(z["poses"], st.poses.numpy(), atol=0.05)
    if "theta" in z:
        np.testing.assert_allclose(z["theta"], st.theta.numpy(), atol=0.05)

    # (3) the gathered batch equals the per-frame extraction
    for i, img in enumerate(frames):
        kp = orb.extract_orb(torch.as_tensor(img), n_features=200, n_levels=2)
        np.testing.assert_array_equal(z["kp_uv"][i], kp.uv.numpy())
        np.testing.assert_array_equal(z["kp_desc"][i], kp.desc.numpy())
        np.testing.assert_array_equal(z["kp_valid"][i], kp.valid.numpy())


class TestMultiProcessCollectives:
    def test_two_process_scene_solve(self, tmp_path):
        jp, _, _ = make_ba_problem()
        arrays, frames = _to_numpy(jp), _frames()
        _hold(_run_workers(tmp_path, arrays, frames), arrays, frames)

    def test_two_process_joint_text_solve(self, tmp_path):
        """The same with text rows live: the 3x3 theta blocks and the text
        rows' camera system cross the process boundary too."""
        jp = graft._synthetic_problem(n_kf=4, n_pts=128, obs_per_kf=64, n_text=4, text_feat=8,
                                      img_hw=(96, 128), with_text=True, seed=5)
        arrays, frames = _to_numpy(jp), _frames()
        _hold(_run_workers(tmp_path, arrays, frames), arrays, frames)

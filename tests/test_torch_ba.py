"""Port scene-family bundle adjustment held against the JAX solver.

The problem is __graft_entry__._synthetic_problem without text (4 KFs,
96 points, 128 observations per KF: every point seen ~5 times, so LM
converges; sparser draws leave single-view points whose depth steps go
negative and both solvers reject every step), converted with
ba_problem_from_numpy so both solvers see identical float32 inputs.

Tolerances and why:
- residuals / Jacobians / chi2: 1e-5 of the largest entry (same float32
  formulas; XLA may fuse multiply-adds differently, and rows whose exact
  value is 0 — a point seen from its own host — carry cancellation noise);
- one assembly (Hcc, bc) and the point blocks: rtol 1e-4 relative to the
  largest entry — 64..256-term float32 sums reduced in another order;
- a whole solve: final cost rtol 1e-3 and poses atol 1e-4 — accept/reject
  could in principle flip on a near-tie of costs, after which the paths
  diverge legitimately; on this problem they do not;
- pose optimization (2 chi2 rounds): pose atol 1e-4, inlier masks equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from textslam_tpu.solver import ba as jba
from textslam_tpu.frontend import tracking as jtr
from textslam_tpu_torch.solver import ba as tba
from textslam_tpu_torch.frontend import tracking as ttr

torch.set_num_threads(2)


def _to_numpy(x):
    if x is None:
        return None
    if hasattr(x, "_asdict"):
        return {k: _to_numpy(v) for k, v in x._asdict().items()}
    return np.asarray(x)


@pytest.fixture(scope="module")
def problems():
    jp = graft._synthetic_problem(n_kf=4, n_pts=96, obs_per_kf=128, with_text=False)
    jp = jp._replace(theta=jp.theta[:1], theta_free=jp.theta_free[:1])
    # perturb the free poses and depths so that LM has work to do
    rng = np.random.default_rng(0)
    poses = np.asarray(jp.poses).copy()
    poses[1:, 4:] += rng.normal(0, 0.01, (3, 3)).astype(np.float32)
    rho = np.asarray(jp.rho) * rng.uniform(0.95, 1.05, jp.rho.shape).astype(np.float32)
    jp = jp._replace(poses=jnp.asarray(poses), rho=jnp.asarray(rho))
    return jp, tba.ba_problem_from_numpy(_to_numpy(jp), device="cpu")


def _rel_close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-12)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def test_conversion_dtypes(problems):
    _, tp = problems
    assert tp.poses.dtype == torch.float32 and tp.scene.ray.dtype == torch.float32
    assert tp.scene.tgt.dtype == torch.int64 and tp.scene.valid.dtype == torch.bool


@pytest.mark.parametrize("key", ["r", "J_t", "J_h", "J_l", "w", "cost", "chi2"])
def test_scene_terms(problems, key):
    jp, tp = problems
    with jax.default_matmul_precision("highest"):
        want = jba.scene_terms(jp, 2.447)[key]
    got = tba.scene_terms(tp, 2.447)[key]
    _rel_close(got.numpy(), want, 1e-5)


def test_scene_cost(problems):
    jp, tp = problems
    np.testing.assert_allclose(tba.scene_cost(tp, 2.447).item(),
                               float(jba.scene_cost(jp, 2.447)), rtol=1e-5)


def test_camera_and_landmark_assembly(problems):
    jp, tp = problems
    K, P = jp.poses.shape[0], jp.rho.shape[0]
    with jax.default_matmul_precision("highest"):
        ts_j = jba.scene_terms(jp, 2.447)
        Hj, bj = jba.assemble_camera_system(ts_j, jp.scene.tgt, jp.scene.host, K)
        Wj, Hlj, blj = jba.assemble_landmark_system(
            ts_j, jp.scene.tgt, jp.scene.host, jp.scene.point, P, K, 1)
    ts_t = tba.scene_terms(tp, 2.447)
    Ht, bt = tba.assemble_camera_system(ts_t, tp.scene.tgt, tp.scene.host, K)
    Wt, Hlt, blt = tba.assemble_landmark_system(
        ts_t, tp.scene.tgt, tp.scene.host, tp.scene.point, P, K, 1)
    _rel_close(Ht.numpy(), Hj, 1e-4)
    _rel_close(bt.numpy(), bj, 1e-4)
    _rel_close(Wt.numpy(), Wj, 1e-4)
    _rel_close(Hlt.numpy(), Hlj, 1e-4)
    _rel_close(blt.numpy(), blj, 1e-4)


def test_solve_ba(problems):
    jp, tp = problems
    sj = jba.solve_ba(jp, n_iters=8, huber_scene=2.447)
    st = tba.solve_ba(tp, n_iters=8, huber_scene=2.447)
    c0 = tba.scene_terms(tp, 2.447)["cost"].sum().item()
    assert float(sj.cost) < 0.5 * c0  # the solve really moved
    np.testing.assert_allclose(st.cost.item(), float(sj.cost), rtol=1e-3)
    np.testing.assert_allclose(st.poses.numpy(), np.asarray(sj.poses), atol=1e-4)
    np.testing.assert_allclose(st.rho.numpy(), np.asarray(sj.rho), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(st.lam.item(), float(sj.lam), rtol=1e-5)


def test_cholesky_failure_rejects_trial(problems):
    """A negative damping makes every reduced system indefinite: JAX's
    Cholesky returns NaN, the port's cholesky_ex is turned into NaN, and in
    both the non-finite trial is rejected, so the solve keeps the initial
    parameters and cost."""
    jp, tp = problems
    kw = dict(n_iters=3, huber_scene=2.447, lam0=-50.0, lam_min=-10.0)
    sj = jba.solve_ba(jp, **kw)
    st = tba.solve_ba(tp, **kw)
    c0 = tba.scene_terms(tp, 2.447)["cost"].sum().item()
    np.testing.assert_array_equal(np.asarray(sj.poses), np.asarray(jp.poses))
    np.testing.assert_array_equal(st.poses.numpy(), tp.poses.numpy())
    np.testing.assert_array_equal(st.rho.numpy(), tp.rho.numpy())
    np.testing.assert_allclose(st.cost.item(), c0, rtol=1e-6)
    np.testing.assert_allclose(st.cost.item(), float(sj.cost), rtol=1e-5)
    np.testing.assert_allclose(st.lam.item(), float(sj.lam))


def _pose_problem(rng, n=300, outliers=30):
    """One free pose observing n points hosted in a frozen KF, some
    observations corrupted, in the layout fused_track_step builds."""
    fx = fy = 420.0
    cx, cy = 320.0, 240.0
    uvh = np.stack([rng.uniform(40, 600, n), rng.uniform(40, 440, n)], -1)
    ray = np.concatenate([(uvh - [cx, cy]) / [fx, fy], np.ones((n, 1))], -1).astype(np.float32)
    rho = (1.0 / rng.uniform(2, 6, n)).astype(np.float32)
    host = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    true = np.array([1, 0, 0, 0, -0.1, 0.02, 0.01], np.float32)
    p_c = ray / rho[:, None] + true[4:]
    uv = np.stack([fx * p_c[:, 0] / p_c[:, 2] + cx, fy * p_c[:, 1] / p_c[:, 2] + cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    uv[:outliers] += rng.uniform(15, 40, (outliers, 2))
    guess = true.copy()
    guess[4:] += [0.01, -0.005, 0.004]
    arrays = dict(
        poses=guess[None], pose_free=np.ones(1, bool), rho=rho, rho_free=np.zeros(n, bool),
        theta=np.zeros((1, 3), np.float32), theta_free=np.zeros(1, bool),
        scene=dict(tgt=np.zeros(n, np.int32), host=np.ones(n, np.int32),
                   host_frozen_pose=np.tile(host, (n, 1)), host_in_window=np.zeros(n, bool),
                   point=np.arange(n, dtype=np.int32), ray=ray, uv=uv.astype(np.float32),
                   weight=np.full(n, 1 / 1.2, np.float32), valid=rng.uniform(size=n) < 0.95),
        fx=fx, fy=fy, cx=cx, cy=cy,
    )
    return arrays


def test_fused_pose_optimize(problems):
    rng = np.random.default_rng(7)
    arrays = _pose_problem(rng)
    s = arrays["scene"]
    jp = jba.BAProblem(
        **{k: jnp.asarray(v) for k, v in arrays.items() if k not in ("scene", "fx", "fy", "cx", "cy")},
        scene=jba.SceneObs(**{k: jnp.asarray(v) for k, v in s.items()}),
        text=None, images=None, fx=arrays["fx"], fy=arrays["fy"], cx=arrays["cx"], cy=arrays["cy"])
    tp = tba.ba_problem_from_numpy(arrays, device="cpu")
    kw = dict(rounds=2, n_iters=10, huber=float(np.sqrt(5.991)), chi2_gate=16.25)
    pj, inl_j = jtr.fused_pose_optimize(jp, jnp.asarray(s["valid"]), 1 / 1.2, **kw)
    pt, inl_t = ttr.fused_pose_optimize(tp, torch.as_tensor(s["valid"]), 1 / 1.2, **kw)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert not inl_t.numpy()[:30].any()  # the corrupted observations gated out

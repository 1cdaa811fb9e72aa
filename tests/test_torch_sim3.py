"""Port Sim3 group ops and solvers (textslam_tpu_torch.geometry.sim3,
textslam_tpu_torch.solver.sim3_opt) held against the JAX package.

Inputs come from a numpy seed (or tests/test_sim3_opt.py's make_pair) and
go through both packages. Tolerances:
- group ops, exp / log, their zero-tangent Jacobians and horn_alignment:
  1e-5 absolute or 1e-4 relative (float32 on both sides);
- Sim3 RANSAC on the same injected 3-point sets (JAX's own Gumbel sets, read
  back from its key): identical inlier masks and S12 to 1e-4; the port's own
  RANSAC (torch.Generator sets) by outcome: it recovers the true Sim3 as
  test_sim3_opt requires;
- refine_sim3 on make_pair data: S12 to 1e-4, inliers exact;
- solve_pose_graph on test_sim3_opt's drifted circle: nodes to 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textslam_tpu.geometry import sim3 as jsim3
from textslam_tpu.geometry.quaternion import qexp as jqexp
from textslam_tpu.solver import sim3_opt as jopt
from textslam_tpu_torch.geometry import sim3 as tsim3
from textslam_tpu_torch.solver import sim3_opt as topt

from test_sim3_opt import CX, CY, FX, FY, make_pair

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def _close(t, j, rtol=RTOL, atol=ATOL, **kw):
    np.testing.assert_allclose(t.detach().numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), rtol=rtol, atol=atol, **kw)


def _tangents(rng, n=32):
    """sim(3) tangents with the guarded branches in the first rows: zero,
    zero rotation, zero log-scale, tiny values of each."""
    x = rng.normal(0, 0.4, (n, 7)).astype(np.float32)
    x[0] = 0.0
    x[1, :3] = 0.0
    x[2, 6] = 0.0
    x[3, :3] = 1e-7
    x[4, 6] = 3e-7
    x[5, :3], x[5, 6] = 0.0, 0.0
    return x


def _sims(rng, n=32):
    return np.array(jsim3.expm(jnp.asarray(_tangents(rng, n))))


def test_group_ops():
    rng = np.random.default_rng(0)
    A, B = _sims(rng), _sims(rng)
    p = rng.normal(size=(32, 3)).astype(np.float32)
    tA, tB = torch.tensor(A), torch.tensor(B)
    _close(tsim3.compose(tA, tB), jsim3.compose(jnp.asarray(A), jnp.asarray(B)))
    _close(tsim3.inverse(tA), jsim3.inverse(jnp.asarray(A)))
    _close(tsim3.apply(tA, torch.tensor(p)), jsim3.apply(jnp.asarray(A), jnp.asarray(p)))
    T = A[:, :7]
    _close(tsim3.from_se3(torch.tensor(T)), jsim3.from_se3(jnp.asarray(T)))
    _close(tsim3.identity((3,)), jsim3.identity((3,)))
    q, t, s = tsim3.unpack(tA)
    _close(tsim3.pack(q, t, s), A)


def test_exp_log_and_jacobians():
    rng = np.random.default_rng(1)
    x = _tangents(rng)
    _close(tsim3.expm(torch.tensor(x)), jsim3.expm(jnp.asarray(x)))
    S = _sims(rng)
    _close(tsim3.logm(torch.tensor(S)), jsim3.logm(jnp.asarray(S)))
    _close(tsim3._V_matrix(torch.tensor(x[:, :3]), torch.tensor(x[:, 6])),
           jsim3._V_matrix(jnp.asarray(x[:, :3]), jnp.asarray(x[:, 6])))
    # the solvers' Jacobians: d logm(expm(d) ∘ S) / d at d = 0, through the
    # guarded branches (the first rows of S are the guarded tangents' images)
    def jf(d, Sx):
        return jsim3.logm(jsim3.compose(jsim3.expm(d), Sx))

    def tf(d, Sx):
        return tsim3.logm(tsim3.compose(tsim3.expm(d), Sx))

    Sg = _sims(np.random.default_rng(1), 12)
    Jj = jax.jit(jax.vmap(jax.jacfwd(jf), in_axes=(None, 0)))(jnp.zeros(7), jnp.asarray(Sg))
    Jt = torch.func.vmap(torch.func.jacfwd(tf), in_dims=(None, 0))(torch.zeros(7),
                                                                   torch.tensor(Sg))
    assert Jt.dtype == torch.float32 and torch.isfinite(Jt).all()
    _close(Jt, Jj)


def test_horn_alignment():
    rng = np.random.default_rng(2)
    S = _sims(rng, 8)
    S[:, 7] = rng.uniform(0.5, 2.0, 8)
    P2 = rng.normal(size=(8, 40, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32)
    P1 = np.asarray(jsim3.apply(jnp.asarray(S)[:, None], jnp.asarray(P2)))
    P1 = (P1 + rng.normal(0, 0.01, P1.shape)).astype(np.float32)
    w = (rng.uniform(size=(8, 40)) > 0.2).astype(np.float32)
    for wt in (None, w):
        j = jsim3.horn_alignment(jnp.asarray(P1), jnp.asarray(P2),
                                 None if wt is None else jnp.asarray(wt))
        t = tsim3.horn_alignment(torch.tensor(P1), torch.tensor(P2),
                                 None if wt is None else torch.tensor(wt))
        _close(t, j)
    _close(tsim3.horn_alignment(torch.tensor(P1), torch.tensor(P2), fix_scale=True),
           jsim3.horn_alignment(jnp.asarray(P1), jnp.asarray(P2), fix_scale=True))


def _jax_sets(key, valid, n_sets=200):
    """The 3-point sets jopt.sim3_ransac draws from `key`."""
    g = jax.random.gumbel(key, (n_sets, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    return np.asarray(jax.lax.top_k(g, 3)[1])


@pytest.mark.parametrize("outliers,n_valid", [(0, 60), (15, 60), (15, 50)])
def test_ransac_on_injected_sets(outliers, n_valid):
    S, P1, P2, uv1, uv2 = make_pair(outliers=outliers)
    valid = np.zeros(64, bool)
    valid[:n_valid] = True
    pad = [np.pad(np.asarray(a), ((0, 4), (0, 0))) for a in (P1, P2, uv1, uv2)]
    key = jax.random.PRNGKey(outliers + n_valid)
    Sj, inl_j, n_j = jopt.sim3_ransac(key, *(jnp.asarray(a) for a in pad), jnp.asarray(valid),
                                      FX, FY, CX, CY)
    sets = torch.tensor(_jax_sets(key, valid))
    St, inl_t, n_t = topt.sim3_ransac_sets(sets, *(torch.tensor(a) for a in pad),
                                           torch.tensor(valid), FX, FY, CX, CY)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) >= n_valid - outliers - 2
    _close(St, Sj)


def test_own_ransac_recovers_sim3():
    """The port's RANSAC with its own generator: test_sim3_opt's bars."""
    gen = torch.Generator().manual_seed(2)
    S, P1, P2, uv1, uv2 = make_pair()
    args = [torch.tensor(np.asarray(a)) for a in (P1, P2, uv1, uv2)]
    valid = torch.ones(60, dtype=torch.bool)
    S_est, inl, n = topt.sim3_ransac_sets(topt.ransac_sets(gen, valid), *args, valid,
                                          FX, FY, CX, CY)
    assert int(n) >= 55
    np.testing.assert_allclose(float(S_est[7]), S[7], rtol=1e-3)
    assert abs(abs(float((S_est[:4] * torch.tensor(S[:4])).sum())) - 1) < 1e-4
    S, P1, P2, uv1, uv2 = make_pair(outliers=15)
    args = [torch.tensor(np.asarray(a)) for a in (P1, P2, uv1, uv2)]
    S_est, inl, n = topt.sim3_ransac_sets(topt.ransac_sets(gen, valid), *args, valid,
                                          FX, FY, CX, CY)
    assert int(n) >= 40
    assert int(inl[:15].sum()) <= 2
    np.testing.assert_allclose(float(S_est[7]), S[7], rtol=0.02)


def test_refine_sim3():
    S, P1, P2, uv1, uv2 = make_pair(noise=0.002, outliers=5)
    pert = np.asarray(jsim3.compose(jsim3.expm(jnp.asarray(
        [0.02, -0.01, 0.03, 0.05, -0.02, 0.04, 0.05])), jnp.asarray(S)), np.float32)
    valid = np.ones(60, bool)
    Sj, inl_j = jopt.refine_sim3(jnp.asarray(pert), P1, P2, uv1, uv2, jnp.asarray(valid),
                                 FX, FY, CX, CY)
    St, inl_t = topt.refine_sim3(torch.tensor(pert), *(torch.tensor(np.asarray(a))
                                                       for a in (P1, P2, uv1, uv2)),
                                 torch.tensor(valid), FX, FY, CX, CY)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(inl_t.sum()) >= 50
    _close(St, Sj)


def test_pose_graph_loop():
    """test_sim3_opt's drifted circle with one loop edge, both packages."""
    rng = np.random.default_rng(7)
    N = 12
    gts = []
    for i in range(N):
        ang = 2 * np.pi * i / N
        q = np.asarray(jqexp(jnp.asarray([0.0, 0.0, ang])))
        T = np.concatenate([q, [np.cos(ang), np.sin(ang), 0.0]]).astype(np.float32)
        gts.append(np.asarray(jsim3.from_se3(jnp.asarray(T))))
    gts = np.stack(gts)
    nodes = [gts[0]]
    for i in range(1, N):
        S_ba = jsim3.compose(jnp.asarray(gts[i]), jsim3.inverse(jnp.asarray(gts[i - 1])))
        noise = jsim3.expm(jnp.asarray(np.r_[rng.normal(0, 0.02, 6), 0.01].astype(np.float32)))
        nodes.append(np.asarray(jsim3.compose(S_ba, jsim3.compose(noise, jnp.asarray(nodes[-1])))))
    nodes = np.stack(nodes).astype(np.float32)
    a = np.r_[np.arange(N - 1), N - 1]
    b = np.r_[np.arange(1, N), 0]
    meas = np.asarray(jsim3.compose(jnp.asarray(gts[b]), jsim3.inverse(jnp.asarray(gts[a]))))
    fixed = np.zeros(N, bool)
    fixed[0] = True
    E = len(a)
    jg = jopt.PoseGraph(nodes=jnp.asarray(nodes), fixed=jnp.asarray(fixed),
                        edge_a=jnp.asarray(a, jnp.int32), edge_b=jnp.asarray(b, jnp.int32),
                        edge_meas=jnp.asarray(meas), edge_valid=jnp.ones(E, bool),
                        edge_weight=jnp.ones(E))
    tg = topt.PoseGraph(nodes=torch.tensor(nodes), fixed=torch.tensor(fixed),
                        edge_a=torch.tensor(a), edge_b=torch.tensor(b),
                        edge_meas=torch.tensor(meas), edge_valid=torch.ones(E, dtype=torch.bool),
                        edge_weight=torch.ones(E))
    out_j, cost_j = jopt.solve_pose_graph(jg, n_iters=25)
    out_t, cost_t = topt.solve_pose_graph(tg, n_iters=25)
    _close(out_t, out_j)
    err = np.linalg.norm(out_t.numpy()[:, 4:7] - gts[:, 4:7], axis=-1).max()
    assert err < 0.05
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3, atol=1e-6)

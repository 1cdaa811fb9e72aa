"""Port text-family bundle adjustment held against the JAX solver.

The problem is __graft_entry__._synthetic_problem(n_kf=4, n_pts=256,
obs_per_kf=64, n_text=4, text_feat=8, img_hw=(96, 128)): scene rows plus 8
features x 8 samples per (text object, target KF) pair. Its random-noise
images give LM nothing to descend (JAX rejects every step), so the stacks
are replaced by a smooth pattern with exact Sobel channels, and the
reference intensities are the pattern's samples at the unperturbed state;
rows whose samples are not all well inside the image there are invalid. Then poses, depths and
planes are perturbed. ba_problem_from_numpy gives
both solvers identical float32 inputs. The JAX package samples through
per-feature 8x8 patches on the CPU; the port takes the grouped region
contract on every device (its plain version here). The 96x128 level fits
one region, so the two masks agree: text_region_coverage reports zero
dropped samples, and every comparison below is like for like.

Tolerances and why:
- residuals, Jacobians, weights, costs: rtol 1e-4 of the largest entry
  (the same float32 formulas; sampled values differ in the last bits
  because the port lerps corners and JAX contracts one-hot patch weights);
- one joint assembly (Hcc, bc, the theta blocks): rtol 1e-4 of the largest
  entry, sums of hundreds of float32 terms in another order;
- a whole solve: final cost rtol 1e-3, poses atol 1e-4, thetas rtol 1e-3
  (accept/reject could flip on a near-tie, after which the paths diverge
  legitimately; on this problem they do not);
- inv3x3_spd: rtol 1e-5 on well-conditioned blocks, exact zeros on singular
  ones.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from textslam_tpu.solver import ba as jba
from textslam_tpu_torch.solver import ba as tba

torch.set_num_threads(2)

F = 8


def _to_numpy(x):
    if x is None:
        return None
    if hasattr(x, "_asdict"):
        return {k: _to_numpy(v) for k, v in x._asdict().items()}
    return x if isinstance(x, int) else np.asarray(x)


def _rel_close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-12)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def problems():
    jp = graft._synthetic_problem(n_kf=4, n_pts=256, obs_per_kf=64, n_text=4, text_feat=F,
                                  img_hw=(96, 128))
    K, H, W, _ = jp.images.shape
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    a, b = 0.21, 0.17
    img = np.stack([128 + 50 * np.sin(a * x) * np.cos(b * y),
                    8 * 50 * a * np.cos(a * x) * np.cos(b * y),  # 8 x dI/dx, as Sobel
                    -8 * 50 * b * np.sin(a * x) * np.sin(b * y)], -1)
    jp = jp._replace(images=jnp.asarray(np.broadcast_to(img, (K, H, W, 3)).astype(np.float32)))
    unit = jp._replace(text=jp.text._replace(ref_inten=jnp.zeros_like(jp.text.ref_inten),
                                             weight=jnp.ones_like(jp.text.weight)))
    tt = jba.text_terms(unit, 1e9, pair_feat=0)
    # (I - mu) / sigma where sampled. Rows whose samples do not all lie 3 px
    # inside the image at the unperturbed state are left out: a small step
    # could move them across the border, where a constant penalty flips
    uv = tba._text_projection(tba.ba_problem_from_numpy(_to_numpy(unit), device="cpu"))[6]
    inside = ((uv[..., 0] >= 3) & (uv[..., 0] <= W - 4) & (uv[..., 1] >= 3)
              & (uv[..., 1] <= H - 4)).all(-1).numpy()
    jp = jp._replace(text=jp.text._replace(ref_inten=tt["r"],
                                           valid=jnp.asarray(inside) & (tt["w"] > 0)))
    # perturb the free poses, depths and planes so that LM has work to do
    rng = np.random.default_rng(1)
    poses = np.asarray(jp.poses).copy()
    poses[1:, 4:] += rng.normal(0, 0.005, (3, 3)).astype(np.float32)
    rho = np.asarray(jp.rho) * rng.uniform(0.97, 1.03, jp.rho.shape).astype(np.float32)
    theta = np.asarray(jp.theta) * rng.uniform(0.97, 1.03, jp.theta.shape).astype(np.float32)
    jp = jp._replace(poses=jnp.asarray(poses), rho=jnp.asarray(rho), theta=jnp.asarray(theta))
    return jp, tba.ba_problem_from_numpy(_to_numpy(jp), device="cpu")


def _at_level(jp, tp, level):
    return (jp._replace(text=jp.text._replace(level=level)),
            tp._replace(text=tp.text._replace(level=level)))


def test_region_covers_every_sample(problems):
    jp, tp = problems
    dropped, n_in = tba.text_region_coverage(tp, F)
    assert dropped == 0 and n_in > 150
    assert jba.text_region_coverage(jp, F) == (0, n_in)


@pytest.mark.parametrize("level", [0, 1])
def test_text_terms(problems, level):
    jp, tp = _at_level(*problems, level)
    jt = jba.text_terms(jp, 3.0, pair_feat=F)
    tt = tba.text_terms(tp, 3.0, pair_feat=F)
    assert int(np.asarray(jt["w"] > 0).sum()) >= 16  # live rows to compare
    for k in ("r", "J_t", "J_h", "J_l", "w", "cost", "chi2"):
        _rel_close(tt[k].numpy(), jt[k], 1e-4)
    chi2, ok = tba.text_chi2(tp, 3.0, pair_feat=F)
    jchi2, jok = jba.text_chi2(jp, 3.0, pair_feat=F)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    _rel_close(chi2.numpy(), jchi2, 1e-4)


def test_joint_assembly(problems):
    jp, tp = problems
    K = jp.poses.shape[0]
    T = jp.theta.shape[0]
    jt = jba.text_terms(jp, 3.0, pair_feat=F)
    tt = tba.text_terms(tp, 3.0, pair_feat=F)
    jH, jb = jba.assemble_camera_system(jt, jp.text.tgt, jp.text.host, K)
    tH, tb = tba.assemble_camera_system(tt, tp.text.tgt, tp.text.host, K)
    _rel_close(tH.numpy(), jH, 1e-4)
    _rel_close(tb.numpy(), jb, 1e-4)
    jW, jHt, jbt = jba.assemble_landmark_system(jt, jp.text.tgt, jp.text.host, jp.text.text,
                                                T, K, 3)
    tW, tHt, tbt = tba.assemble_landmark_system(tt, tp.text.tgt, tp.text.host, tp.text.text,
                                                T, K, 3)
    for a, b in ((tW, jW), (tHt, jHt), (tbt, jbt)):
        _rel_close(a.numpy(), b, 1e-4)


def test_solve_ba_with_text(problems):
    """Poses and planes free; depths frozen (with ~1 observation per point a
    free depth step goes negative and both solvers reject every step)."""
    jp, tp = problems
    jp = jp._replace(rho_free=jnp.zeros_like(jp.rho_free))
    tp = tp._replace(rho_free=torch.zeros_like(tp.rho_free))
    kw = dict(n_iters=6, huber_scene=2.447, huber_text=3.0, text_pair_feat=F)
    js = jba.solve_ba(jp, **kw)
    ts = tba.solve_ba(tp, **kw)
    assert float(js.cost) < float(jba._total_cost(jp, {"scene": 2.447, "text": 3.0}))
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=1e-3)
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses), atol=1e-4)
    np.testing.assert_allclose(ts.theta.numpy(), np.asarray(js.theta), rtol=1e-3, atol=1e-6)


def test_no_free_poses_path(problems):
    """All poses fixed: the landmark blocks decouple and solve alone."""
    jp, tp = problems
    jp = jp._replace(pose_free=jnp.zeros_like(jp.pose_free))
    tp = tp._replace(pose_free=torch.zeros_like(tp.pose_free))
    kw = dict(n_iters=4, huber_scene=2.447, huber_text=3.0, text_pair_feat=F,
              no_free_poses=True)
    js = jba.solve_ba(jp, **kw)
    ts = tba.solve_ba(tp, **kw)
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=1e-3)
    np.testing.assert_array_equal(ts.poses.numpy(), np.asarray(jp.poses))
    np.testing.assert_allclose(ts.rho.numpy(), np.asarray(js.rho), rtol=1e-3)
    np.testing.assert_allclose(ts.theta.numpy(), np.asarray(js.theta), rtol=1e-3, atol=1e-6)
    # the shortcut equals the full path with every pose frozen
    full = tba.solve_ba(tp, **{**kw, "no_free_poses": False})
    np.testing.assert_allclose(float(full.cost), float(ts.cost), rtol=1e-4)


def test_inv3x3_spd_singular_blocks():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(6, 3, 3)).astype(np.float32)
    blocks = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    blocks[4] = [[2.0, 1.0, 0.0], [1.0, 3.0, 0.0], [0.0, 0.0, 0.0]]  # rank 2, det exactly 0
    blocks[5] = 0.0  # an unobserved landmark
    got = tba.inv3x3_spd(torch.from_numpy(blocks)).numpy()
    want = np.asarray(jba.inv3x3_spd(jnp.asarray(blocks)))
    np.testing.assert_allclose(got[:4], np.linalg.inv(blocks[:4]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert (got[4:] == 0).all() and (want[4:] == 0).all()


def test_text_sample_errors(problems):
    jp, tp = problems
    jerr, jok = jba.text_sample_errors(jp, pair_feat=F)
    terr, tok = tba.text_sample_errors(tp, pair_feat=F)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    _rel_close(terr.numpy(), jerr, 1e-4)


def test_sampler_cuda_path_raises_without_gpu(problems):
    """The solver's text rows never fall back to the CPU: a CUDA problem
    without a GPU is refused at conversion."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown here")
    jp, _ = problems
    with pytest.raises(RuntimeError, match="GPU"):
        tba.ba_problem_from_numpy(_to_numpy(jp), device="cuda")

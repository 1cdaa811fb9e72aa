"""Port two-view initialization held against the JAX package, by outcome.

The RANSAC sets come from different generators (jax.random vs a seeded
torch.Generator), and the SVD sign conventions of the two LAPACK paths can
reorder the pose hypotheses, so the stage is compared by what it decides:
`success` and `used_h` equal, rotations within 0.5 deg of each other and of
ground truth, translation directions within 10 deg of ground truth (a
0.3 m baseline with 0.5 px noise leaves the direction uncertain by a few
degrees, and the two RANSACs draw different sets), inlier sets overlapping
by at least 90% (Jaccard).

Planar scene: the JAX package divides each homography by its H22 clipped
from below at 1e-12, so when the SVD hands back the null vector with a
negative H22 the refit H is scaled by -1e12 and the Faugeras decomposition
overflows to NaN. On a fronto-parallel plane that happens for every seed
tried, and the JAX initializer fails; the port keeps the sign and succeeds.
The test holds the port to ground truth there and accepts either the same
outcome from JAX or that known failure (non-finite T21).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textslam_tpu.geometry import twoview as jtv
from textslam_tpu_torch.geometry import se3_np
from textslam_tpu_torch.geometry import twoview as ttv

torch.set_num_threads(2)

FX = FY = 420.0
CX, CY = 320.0, 240.0


def _scene(kind: str, rng, n=400):
    """Matched pixels of n world points in two cameras (plus 10% outliers)."""
    if kind == "planar":
        P = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), np.full(n, 4.0)], -1)
    else:
        P = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2.5, 8, n)], -1)
    baseline = 0.002 if kind == "degenerate" else 0.3
    w = np.array([0.01, -0.06, 0.015])
    th = np.linalg.norm(w)
    q = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * w / th])
    T21 = np.concatenate([q, [-baseline, 0.02 * baseline / 0.3, 0.01 * baseline / 0.3]]).astype(np.float32)

    def proj(p):
        return np.stack([FX * p[:, 0] / p[:, 2] + CX, FY * p[:, 1] / p[:, 2] + CY], -1)

    uv1 = proj(P) + rng.normal(0, 0.5, (n, 2))
    uv2 = proj(se3_np.apply(T21.astype(np.float64), P)) + rng.normal(0, 0.5, (n, 2))
    out = rng.uniform(size=n) < 0.1
    uv2[out] += rng.uniform(-60, 60, (out.sum(), 2))
    valid = rng.uniform(size=n) < 0.97
    return uv1.astype(np.float32), uv2.astype(np.float32), valid, T21


def _rot_angle_deg(qa, qb):
    d = abs(float(np.dot(qa / np.linalg.norm(qa), qb / np.linalg.norm(qb))))
    return np.degrees(2 * np.arccos(min(1.0, d)))


def _dir_angle_deg(ta, tb):
    c = float(np.dot(ta, tb) / (np.linalg.norm(ta) * np.linalg.norm(tb)))
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


@pytest.mark.parametrize("kind", ["general", "planar", "degenerate"])
def test_initialize_two_view_outcome(kind):
    rng = np.random.default_rng({"general": 0, "planar": 1, "degenerate": 2}[kind])
    uv1, uv2, valid, T21_gt = _scene(kind, rng)
    rj = jtv.initialize_two_view(jax.random.PRNGKey(0), jnp.asarray(uv1), jnp.asarray(uv2),
                                 jnp.asarray(valid), FX, FY, CX, CY)
    gen = torch.Generator().manual_seed(0)
    rt = ttv.initialize_two_view(gen, torch.as_tensor(uv1), torch.as_tensor(uv2),
                                 torch.as_tensor(valid), FX, FY, CX, CY)
    if kind == "degenerate":
        assert not bool(rt.success) and not bool(rj.success)  # no parallax: both refuse
        return
    jax_defect = kind == "planar" and not np.isfinite(np.asarray(rj.T21)).all()
    assert bool(rt.success)
    assert bool(rt.used_h) == (kind == "planar")
    Tt = rt.T21.numpy()
    assert _rot_angle_deg(Tt[:4], T21_gt[:4]) < 0.5
    assert _dir_angle_deg(Tt[4:], T21_gt[4:]) < 10.0
    it = rt.is_inlier.numpy()
    assert it.sum() > 200
    assert (rt.points.numpy()[it][:, 2] > 0).all()
    if jax_defect:
        assert not bool(rj.success)
        return
    assert bool(rj.success) and bool(rj.used_h) == bool(rt.used_h)
    Tj = np.asarray(rj.T21)
    assert _rot_angle_deg(Tt[:4], Tj[:4]) < 0.5
    assert _dir_angle_deg(Tj[4:], T21_gt[4:]) < 10.0
    ij = np.asarray(rj.is_inlier)
    assert (it & ij).sum() / max((it | ij).sum(), 1) >= 0.9


def test_ransac_sets_valid_only():
    gen = torch.Generator().manual_seed(3)
    valid = torch.zeros(50, dtype=torch.bool)
    valid[::3] = True
    idx = ttv.ransac_sets(gen, 50, valid, n_sets=40)
    assert idx.shape == (40, 8)
    assert valid[idx].all()
    assert (idx.sort(-1).values.diff(dim=-1) > 0).all()  # distinct per set
    again = ttv.ransac_sets(torch.Generator().manual_seed(3), 50, valid, n_sets=40)
    assert torch.equal(idx, again)  # seeded: deterministic


@pytest.mark.parametrize("model", ["h", "f"])
def test_model_fits_on_clean_points(model):
    """With all points as one exact sample set, the minimal solvers of both
    packages agree up to scale (they solve the same DLT)."""
    rng = np.random.default_rng(5)
    uv1, uv2, _, _ = _scene("planar" if model == "h" else "general", rng, n=40)
    w = np.ones(40, np.float32)
    if model == "h":
        Mj = np.asarray(jtv.solve_h_8pt(jnp.asarray(uv1), jnp.asarray(uv2), w=jnp.asarray(w)))
        Mt = ttv.solve_h_8pt(torch.as_tensor(uv1), torch.as_tensor(uv2), w=torch.as_tensor(w)).numpy()
    else:
        Mj = np.asarray(jtv.solve_f_8pt(jnp.asarray(uv1), jnp.asarray(uv2), w=jnp.asarray(w)))
        Mt = ttv.solve_f_8pt(torch.as_tensor(uv1), torch.as_tensor(uv2), w=torch.as_tensor(w)).numpy()
    Mj = Mj / np.linalg.norm(Mj)
    Mt = Mt / np.linalg.norm(Mt)
    Mt = Mt * np.sign((Mt * Mj).sum())
    np.testing.assert_allclose(Mt, Mj, atol=1e-3)

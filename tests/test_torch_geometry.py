"""Port geometry (textslam_tpu_torch.geometry) held against the JAX package.

Inputs come from a numpy seed and go through both packages. Tolerance:
rtol 1e-5 with atol 1e-6 — both sides compute in float32, but XLA may fuse
or reorder the few multiply-adds of each formula, so results agree to a few
float32 ulps rather than bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textslam_tpu.geometry import camera as jcam
from textslam_tpu.geometry import quaternion as jq
from textslam_tpu.geometry import se3 as jse3
from textslam_tpu.geometry import triangulate as jtri
from textslam_tpu_torch.geometry import camera as tcam
from textslam_tpu_torch.geometry import quaternion as tq
from textslam_tpu_torch.geometry import se3 as tse3
from textslam_tpu_torch.geometry import triangulate as ttri
from textslam_tpu_torch.geometry.sim3 import skew as tskew
from textslam_tpu.geometry.sim3 import skew as jskew

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N = 64


def _unit_q(rng, n=N):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _poses(rng, n=N):
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([_unit_q(rng, n), t], -1).astype(np.float32)


def _close(t_out, j_out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=rtol, atol=atol)


def _pair(fn_t, fn_j, *args):
    """Run fn on torch and jax copies of the same numpy inputs."""
    return (fn_t(*[torch.as_tensor(a) for a in args]),
            fn_j(*[jnp.asarray(a) for a in args]))


QUAT_OPS = {
    "qmul": (tq.qmul, jq.qmul, lambda r: (_unit_q(r), _unit_q(r))),
    "qconj": (tq.qconj, jq.qconj, lambda r: (_unit_q(r),)),
    "qnormalize": (tq.qnormalize, jq.qnormalize,
                   lambda r: (r.normal(size=(N, 4)).astype(np.float32),)),
    "qrotate": (tq.qrotate, jq.qrotate,
                lambda r: (_unit_q(r), r.normal(size=(N, 3)).astype(np.float32))),
    "qto_matrix": (tq.qto_matrix, jq.qto_matrix, lambda r: (_unit_q(r),)),
    "qfrom_matrix": (lambda R: tq.qfrom_matrix(R), lambda R: jq.qfrom_matrix(R),
                     lambda r: (np.array(jq.qto_matrix(jnp.asarray(_unit_q(r)))),)),
    "qexp": (tq.qexp, jq.qexp,
             lambda r: (np.concatenate([r.normal(0, 0.5, (N - 4, 3)),
                                        np.zeros((4, 3))]).astype(np.float32),)),
    "qlog": (tq.qlog, jq.qlog, lambda r: (_unit_q(r),)),
    "qretract": (tq.qretract, jq.qretract,
                 lambda r: (_unit_q(r), r.normal(0, 0.1, (N, 3)).astype(np.float32))),
    "skew": (tskew, jskew, lambda r: (r.normal(size=(N, 3)).astype(np.float32),)),
}


@pytest.mark.parametrize("name", sorted(QUAT_OPS))
def test_quaternion_ops(name):
    fn_t, fn_j, make = QUAT_OPS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    t_out, j_out = _pair(fn_t, fn_j, *make(rng))
    _close(t_out, j_out)


SE3_OPS = {
    "apply": (tse3.apply, jse3.apply,
              lambda r: (_poses(r), r.normal(size=(N, 3)).astype(np.float32))),
    "compose": (tse3.compose, jse3.compose, lambda r: (_poses(r), _poses(r))),
    "inverse": (tse3.inverse, jse3.inverse, lambda r: (_poses(r),)),
    "relative": (tse3.relative, jse3.relative, lambda r: (_poses(r), _poses(r))),
    "retract": (tse3.retract, jse3.retract,
                lambda r: (_poses(r), r.normal(0, 0.1, (N, 6)).astype(np.float32))),
}


@pytest.mark.parametrize("name", sorted(SE3_OPS))
def test_se3_ops(name):
    fn_t, fn_j, make = SE3_OPS[name]
    rng = np.random.default_rng(len(name))
    t_out, j_out = _pair(fn_t, fn_j, *make(rng))
    _close(t_out, j_out)


def test_se3_identity_broadcast():
    np.testing.assert_array_equal(tse3.identity((3,)).numpy(), np.asarray(jse3.identity((3,))))


def _cam_points(rng):
    p = rng.normal(size=(N, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(0.5, 5.0, N)
    p[:3, 2] = [0.0, 1e-13, -1e-13]  # exercise the z ~ 0 guards
    return p


def test_camera_project_unproject():
    rng = np.random.default_rng(3)
    p = _cam_points(rng)
    args = (420.0, 410.0, 320.0, 240.0)
    _close(tcam.project(torch.as_tensor(p), *args), jcam.project(jnp.asarray(p), *args))
    _close(tcam.project_jacobian(torch.as_tensor(p), 420.0, 410.0),
           jcam.project_jacobian(jnp.asarray(p), 420.0, 410.0))
    uv = rng.uniform(-5, 650, (N, 2)).astype(np.float32)
    _close(tcam.unproject(torch.as_tensor(uv), *args), jcam.unproject(jnp.asarray(uv), *args))
    np.testing.assert_array_equal(
        tcam.in_image(torch.as_tensor(uv), 640, 480, margin=1.0).numpy(),
        np.asarray(jcam.in_image(jnp.asarray(uv), 640, 480, margin=1.0)))


def _two_view(rng, n=N):
    """World points seen by two cameras 0.3 m apart."""
    P = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(2, 6, n)], -1)
    T1 = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    q2 = np.asarray(jq.qexp(jnp.asarray([0.01, -0.05, 0.02], dtype=jnp.float32)))
    T2 = np.concatenate([q2, [-0.3, 0.02, 0.01]]).astype(np.float32)
    fx = fy = 420.0
    cx, cy = 320.0, 240.0
    p1 = np.asarray(jse3.apply(jnp.asarray(T1), jnp.asarray(P, dtype=jnp.float32)))
    p2 = np.asarray(jse3.apply(jnp.asarray(T2), jnp.asarray(P, dtype=jnp.float32)))
    ray1 = (p1 / p1[:, 2:3]).astype(np.float32)
    ray2 = (p2 / p2[:, 2:3]).astype(np.float32)
    ray1[:, :2] += rng.normal(0, 1e-3, (n, 2))
    return P.astype(np.float32), ray1, ray2, T1, T2, (fx, fy, cx, cy)


def test_triangulate_family():
    rng = np.random.default_rng(5)
    P, ray1, ray2, T1, T2, K = _two_view(rng)
    Xt = ttri.triangulate(torch.as_tensor(ray1), torch.as_tensor(ray2),
                          torch.as_tensor(T1), torch.as_tensor(T2))
    Xj = jtri.triangulate(jnp.asarray(ray1), jnp.asarray(ray2), jnp.asarray(T1), jnp.asarray(T2))
    # an SVD null vector: the two LAPACK paths agree to ~1e-5 relative
    _close(Xt, Xj, rtol=1e-4, atol=1e-5)
    Pw = P
    uv = np.stack([K[0] * ray2[:, 0] + K[2], K[1] * ray2[:, 1] + K[3]], -1).astype(np.float32)
    _close(ttri.depths(torch.as_tensor(Pw), torch.as_tensor(T2)),
           jtri.depths(jnp.asarray(Pw), jnp.asarray(T2)))
    _close(ttri.reproj_err2(torch.as_tensor(Pw), torch.as_tensor(T2), torch.as_tensor(uv), *K),
           jtri.reproj_err2(jnp.asarray(Pw), jnp.asarray(T2), jnp.asarray(uv), *K),
           rtol=1e-4, atol=1e-4)
    C2 = np.asarray([0.3, -0.02, -0.01], np.float32)
    _close(ttri.parallax_cos(torch.as_tensor(Pw), torch.zeros(3), torch.as_tensor(C2)),
           jtri.parallax_cos(jnp.asarray(Pw), jnp.zeros(3), jnp.asarray(C2)))

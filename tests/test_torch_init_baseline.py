"""The two-view init on a short baseline, in both packages on the CPU: the
distorted CLI set of chip_smoke phase 8 at 320x240 (tests/torch_synth
write_dataset: the text world, seed 0, lateral path, test_cli_e2e's k1,
k2; K halved, test_torch_slam's 500 / 1500 ORB features), each package
reading and undistorting the frames with its own reader, scene only, over
the short list (12 frames). Records for each package the frame pair it
initializes on and the final keyframe ATE; and the JAX package once more
with its homography's sign kept (solve_h_8pt dividing by H22 itself, as
the port does, instead of by H22.clip(1e-12): textslam_tpu/geometry/
twoview.py:63). The port takes an earlier pair than the JAX package; the
JAX package with the sign kept takes the port's pair. So the JAX package
rejects that pair only through the NaN its clipped division gives when
H22 is negative (ROADMAP C: the homography sign, recorded, not to fix)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from textslam_tpu import config as jcfg
from textslam_tpu.geometry import twoview as jtwoview
from textslam_tpu.io import dataset as jds
from textslam_tpu.system import TextSLAM as JaxSLAM
from textslam_tpu_torch import config as tcfg
from textslam_tpu_torch.io import dataset as tds
from textslam_tpu_torch.system import TextSLAM

import torch_synth

torch.set_num_threads(2)

N_FRAMES = 12  # the set's short list (Imshort)
DIST = (-0.05, 0.01, 0.0, 0.0, 0.0)  # chip_smoke.CLI_DIST, test_cli_e2e's
ATE_320 = 0.03  # tests/test_torch_slam.py's keyframe bar at 320x240


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """(port frames, JAX frames, ground truth): the distorted set through
    each package's reader."""
    root = str(tmp_path_factory.mktemp("init_seq"))
    K = torch_synth.K.copy()
    K[:2] /= 2
    gt, _, _ = torch_synth.write_dataset(root, N_FRAMES, K_mat=K, size=(320, 240), dist=DIST,
                                         n_short=N_FRAMES)
    yml = os.path.join(root, "nt_short.yaml")
    tc = dataclasses.replace(tcfg.load_yaml(yml), orb=tcfg.ORBConfig(n_features=500,
                                                                     n_features_init=1500))
    jc = dataclasses.replace(jcfg.load_yaml(yml), orb=jcfg.ORBConfig(n_features=500,
                                                                     n_features_init=1500))
    with tds.Dataset(tc, device="cpu") as ds:
        port = [ds[i][0] for i in range(len(ds))]
    jd = jds.Dataset(jc)
    jax_frames = [jd[i][0] for i in range(len(jd))]
    return tc, jc, port, jax_frames, gt


def _init_and_ate(slam, frames, gt, until_init=False):
    """Feed the frames (until the map has its first two keyframes when
    until_init); returns (the frame ids of the first two keyframes or None,
    the keyframe ATE at the end or None)."""
    for i, img in enumerate(frames):
        slam.track_monocular(img, float(i))
        if until_init and len(slam.map.keyframes) >= 2:
            break
    kfs = slam.map.keyframes
    if len(kfs) < 2:
        return None, None
    pair = (kfs[0].frame_id, kfs[1].frame_id)
    if until_init:
        return pair, None
    est = np.stack([np.asarray(slam.map.kf_pose[kf.kid], np.float32) for kf in kfs])
    return pair, torch_synth.ate_rmse([kf.timestamp for kf in kfs], est, gt)


def _solve_h_sign_kept(p1, p2, w=None):
    """The JAX package's solve_h_8pt (textslam_tpu/geometry/twoview.py:43-63)
    with its last division by H22 itself, the port's normalization, instead
    of by H22.clip(1e-12)."""
    import jax.numpy as jnp

    n1, T1 = jtwoview._normalize(p1)
    n2, T2 = jtwoview._normalize(p2)
    x, y = n1[..., 0], n1[..., 1]
    u, v = n2[..., 0], n2[..., 1]
    zeros, ones = jnp.zeros_like(x), jnp.ones_like(x)
    r1 = jnp.stack([zeros, zeros, zeros, -x, -y, -ones, v * x, v * y, v], axis=-1)
    r2 = jnp.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y, -u], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)
    if w is not None:
        A = A * jnp.concatenate([w, w], axis=-1)[..., None]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    Hn = Vt[..., 8, :].reshape(p1.shape[:-2] + (3, 3))
    H = jnp.linalg.solve(T2, Hn @ T1)
    h22 = H[..., 2:3, 2:3]
    return H / jnp.where(jnp.abs(h22) < 1e-12, 1e-12, h22)


@pytest.fixture(scope="module")
def port_result(frames):
    tc, _, port_frames, _, gt = frames
    return _init_and_ate(TextSLAM(tc, device="cpu"), port_frames, gt)


def test_init_pair_and_ate_in_both_packages(frames, port_result, capsys):
    """The port initializes on an earlier pair than the JAX package; both
    pairs and final keyframe ATEs are printed (the JAX package's run is its
    own result, not held to a bar)."""
    _, jc, _, jax_frames, gt = frames
    port_pair, port_ate = port_result
    jax_pair, jax_ate = _init_and_ate(JaxSLAM(jc), jax_frames, gt)
    with capsys.disabled():
        print(f"\ninit pair, final KF ATE over {N_FRAMES} distorted 320x240 frames: port "
              f"{port_pair}, {port_ate:.6f}; JAX package {jax_pair}, {jax_ate:.6f}")
    assert port_pair is not None and jax_pair is not None
    assert port_pair[0] == jax_pair[0] and port_pair[1] < jax_pair[1]
    assert port_ate < ATE_320


def test_jax_with_the_sign_kept_takes_the_port_pair(frames, port_result, monkeypatch):
    """The JAX package with its homography's sign kept initializes on the
    port's pair: it rejects that pair only through its clipped division."""
    _, jc, _, jax_frames, _ = frames
    monkeypatch.setattr(jtwoview, "solve_h_8pt", _solve_h_sign_kept)
    pair, _ = _init_and_ate(JaxSLAM(jc), jax_frames, None, until_init=True)
    assert pair == port_result[0]

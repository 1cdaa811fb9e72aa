"""The port's scale-out (textslam_tpu_torch/parallel/) held against its own
single-device solver and against the JAX package's sharded path, class by
class as tests/test_parallel.py holds the JAX package: the port on an
8-shard CPU mesh (Mesh(["cpu"] * 8)), JAX on its 8-device virtual CPU mesh
(tests/conftest.py). Problems are built once with numpy (the JAX test
generators) and converted with ba_problem_from_numpy, so both packages see
identical float32 inputs.

Tolerances and why:
- one assembly: tests/test_parallel.py's (rtol 5e-4, atol 2e-3 for the
  scene; rtol 1e-4, atol 1e-3 for the text rows): float32 sums of the
  shards reassociated against one device's;
- a whole LM solve: final cost within 1e-3 relative and poses within 1e-4
  (the sharded LM has the single-device schedule; only its sums are taken
  in another order, which could in principle flip a near-tie accept);
- the landmark-sharded step against the observation-sharded step:
  tests/test_parallel.py's (cost rtol 1e-5, poses / rho rtol 1e-4, atol
  1e-5);
- covisibility products and batched extraction: exact (integer counts
  below 2^24 in float32; the same extraction per frame).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from test_solver_ba import make_ba_problem
from textslam_tpu.parallel import ba_sharded as jbs
from textslam_tpu.parallel import covis_sharded as jcs
from textslam_tpu_torch import config as tcfg
from textslam_tpu_torch.mapper.state import Keyframe, SlamMap
from textslam_tpu_torch.ops import orb
from textslam_tpu_torch.parallel import ba_sharded, covis_sharded, features
from textslam_tpu_torch.parallel.mesh import Mesh, make_mesh
from textslam_tpu_torch.solver import ba

import torch_synth

torch.set_num_threads(2)


def _to_numpy(x):
    if x is None or isinstance(x, (int, float)):
        return x
    if hasattr(x, "_asdict"):
        return {k: _to_numpy(v) for k, v in x._asdict().items()}
    return np.asarray(x)


def _port(jp):
    return ba.ba_problem_from_numpy(_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return Mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return jbs.make_mesh()


@pytest.fixture(scope="module")
def scene_problem():
    jp, poses_gt, _ = make_ba_problem()
    return jp, _port(jp), np.asarray(poses_gt)


def _text_problem(**kw):
    jp = graft._synthetic_problem(n_kf=4, text_feat=8, with_text=True, **kw)
    return jp, _port(jp)


@pytest.fixture(scope="module")
def text_problem():
    # full-size images: the generator's intrinsics assume 640x480
    return _text_problem(n_pts=256, obs_per_kf=128, n_text=4, img_hw=(480, 640), seed=5)


@pytest.fixture(scope="module")
def joint_problem():
    return _text_problem(n_pts=128, obs_per_kf=64, n_text=4, img_hw=(96, 128))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _single_scene(tp, huber=2.447):
    ts = ba.scene_terms(tp, huber)
    K, Pn = tp.poses.shape[0], tp.rho.shape[0]
    Hcc, bc = ba.assemble_camera_system(ts, tp.scene.tgt, tp.scene.host, K)
    W, Hll, bl = ba.assemble_landmark_system(ts, tp.scene.tgt, tp.scene.host, tp.scene.point,
                                             Pn, K, 1)
    return Hcc, bc, W, Hll, bl, ts["cost"].sum()


def _single_text(tp, huber=3.0):
    tt = ba.text_terms(tp, huber)
    K, T = tp.poses.shape[0], tp.theta.shape[0]
    Hcc, bc = ba.assemble_camera_system(tt, tp.text.tgt, tp.text.host, K)
    Wt, Ht, bt = ba.assemble_landmark_system(tt, tp.text.tgt, tp.text.host, tp.text.text, T, K, 3)
    return Hcc, bc, Wt, Ht, bt, tt["cost"].sum()


class TestMesh:
    def test_make_mesh_caps(self):
        assert make_mesh(0, "cpu") is None and make_mesh(1, "cpu") is None
        m = make_mesh(8, "cpu")
        assert m.size == 8 and m.devices == [torch.device("cpu")] * 8 and m.group is None
        assert [s for s, _ in m.local_shards()] == list(range(8))
        # capped to the CUDA device count: no card here, so no mesh
        assert make_mesh(2, "cuda") is None

    def test_make_mesh_homes_on_the_given_card(self, monkeypatch):
        """On CUDA the mesh starts at the caller's card (its home, where
        the summed systems land) and takes the next cards in index order,
        wrapping; the count stays capped."""
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        m = make_mesh(4, "cuda:2")
        assert m.home == torch.device("cuda", 2)
        assert m.devices == [torch.device("cuda", i) for i in (2, 3, 0, 1)]
        assert make_mesh(8, "cuda:1").size == 4

    def test_all_sum_in_shard_order(self, mesh):
        rng = np.random.default_rng(0)
        parts = [[torch.tensor(rng.normal(size=(3, 2)), dtype=torch.float32),
                  torch.tensor(rng.normal(), dtype=torch.float32)] for _ in range(8)]
        a, c = mesh.all_sum(parts)
        want_a, want_c = parts[0][0].clone(), parts[0][1].clone()
        for p in parts[1:]:
            want_a, want_c = want_a + p[0], want_c + p[1]
        assert torch.equal(a, want_a) and torch.equal(c, want_c) and c.shape == ()

    def test_numpy_generator_is_the_jax_problem(self):
        """torch_synth.ba_problem_arrays (the problem chip_smoke.py phase 9
        solves, without jax) is __graft_entry__._synthetic_problem."""
        kw = dict(n_kf=4, n_pts=128, obs_per_kf=64, n_text=4, text_feat=8, img_hw=(96, 128),
                  with_text=True, seed=5)
        want = _to_numpy(graft._synthetic_problem(**kw))
        got = torch_synth.ba_problem_arrays(**kw)
        for key in ("poses", "pose_free", "rho", "rho_free", "theta", "theta_free", "images"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6)
        for fam in ("scene", "text"):
            for k, v in want[fam].items():
                np.testing.assert_allclose(np.asarray(got[fam][k], np.float64),
                                           np.asarray(v, np.float64), rtol=1e-5, atol=1e-4,
                                           err_msg=f"{fam}.{k}")


class TestShardedBA:
    def test_matches_single_device_assembly(self, scene_problem, mesh, jmesh):
        jp, tp, _ = scene_problem
        got = ba_sharded.sharded_scene_normal_eqs(tp, mesh, 2.447)
        want = _single_scene(tp)
        # under jit: eager shard_map traces and compiles on every call
        jwant = jax.jit(lambda p: jbs.sharded_scene_normal_eqs(p, jmesh, 2.447))(jp)
        # Hcc, bc, W, Hll, bl against the port's one device and JAX's mesh
        for i, atol in ((0, 2e-3), (1, 2e-3), (2, 2e-3), (3, 1e-4), (4, 2e-3)):
            _close(got[i], want[i], 5e-4, atol)
            _close(got[i], jwant[i], 5e-4, atol)
        assert abs(float(got[5]) - float(jwant[5])) <= 1e-4 * max(1.0, float(jwant[5]))

    def test_step_reduces_cost(self, scene_problem, mesh):
        _, tp, _ = scene_problem
        poses, rho, cost0 = ba_sharded.sharded_ba_step(tp, mesh)
        _, _, cost1 = ba_sharded.sharded_ba_step(tp._replace(poses=poses, rho=rho), mesh)
        assert float(cost1) < float(cost0)

    def test_iterated_steps_converge(self, scene_problem, mesh):
        _, p, poses_gt = scene_problem
        for _ in range(8):
            poses, rho, _ = ba_sharded.sharded_ba_step(p, mesh)
            p = p._replace(poses=poses, rho=rho)
        for k in range(2, poses_gt.shape[0]):
            dq = float(np.abs((p.poses[k, :4].numpy() * poses_gt[k, :4]).sum()))
            assert 1 - dq < 1e-5
            assert float(np.linalg.norm(p.poses[k, 4:].numpy() - poses_gt[k, 4:])) < 5e-3


class TestShardedLMLoop:
    """solve_ba_sharded is the full deferred-accept LM over the mesh: held
    against the port's solve_ba and JAX's solve_ba_sharded."""

    def _hold(self, st8, st1, jst, check_theta):
        for ref in (st1, jst):
            c = float(np.asarray(ref.cost))
            assert abs(float(st8.cost) - c) <= 1e-3 * max(1.0, c)
            _close(st8.poses, ref.poses, 0, 1e-4)
            if check_theta:
                _close(st8.theta, ref.theta, 0, 1e-4)

    def test_scene_only_matches_solve_ba(self, scene_problem, mesh, jmesh):
        jp, tp, _ = scene_problem
        st8 = ba_sharded.solve_ba_sharded(tp, mesh, n_iters=6)
        self._hold(st8, ba.solve_ba(tp, n_iters=6), jbs.solve_ba_sharded(jp, jmesh, n_iters=6),
                   False)
        _close(st8.rho, ba.solve_ba(tp, n_iters=6).rho, 1e-4, 1e-6)

    def test_joint_text_matches_solve_ba(self, joint_problem, mesh, jmesh):
        jp, tp = joint_problem
        st8 = ba_sharded.solve_ba_sharded(tp, mesh, n_iters=4)
        self._hold(st8, ba.solve_ba(tp, n_iters=4), jbs.solve_ba_sharded(jp, jmesh, n_iters=4),
                   True)

    def test_unpadded_obs_count(self, scene_problem, mesh):
        """Observation counts that do not divide the mesh are padded: the
        padded rows are invalid, with identity host poses."""
        _, tp, _ = scene_problem
        odd = ba.SceneObs(*(x[:-3] for x in tp.scene))
        assert odd.tgt.shape[0] % 8 != 0
        tp = tp._replace(scene=odd)
        padded = ba_sharded.pad_obs_to_shards(odd, 8)
        O = odd.tgt.shape[0]
        assert padded.tgt.shape[0] % 8 == 0 and not padded.valid[O:].any()
        assert torch.equal(padded.host_frozen_pose[O:, 0], torch.ones(padded.tgt.shape[0] - O))
        st8 = ba_sharded.solve_ba_sharded(tp, mesh, n_iters=3)
        _close(st8.poses, ba.solve_ba(tp, n_iters=3).poses, 0, 1e-5)

    def test_unpadded_text_count(self, joint_problem):
        _, tp = joint_problem
        text = ba.TextObs(*(x[:-5] for x in tp.text[:-1]), level=tp.text.level)
        padded = ba_sharded.pad_text_to_shards(text, 8)
        O = text.tgt.shape[0]
        assert padded.tgt.shape[0] % 8 == 0 and not padded.valid[O:].any()
        assert torch.equal(padded.mu_sigma[O:, 1], torch.ones(padded.tgt.shape[0] - O))
        assert torch.equal(padded.host_frozen_pose[O:, 0], torch.ones(padded.tgt.shape[0] - O))
        assert padded.level == text.level


class TestBatchedFeatures:
    @pytest.mark.parametrize("n_frames", [8, 5])
    def test_sharded_extraction(self, mesh, n_frames):
        """Per frame equal to extract_orb; 5 frames on 8 shards pad the
        batch with blank frames, which are dropped."""
        K = torch_synth.K.copy()
        K[:2] /= 4
        frames, _ = torch_synth.render_sequence(n_frames, K_mat=K, size=(160, 120))
        imgs = torch.as_tensor(np.stack(frames), dtype=torch.float32)
        kp = features.batched_extract(imgs, mesh, n_features=200, n_levels=2)
        assert kp.uv.shape[0] == n_frames and bool(kp.valid.any())
        for i in (0, n_frames - 1):
            kp0 = orb.extract_orb(imgs[i], n_features=200, n_levels=2)
            for name in orb.Keypoints._fields:
                a, b = getattr(kp, name)[i], getattr(kp0, name)
                assert a.dtype == b.dtype and torch.equal(a, b), name


class TestLandmarkShardedBA:
    """Landmark-sharded Schur elimination: the per-landmark blocks stay on
    their shard; only the [n, n] reduced camera system is summed."""

    def test_matches_observation_sharded_step(self, scene_problem, mesh):
        _, tp, _ = scene_problem
        p0, r0, c0 = ba_sharded.sharded_ba_step(tp, mesh)
        p1, r1, c1 = ba_sharded.sharded_ba_step_landmark(tp, mesh)
        np.testing.assert_allclose(float(c1), float(c0), rtol=1e-5)
        _close(p1, p0, 1e-4, 1e-5)
        _close(r1, r0, 1e-4, 1e-5)

    def test_partition_routes_every_observation(self, scene_problem):
        _, tp, _ = scene_problem
        routed, rho_p, rf_p, P_local = ba_sharded.partition_scene_by_landmark(
            tp.scene, tp.rho, tp.rho_free, 8)
        n_rows = routed.tgt.shape[0] // 8
        shard = torch.arange(routed.tgt.shape[0]) // n_rows
        glob = routed.point + shard * P_local
        assert int(routed.valid.sum()) == int(tp.scene.valid.sum())
        assert bool((routed.point[routed.valid] < P_local).all())
        assert sorted(glob[routed.valid].tolist()) == sorted(tp.scene.point.tolist())
        assert rho_p.shape[0] == 8 * P_local and not rf_p[tp.rho.shape[0]:].any()

    def test_iterated_converges(self, scene_problem, mesh):
        _, p, poses_gt = scene_problem
        for _ in range(8):
            poses, rho, _ = ba_sharded.sharded_ba_step_landmark(p, mesh)
            p = p._replace(poses=poses, rho=rho)
        for k in range(2, poses_gt.shape[0]):
            dq = float(np.abs((p.poses[k, :4].numpy() * poses_gt[k, :4]).sum()))
            assert 1 - dq < 1e-5
            assert float(np.linalg.norm(p.poses[k, 4:].numpy() - poses_gt[k, 4:])) < 5e-3


class TestShardedTextBA:
    """Joint scene+text: the text rows shard the same way; theta eliminates
    through the 3x3 blocks."""

    def test_matches_single_device_assembly(self, text_problem, mesh, jmesh):
        jp, tp = text_problem
        got = ba_sharded.sharded_text_normal_eqs(tp, mesh, 3.0)
        want = _single_text(tp)
        # eager, as tests/test_parallel.py calls it: under jit XLA fuses the
        # text rows' float32 arithmetic differently, and JAX's jitted sums
        # then leave its own eager ones by ~2e-4 relative on a few entries
        with jax.default_matmul_precision("highest"):
            jwant = jbs.sharded_text_normal_eqs(jp, jmesh, 3.0)
        for i in range(5):  # Hcc, bc, Wt, Ht, bt
            _close(got[i], want[i], 1e-4, 1e-3)
            _close(got[i], jwant[i], 1e-4, 1e-3)
        assert abs(float(got[5]) - float(jwant[5])) <= 1e-4 * max(1.0, float(jwant[5]))

    def test_joint_step_reduces_cost(self, text_problem, mesh):
        _, tp = text_problem
        # references consistent with the current state, a sub-pixel theta
        # perturbation and frozen depths (a raw GN step has no accept /
        # reject), as tests/test_parallel.py sets it up
        tt = ba.text_terms(tp, 1e9)
        r_unw = tt["r"] / tp.text.weight[:, None]
        p = tp._replace(text=tp.text._replace(ref_inten=tp.text.ref_inten + r_unw),
                        theta=tp.theta * 1.002 + 0.0003,
                        rho_free=torch.zeros_like(tp.rho_free))
        poses, rho, theta, cost0 = ba_sharded.sharded_ba_step(p, mesh, lam=0.1)
        p2 = p._replace(poses=poses, rho=rho, theta=theta)
        *_, cost1 = ba_sharded.sharded_ba_step(p2, mesh, lam=0.1)
        assert float(cost1) < float(cost0)


class TestShardedCovisibility:
    """Keyframe-axis map sharding."""

    @pytest.mark.parametrize("K", [5, 64, 200])  # incl. non-multiples of the mesh
    def test_product_bit_matches_host(self, mesh, K):
        rng = np.random.default_rng(K)
        inc = rng.random((K, 333)) < 0.15
        M = covis_sharded.covis_product(inc, mesh)
        inc_i = inc.astype(np.int64)
        M_host = inc_i @ inc_i.T
        np.fill_diagonal(M_host, 0)
        assert M.dtype == np.int32
        np.testing.assert_array_equal(M, M_host)
        np.testing.assert_array_equal(M, jcs.covis_product(inc, jcs.make_mesh(8)))

    def test_weighted_product_matches(self, mesh):
        rng = np.random.default_rng(1)
        inc = rng.random((37, 100)) < 0.2
        w = rng.integers(0, 64, 100)
        inc_i = inc.astype(np.int64)
        M_ref = (inc_i * w[None, :]) @ inc_i.T
        np.fill_diagonal(M_ref, 0)
        np.testing.assert_array_equal(covis_sharded.covis_product(inc, mesh, w=w), M_ref)
        np.testing.assert_array_equal(
            covis_sharded.covis_product(inc, mesh, w=w),
            jcs.covis_product(inc, jcs.make_mesh(8), w=w))

    def test_refuses_inexact_sums(self, mesh):
        inc = np.ones((2, 4), bool)
        with pytest.raises(ValueError, match="not exact"):
            covis_sharded.covis_product(inc, mesh, w=np.full(4, 2 ** 23))

    def test_map_rebuild_uses_sharded_path(self, monkeypatch):
        """SlamMap dispatches its M1/M2/M3 rebuilds to the sharded product
        when configured and the map holds at least covis_min_kfs KFs."""
        cfg = tcfg.TextSLAMConfig(
            camera=tcfg.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0),
            parallel=tcfg.ParallelConfig(covis_devices=8, covis_min_kfs=4))
        m = SlamMap(cfg, device="cpu")
        assert m._covis_mesh is not None and m._covis_mesh.size == 8
        calls = []
        orig = covis_sharded.covis_product

        def spy(inc, mesh, w=None):
            calls.append(inc.shape[0])
            return orig(inc, mesh, w=w)

        monkeypatch.setattr(covis_sharded, "covis_product", spy)
        ident = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
        rng = np.random.default_rng(2)
        for kid in range(8):
            m.add_keyframe(Keyframe(
                kid=kid, frame_id=kid, timestamp=float(kid),
                kp_uv=np.zeros((16, 2), np.float32), kp_level=np.zeros(16, np.int32),
                kp_angle=np.zeros(16, np.float32), kp_desc=np.zeros((16, 8), np.uint32),
                kp_valid=np.ones(16, bool), kp_point=np.full(16, -1, np.int32),
                obs_good=np.zeros(16, bool)), ident)
        pids = [m.add_point(0, np.array([0, 0, 1.0], np.float32), 1.0,
                            np.zeros(8, np.uint32)) for _ in range(12)]
        for kid in range(8):
            for i, p in enumerate(pids):
                if rng.random() < 0.5:
                    m.add_observation(kid, i, p)
        m.rebuild_covis_m1()  # K = 8 >= covis_min_kfs = 4
        assert calls == [8]
        inc = m._point_incidence().astype(np.int64)
        M_ref = inc @ inc.T
        np.fill_diagonal(M_ref, 0)
        np.testing.assert_array_equal(m.M1[:8, :8], M_ref)
        # below covis_min_kfs the host product runs
        small = SlamMap(dataclasses.replace(cfg, parallel=tcfg.ParallelConfig(
            covis_devices=8, covis_min_kfs=9)), device="cpu")
        small.keyframes, small.n_points = m.keyframes, m.n_points
        small.rebuild_covis_m1()
        assert calls == [8]
        np.testing.assert_array_equal(small.M1[:8, :8], M_ref)

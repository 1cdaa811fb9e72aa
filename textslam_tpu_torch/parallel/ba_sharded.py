"""Distributed bundle adjustment over a device mesh, port of
textslam_tpu/parallel/ba_sharded.py.

The residual / Jacobian evaluation and the normal-equation assembly, the
O(observations) work, run observation-parallel: each shard of the mesh
(parallel.mesh.Mesh) assembles the rows it owns, and the partial systems
(camera system, landmark blocks, cost) are summed over the mesh with one
Mesh.all_sum per build, where the JAX package psums each block. The LM
schedule, the damping, the Schur elimination and the back-substitution run
replicated, through the single-device solver's own loop
(solver.ba._solve_ba_body with build_override), so the two solvers differ
only in the order of their float32 sums.

The landmark-sharded step keeps each landmark's block on the shard that
owns the landmark and all its observations: only the [n, n] reduced camera
system and [n] right-hand side cross the mesh.

Text rows sample through the per-feature patch gather
(ops.interp.patch_bilinear_stack), as in the JAX package: the grouped
region sampler needs rows in [pair, pair_feat] groups, which shard cuts
split.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..solver import ba
from .mesh import Mesh


def _pad_rows(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    pad = x.new_full((n - x.shape[0],) + tuple(x.shape[1:]), fill)
    return torch.cat([x, pad], dim=0)


def _shard_multiple(O: int, n_shards: int) -> int:
    return ((O + n_shards - 1) // n_shards) * n_shards


def pad_obs_to_shards(scene: ba.SceneObs, n_shards: int) -> ba.SceneObs:
    """Pad the observation batch so its length divides the shard count.
    Padded rows are invalid, with identity host poses."""
    O = scene.tgt.shape[0]
    Opad = _shard_multiple(O, n_shards)
    if Opad == O:
        return scene
    hp = _pad_rows(scene.host_frozen_pose, Opad)
    hp[O:, 0] = 1.0
    fields = {f: _pad_rows(getattr(scene, f), Opad) for f in ba.SceneObs._fields}
    return ba.SceneObs(**dict(fields, host_frozen_pose=hp))


def pad_text_to_shards(text: ba.TextObs, n_shards: int) -> ba.TextObs:
    """Pad the text observation batch so its length divides the shard
    count. Padded rows are invalid, with identity host poses and sigma 1."""
    O = text.tgt.shape[0]
    Opad = _shard_multiple(O, n_shards)
    if Opad == O:
        return text
    hp = _pad_rows(text.host_frozen_pose, Opad)
    hp[O:, 0] = 1.0
    ms = _pad_rows(text.mu_sigma, Opad)
    ms[O:, 1] = 1.0
    fields = {f: _pad_rows(getattr(text, f), Opad) for f in ba.TextObs._fields if f != "level"}
    return ba.TextObs(**dict(fields, host_frozen_pose=hp, mu_sigma=ms, level=text.level))


def _rows(obs, s: int, n_shards: int, device):
    """Shard s of n_shards of an (already padded) observation batch, on
    `device`: a contiguous block of rows; `level` rides along."""
    b = obs.tgt.shape[0] // n_shards
    return type(obs)(**{f: (v[s * b:(s + 1) * b].to(device) if isinstance(v, torch.Tensor)
                            else v) for f, v in obs._asdict().items()})


def _to(x, device):
    return None if x is None else x.to(device)


def _local_problems(problem: ba.BAProblem, mesh: Mesh):
    """(device, problem) per local shard: the shard's observation rows and
    the replicated fields, on the shard's device. Observation batches must
    already be padded to the shard count."""
    n = mesh.size
    out = []
    for s, d in mesh.local_shards():
        out.append((d, problem._replace(
            poses=problem.poses.to(d), pose_free=problem.pose_free.to(d),
            rho=problem.rho.to(d), rho_free=problem.rho_free.to(d),
            theta=_to(problem.theta, d), theta_free=_to(problem.theta_free, d),
            images=_to(problem.images, d),
            scene=None if problem.scene is None else _rows(problem.scene, s, n, d),
            text=None if problem.text is None else _rows(problem.text, s, n, d))))
    return out


def _scene_partials(prob: ba.BAProblem, huber: float) -> List[torch.Tensor]:
    """One shard's scene system: [Hcc, bc, W, Hll, bl, cost]."""
    K, P = prob.poses.shape[0], prob.rho.shape[0]
    s = prob.scene
    ts = ba.scene_terms(prob, huber)
    Hcc, bc = ba.assemble_camera_system(ts, s.tgt, s.host, K)
    W, Hll, bl = ba.assemble_landmark_system(ts, s.tgt, s.host, s.point, P, K, 1)
    return [Hcc, bc, W, Hll, bl, ts["cost"].sum()]


def _text_partials(prob: ba.BAProblem, huber: float) -> List[torch.Tensor]:
    """One shard's text system: [Hcc, bc, Wt, Ht, bt, cost]."""
    K, T = prob.poses.shape[0], prob.theta.shape[0]
    t = prob.text
    tt = ba.text_terms(prob, huber)
    Hcc, bc = ba.assemble_camera_system(tt, t.tgt, t.host, K)
    Wt, Ht, bt = ba.assemble_landmark_system(tt, t.tgt, t.host, t.text, T, K, 3)
    return [Hcc, bc, Wt, Ht, bt, tt["cost"].sum()]


def sharded_scene_normal_eqs(problem: ba.BAProblem, mesh: Mesh, huber: float):
    """Scene-family normal equations with observation-parallel assembly:
    observations shard over the mesh, poses / rho replicate. Returns the
    sums (Hcc [n, n], bc [n], W [P, n, 1], Hll [P, 1, 1], bl [P, 1], cost)
    on the mesh's home device."""
    problem = problem._replace(scene=pad_obs_to_shards(problem.scene, mesh.size), text=None)
    return tuple(mesh.all_sum([_scene_partials(p, huber)
                               for _, p in _local_problems(problem, mesh)]))


def sharded_text_normal_eqs(problem: ba.BAProblem, mesh: Mesh, huber: float):
    """Text-family normal equations with observation-parallel assembly:
    photometric rows shard over the mesh, poses / theta and the target image
    stack replicate. Returns the sums (Hcc, bc, Wt [T, n, 3], Ht [T, 3, 3],
    bt [T, 3], cost) on the mesh's home device."""
    problem = problem._replace(text=pad_text_to_shards(problem.text, mesh.size), scene=None)
    return tuple(mesh.all_sum([_text_partials(p, huber)
                               for _, p in _local_problems(problem, mesh)]))


def _sharded_build(problem: ba.BAProblem, mesh: Mesh, huber_scene: float, huber_text: float):
    """The LM's build over the mesh: each shard assembles its scene and text
    rows into one set of partials (Hcc, bc, Wr, Hr, br, Wt, Ht, bt, cost;
    1-element zeros for an absent family, as solver.ba's build), and one
    all_sum reduces them. Observation rows are split once, here; each build
    moves only the parameters. `problem`'s batches are padded; the summed
    system comes back on the device of the parameters it is built at."""
    shards = _local_problems(problem, mesh)
    K = problem.poses.shape[0]
    n = 6 * (K + 1)

    def partials(prob):
        d = prob.poses.device
        z1 = torch.zeros(1, device=d)
        Hcc = torch.zeros((n, n), device=d)
        bc = torch.zeros(n, device=d)
        Wr = Hr = br = Wt = Ht = bt = z1
        cost = torch.zeros((), device=d)
        if prob.scene is not None:
            H1, b1, Wr, Hr, br, c1 = _scene_partials(prob, huber_scene)
            Hcc, bc, cost = Hcc + H1, bc + b1, cost + c1
        if prob.text is not None:
            H2, b2, Wt, Ht, bt, c2 = _text_partials(prob, huber_text)
            Hcc, bc, cost = Hcc + H2, bc + b2, cost + c2
        return [Hcc, bc, Wr, Hr, br, Wt, Ht, bt, cost]

    def build(prob):
        parts = [partials(ps._replace(poses=prob.poses.to(d), rho=prob.rho.to(d),
                                      theta=_to(prob.theta, d)))
                 for d, ps in shards]
        *sys, cost = (a.to(prob.poses.device) for a in mesh.all_sum(parts))
        return tuple(sys), cost

    return build


def _padded(problem: ba.BAProblem, n_shards: int) -> ba.BAProblem:
    return problem._replace(
        scene=None if problem.scene is None else pad_obs_to_shards(problem.scene, n_shards),
        text=None if problem.text is None else pad_text_to_shards(problem.text, n_shards))


def solve_ba_sharded(
    problem: ba.BAProblem,
    mesh: Mesh,
    n_iters: int = 10,
    huber_scene: float = 2.447,
    huber_text: float = 3.0,
    lam0: float = 1e-4,
    lam_up: float = 10.0,
    lam_down: float = 0.1,
    lam_min: float = 1e-12,
    lam_max: float = 1e8,
) -> ba.LMState:
    """The full deferred-accept LM bundle adjustment over a mesh, with the
    semantics of solver.ba.solve_ba (accept/reject schedule, damping, Schur
    elimination, gauge handling): only the assembly is sharded, and its
    partial systems arrive by Mesh.all_sum. Observation batches are padded
    to the shard count once, before the loop. Text rows sample per feature
    (no text_pair_feat: shard cuts split the region sampler's groups). The
    all-poses-fixed shortcut (solve_ba's no_free_poses) is not taken: with
    every pose fixed the camera step is zero either way."""
    problem = _padded(problem, mesh.size)
    build = _sharded_build(problem, mesh, huber_scene, huber_text)
    return ba._solve_ba_body(problem, n_iters, huber_scene, huber_text, lam0, lam_up, lam_down,
                             0, lam_min=lam_min, lam_max=lam_max, build_override=build)


def sharded_ba_step(problem: ba.BAProblem, mesh: Mesh, huber: float = 2.447,
                    huber_text: float = 3.0, lam: float = 1e-4):
    """One damped Gauss-Newton step of scene (+ text) BA with the sharded
    assembly and the single-device solver's replicated step
    (solver.ba.damped_step: Schur solve, landmark back-substitution).
    Returns (poses, rho, cost), or (poses, rho, theta, cost) with text."""
    problem = _padded(problem, mesh.size)
    sys, cost = _sharded_build(problem, mesh, huber, huber_text)(problem)
    poses, rho, theta = ba.apply_update(problem, *ba.damped_step(problem, sys, lam))
    if problem.text is not None:
        return poses, rho, theta, cost
    return poses, rho, cost


def partition_scene_by_landmark(scene: ba.SceneObs, rho: torch.Tensor, rho_free: torch.Tensor,
                                n_shards: int):
    """Host-side routing for landmark-sharded BA: landmarks go to shards in
    contiguous blocks of P_local, every observation to its landmark's shard,
    and point ids become shard-local.

    Returns (scene_routed, rho_padded, rho_free_padded, P_local): shard s
    owns observation rows [s*O_max, (s+1)*O_max) and landmarks
    [s*P_local, (s+1)*P_local). Padded rows are invalid, with identity host
    poses."""
    P = rho.shape[0]
    dev = rho.device
    P_local = (P + n_shards - 1) // n_shards
    pt = scene.point.cpu().numpy()
    shard_of_obs = np.minimum(pt // P_local, n_shards - 1)
    O_max = max(int(np.bincount(shard_of_obs, minlength=n_shards).max()), 1)
    order = np.argsort(shard_of_obs, kind="stable")
    routed = {f: getattr(scene, f).cpu().numpy() for f in scene._fields if f != "point"}
    out = {}
    for f, a in routed.items():
        out[f] = np.zeros((n_shards * O_max,) + a.shape[1:], a.dtype)
    out["host_frozen_pose"][:, 0] = 1.0
    point_local = np.zeros(n_shards * O_max, np.int64)
    for s in range(n_shards):
        rows = order[shard_of_obs[order] == s]
        n = len(rows)
        for f, a in routed.items():
            out[f][s * O_max: s * O_max + n] = a[rows]
        point_local[s * O_max: s * O_max + n] = pt[rows] - s * P_local
    scene_routed = ba.SceneObs(point=torch.as_tensor(point_local, device=dev),
                               **{f: torch.as_tensor(v, device=dev) for f, v in out.items()})
    return (scene_routed, _pad_rows(rho, n_shards * P_local),
            _pad_rows(rho_free, n_shards * P_local, False), P_local)


def _landmark_sharded_step(scene, rho_p, rf_p, poses, pose_free, P_local: int, mesh: Mesh,
                           huber: float, lam: float, fx, fy, cx, cy):
    """One damped GN step with LANDMARK-sharded Schur elimination. Each
    shard owns a block of landmarks and all their observations, so the
    per-landmark arrays (W, Hll, bl) stay on it: only the [n, n] reduced
    camera system, the [n] right-hand side and the cost are summed over the
    mesh. The camera solve is replicated and the landmark back-substitution
    shard-local. Returns (poses, [(global shard, rho block)], cost)."""
    K = poses.shape[0]
    n_shards = mesh.size
    local = []
    parts = []
    for s, d in mesh.local_shards():
        scene_l = _rows(scene, s, n_shards, d)
        rho_l = rho_p[s * P_local:(s + 1) * P_local].to(d)
        rf_l = rf_p[s * P_local:(s + 1) * P_local].to(d)
        prob = ba.BAProblem(poses=poses.to(d), pose_free=pose_free.to(d), rho=rho_l,
                            rho_free=rf_l, scene=scene_l, fx=fx, fy=fy, cx=cx, cy=cy)
        ts = ba.scene_terms(prob, huber)
        Hcc, bc = ba.assemble_camera_system(ts, scene_l.tgt, scene_l.host, K)
        W, Hll, bl = ba.assemble_landmark_system(ts, scene_l.tgt, scene_l.host, scene_l.point,
                                                 P_local, K, 1)
        Hr_inv = ba.rho_inv(Hll, lam)
        W2 = W[:, :, 0]
        WH = W2 * Hr_inv[:, None]
        parts.append([Hcc - WH.T @ W2, bc - WH.T @ bl[:, 0], ts["cost"].sum()])
        local.append((s, d, W2, Hr_inv, bl, rho_l, rf_l))
    H_red, b_red, cost = mesh.all_sum(parts)
    delta_c = ba.reduced_camera_solve(H_red, b_red, pose_free.to(H_red.device), lam)
    blocks = []
    for s, d, W2, Hr_inv, bl, rho_l, rf_l in local:
        drho = Hr_inv * (-bl[:, 0] - W2 @ delta_c.to(d))
        blocks.append((s, rho_l + drho * rf_l))
    return ba.retract_poses(poses, pose_free, delta_c.to(poses.device)), blocks, cost


def sharded_ba_step_landmark(problem: ba.BAProblem, mesh: Mesh, huber: float = 2.447,
                             lam: float = 1e-4):
    """Landmark-sharded GN step (host routing + the sharded step). Returns
    (poses, rho [P], cost); the shard-local rho blocks are gathered back
    to the original length by one more all_sum (every shard contributes
    its own block, zeros elsewhere)."""
    P = problem.rho.shape[0]
    scene, rho_p, rf_p, P_local = partition_scene_by_landmark(
        problem.scene, problem.rho, problem.rho_free, mesh.size)
    poses, blocks, cost = _landmark_sharded_step(
        scene, rho_p, rf_p, problem.poses, problem.pose_free, P_local, mesh, huber, lam,
        problem.fx, problem.fy, problem.cx, problem.cy)
    parts = []
    for s, blk in blocks:
        full = torch.zeros(rho_p.shape[0], device=blk.device)
        full[s * P_local:(s + 1) * P_local] = blk
        parts.append([full])
    (rho,) = mesh.all_sum(parts)
    return poses, rho[:P].to(problem.rho.device), cost

"""The check fails what it has to: a run with the timed path broken
underneath (the look for a chip skipped, the rest of a run driven on the
CPU at a tiny size) comes out not correct, once for each fault a cell of
this system can have, and the control (the reference computed in the next
lower precision, put in the program's place) fails its stages. A sound run
comes out correct. The cells run on one chip, so the fault of an exchange
between chips left out does not arise."""

import functools

import pytest
import torch

from slambench import testing
from slambench.lib import check


def _failed(res):
    return {name for name, v, lim in res["checks"] if not v <= lim}


@pytest.fixture
def sound_notext():
    return testing.tiny_run("gm_notext.walk", seed=8)


def test_a_sound_run_is_correct(sound_notext):
    assert sound_notext["correct"], sound_notext["checks"]
    assert sound_notext["numbers"]["frames_checked"] == 2


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from textslam_tpu_torch.frontend import tracking

    def stuck(self, frame):  # the pose of the last frame, nothing tracked
        frame.pose = self.last_pose.copy()
        return True

    monkeypatch.setattr(tracking.Tracker, "_track", stuck)
    res = testing.tiny_run("gm_notext.walk", seed=8)
    assert not res["correct"] and "stuck_frames" in _failed(res)


@pytest.mark.parametrize("cell,stage", [("gm_notext.walk", "pose_gap"),
                                        ("gm_notext.walk", "ba_gap"),
                                        ("gm_text.walk", "pose_gap")])
def test_a_solver_that_returns_its_state_unchanged(monkeypatch, cell, stage):
    """Every scene solve of the window hands back its start: the pose
    solves of the track step and the windowed BA's solves read 1."""
    from textslam_tpu_torch.solver import ba

    orig = ba.solve_ba
    kind = {"pose_gap": lambda p: int(p.pose_free.sum()) == 1 and not bool(p.rho_free.any()),
            "ba_gap": lambda p: bool(p.rho_free.any()) or int(p.pose_free.sum()) > 1}[stage]

    @functools.wraps(orig)
    def unchanged(problem, *a, **kw):
        st = orig(problem, *a, **kw)
        if problem.scene is not None and problem.text is None and kind(problem):
            return st._replace(poses=problem.poses.clone(), rho=problem.rho.clone())
        return st

    monkeypatch.setattr(ba, "solve_ba", unchanged)
    res = testing.tiny_run(cell, seed=8)
    assert not res["correct"] and stage in _failed(res)
    assert res["numbers"][stage] == pytest.approx(1.0, abs=1e-6)


def test_a_track_step_that_skips_its_refinement(monkeypatch):
    """The track step hands back its motion-model guess: no pose solve is
    left to compare, and the empty stage fails."""
    from textslam_tpu_torch.frontend import tracking

    def guess(prob, base_valid, *a, **kw):
        return prob.poses[0], base_valid

    monkeypatch.setattr(tracking, "fused_pose_optimize", guess)
    res = testing.tiny_run("gm_notext.walk", seed=8)
    assert not res["correct"] and "stages_empty" in _failed(res)
    assert res["numbers"]["pose_calls"] == 0


def test_half_of_the_matcher_batch_left_out(monkeypatch):
    from textslam_tpu_torch.ops import matching

    def halve(orig):
        n = [0]

        def f(*args):
            out = orig(*args)
            n[0] += 1
            if n[0] > 12:  # past the initialisation and the warm-up frames
                out[1::2] = 0  # every other row never computed
            return out
        return f

    monkeypatch.setattr(matching, "hamming_matrix", halve(matching.hamming_matrix))
    monkeypatch.setattr(matching, "hamming_matrix_min", halve(matching.hamming_matrix_min))
    res = testing.tiny_run("gm_notext.walk", seed=8)
    assert not res["correct"] and "hamming_max_diff" in _failed(res)


def test_half_of_the_sampler_batch_left_out(monkeypatch):
    from textslam_tpu_torch.ops import patch_sample

    orig = patch_sample.grouped_bilinear_stack

    def halve(imgs, group_k, uv, *a, **kw):
        vals, mask = orig(imgs, group_k, uv, *a, **kw)
        q = vals.shape[1] // 2  # the second half of every group's samples never taken
        vals[:, q:] = 0
        mask[:, q:] = False
        return vals, mask

    monkeypatch.setattr(patch_sample, "grouped_bilinear_stack", halve)
    res = testing.tiny_run("gm_text.walk", seed=8)
    assert not res["correct"] and {"sampler_mask_diff", "sampler_rel_err"} & _failed(res)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from textslam_tpu_torch import system

    orig = system.build_frame

    def flip(*a, **kw):
        frame = orig(*a, **kw)
        desc = frame.kp_packed_dev[:, 6:7].view(torch.int32)
        desc ^= 1  # one descriptor bit of every keypoint
        return frame

    monkeypatch.setattr(system, "build_frame", flip)
    res = testing.tiny_run("gm_notext.walk", seed=8)
    assert not res["correct"] and "orb_mismatch_pct" in _failed(res)


@pytest.mark.parametrize("cell", ["gm_notext.walk", "gm_text.walk"])
def test_the_control_fails_the_stages(monkeypatch, cell):
    """The reference in bfloat16 in the program's place: the frame build's,
    the solves' and (text on) the sampler's numbers come out above their
    limits."""
    kept = {}
    orig_stage = check.stage_numbers

    def keep(cap, cfg, text_on, control=False):
        kept["args"] = (cap, cfg, text_on)
        return orig_stage(cap, cfg, text_on, control)

    monkeypatch.setattr(check, "stage_numbers", keep)
    res = testing.tiny_run(cell, seed=9)
    assert res["correct"], res["checks"]
    low = orig_stage(*kept["args"], control=True)
    limits = dict((n, lim) for n, _, lim in res["checks"])
    above = {n for n in ("orb_mismatch_pct", "sampler_rel_err", "pose_gap", "ba_gap")
             if n in limits and low[n] > limits[n]}
    assert above == ({"orb_mismatch_pct", "pose_gap"} | ({"ba_gap"} if low["ba_calls"] else set())
                     | ({"sampler_rel_err"} if "sampler_rel_err" in limits else set()))

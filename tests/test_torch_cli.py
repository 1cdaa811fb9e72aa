"""The port's command-line entry point (python -m textslam_tpu_torch.cli)
on a disk dataset in the reference layout (tests/torch_synth.write_dataset:
20 distorted frames of the text world at 320x240 with K halved, PNG frames
with every row filter, detections with the CJK and "#" probe lines), scene
only, with test_torch_slam's 500 / 1500 ORB features: a run checkpointed at
frame 11 and resumed over the full list chooses the same keyframes as the
uninterrupted run, with poses within 1e-3 (tests/test_cli_e2e.py's bar),
and writes every output; without a GPU the default device raises."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from textslam_tpu_torch import cli
from textslam_tpu_torch import config as tcfg
from textslam_tpu_torch.geometry import se3_np
from textslam_tpu_torch.io.trajectory import read_tum

import torch_synth

torch.set_num_threads(2)

N_FRAMES = 20
POSE_DIFF = 1e-3
ATE_320 = 0.03  # tests/test_torch_slam.py's keyframe bar at 320x240


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_seq"))
    K = torch_synth.K.copy()
    K[:2] /= 2
    gt, _, _ = torch_synth.write_dataset(root, N_FRAMES, K_mat=K, size=(320, 240))
    return root, gt


@pytest.fixture
def small_orb(monkeypatch):
    """load_yaml with 500 / 1500 ORB features (the yaml has no ORB keys)."""
    load = tcfg.load_yaml
    monkeypatch.setattr(tcfg, "load_yaml", lambda p: dataclasses.replace(
        load(p), orb=tcfg.ORBConfig(n_features=500, n_features_init=1500)))


def test_resume_matches_uninterrupted(dataset, tmp_path, small_orb, capsys):
    root, gt = dataset
    a, b = str(tmp_path / "uninterrupted"), str(tmp_path / "resumed")
    assert cli.main([os.path.join(root, "nt_full.yaml"), a, "--device", "cpu"]) == 0
    assert cli.main([os.path.join(root, "nt_short.yaml"), b, "--checkpoint-every", "6",
                     "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(b, "checkpoint.npz"))
    assert not os.path.exists(os.path.join(b, "checkpoint.npz.tmp.npz"))
    assert cli.main([os.path.join(root, "nt_full.yaml"), b, "--resume", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[resume] checkpoint at frame 11" in out and "continuing at frame 12" in out
    assert "read+decode" in out and "undistort" in out and "track" in out

    ts_a, p_a = read_tum(os.path.join(a, "keyframe.txt"))
    ts_b, p_b = read_tum(os.path.join(b, "keyframe.txt"))
    assert len(ts_a) >= 3
    np.testing.assert_array_equal(ts_a, ts_b)
    d = np.abs(p_a - p_b).max()
    assert d < POSE_DIFF, f"resumed trajectory diverged: max pose diff {d}"
    ate = torch_synth.ate_rmse(ts_a * 10.0, se3_np.inverse(p_a), gt)
    assert ate < ATE_320, f"CLI keyframe ATE {ate}"
    ts_l, _ = read_tum(os.path.join(b, "keyframe_latest.txt"))
    assert len(ts_l) == len(ts_b)
    ts_f, _ = read_tum(os.path.join(b, "pose_F.txt"))
    assert len(ts_f) >= N_FRAMES - 5  # the restored prefix and the resumed tail


def test_default_device_without_gpu_raises(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        cli.main([os.path.join(dataset[0], "exp0.yaml"), str(tmp_path / "out")])


def main(argv=None):
    """`PYTHONPATH=. python tests/test_torch_cli.py [--jax] [--threads N]`: the CLI text
    run at 320x240 on this machine's CPU, on the 24-frame set of chip_smoke
    phase 8 (text world seed 0, lateral, fps 10) with K halved and 500 / 1500
    ORB features, stored distorted (test_cli_e2e's k1, k2) and undistorted;
    prints each run's keyframes and keyframe ATE, and frame 5's mean
    undistortion error (central region) against the ideal render. --jax also
    runs the JAX package's main.py on the distorted set (~12 min)."""
    import argparse
    import sys
    import tempfile

    ap = argparse.ArgumentParser()
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    K = torch_synth.K.copy()
    K[:2] /= 2
    load = tcfg.load_yaml
    tcfg.load_yaml = lambda p: dataclasses.replace(
        load(p), orb=tcfg.ORBConfig(n_features=500, n_features_init=1500))
    with tempfile.TemporaryDirectory() as tmp:
        for name, dist in (("distorted", (-0.05, 0.01, 0.0, 0.0, 0.0)), ("undistorted", (0,) * 5)):
            root = os.path.join(tmp, name)
            gt, world, _ = torch_synth.write_dataset(root, 24, K_mat=K, size=(320, 240), dist=dist)
            from textslam_tpu_torch.io.dataset import Dataset

            with Dataset(tcfg.load_yaml(os.path.join(root, "exp0.yaml")), device="cpu") as ds:
                img = ds[5][0].numpy()
            c = (slice(60, 180), slice(80, 240))
            err = np.abs(img[c] - world.render(gt[5], K_mat=K, size=(320, 240))[c]).mean()
            cli.main([os.path.join(root, "exp0.yaml"), os.path.join(root, "out"),
                      "--device", "cpu"])
            ts, p = read_tum(os.path.join(root, "out", "keyframe.txt"))
            print(f"port, {name}: {len(ts)} KFs at {ts.tolist()}, KF ATE "
                  f"{torch_synth.ate_rmse(ts * 10.0, se3_np.inverse(p), gt):.6f}; frame 5 "
                  f"undistortion error {err:.4f} gray")
            if args.jax and name == "distorted":
                sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
                from textslam_tpu import config as jcfg
                import main as jmain

                jload = jcfg.load_yaml
                jcfg.load_yaml = lambda p: dataclasses.replace(
                    jload(p), orb=jcfg.ORBConfig(n_features=500, n_features_init=1500))
                sys.argv = ["main.py", os.path.join(root, "exp0.yaml"), os.path.join(root, "jax")]
                jmain.main()
                ts, p = read_tum(os.path.join(root, "jax", "keyframe.txt"))
                print(f"JAX, {name}: {len(ts)} KFs at {ts.tolist()}, KF ATE "
                      f"{torch_synth.ate_rmse(ts * 10.0, se3_np.inverse(p), gt):.6f}")


if __name__ == "__main__":
    main()

"""textslam_tpu_torch — the PyTorch/CUDA port of textslam_tpu.

Monocular keyframe SLAM with ORB scene points and planar text objects,
ported slice by slice from the JAX package `textslam_tpu/`, which stays the
reference. Ported: the scene-only pipeline (`Exp noText`) and the text
pipeline of the default configuration: frame build, descriptor matching on
a hand-written CUDA Hamming kernel, pose tracking chained with the joint
scene+text photometric refinement, two-view initialization, the text-object
lifecycle, the windowed joint point+text bundle adjustment whose
photometric rows sample through a hand-written CUDA region sampler, and
semantic loop closing (Levenshtein detection on text strings, Sim3 RANSAC
and refinement, landmark fusion, the Sim3 pose graph, the global and
landmark-only bundle adjustments), checkpoint/resume in the JAX package's
file format, the dataset reader and the command-line entry point
(`python -m textslam_tpu_torch.cli`), and scale-out over a device mesh
(`parallel/`: the sharded bundle adjustment, covisibility and extraction),
and the native host routines (`native.py`: threaded C++ Levenshtein and
covisibility products).

Plain tensor code is PyTorch; every Pallas kernel of the JAX package becomes
a hand-written Hopper kernel under `csrc/`. The package never imports jax,
textslam_tpu, cv2 or PIL.
"""

import torch as _torch

# Full float32 matmuls and convolutions. The JAX package pins f32 matmuls
# (textslam_tpu/__init__.py) because reduced-precision products quantize
# pixel coordinates (~100..600) in the two-view / triangulation / projection
# chains and cost it 25x in ATE. TF32 keeps ~3 decimal digits, the same
# hazard, so it is switched off for both cuBLAS and cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import TextSLAMConfig, Experiment  # noqa: E402,F401

__version__ = "0.1.0"

"""Per-frame construction: ORB keypoints, the in-box ORB densification of
text detections, and the x2 direct-alignment pyramid. Port of
textslam_tpu/frontend/frame.py.

The keypoints of a frame stay on the device as one packed [N, 14] float32
pool (ops.orb.pack_keypoints); the host mirror (numpy, descriptors as
uint32) materializes once, on first access, through ensure_host_kp — only
keyframes and the initializer need it. The packed pyramid [L, H, W, 3]
(intensity, sobel-x, sobel-y) stays on the device too (`pyr_dev`); its host
mirror materializes only when a keyframe's device copy is evicted
(host_pyr).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..config import TextSLAMConfig
from ..ops import orb, pyramid


@dataclasses.dataclass
class TextDetection:
    """One precomputed OCR detection (quad + recognized string)."""

    quad: np.ndarray  # [4, 2] float32 pixel corners
    text: str
    score: float
    lang: int = 0  # 0 latin-ish, 1 CJK-ish


@dataclasses.dataclass
class Frame:
    frame_id: int
    timestamp: float
    shape: tuple  # (H, W)
    # host keypoint mirror (lazy when kp_packed_dev is set)
    kp_uv: Optional[np.ndarray] = None
    kp_level: Optional[np.ndarray] = None
    kp_angle: Optional[np.ndarray] = None
    kp_desc: Optional[np.ndarray] = None  # [N, 8] uint32
    kp_valid: Optional[np.ndarray] = None
    # packed [N, 14] device keypoint pool (ops.orb.pack_keypoints layout)
    kp_packed_dev: Optional[torch.Tensor] = None
    # packed direct pyramid: host mirror (lazy), true per-level extents,
    # device copy
    pyr_data: Optional[np.ndarray] = None  # [L, H, W, 3]
    pyr_shapes: Optional[np.ndarray] = None  # [L, 2] int32
    pyr_dev: Optional[torch.Tensor] = None
    detections: List[TextDetection] = dataclasses.field(default_factory=list)
    pose: Optional[np.ndarray] = None  # [7] Tcw once tracked

    @property
    def n_valid(self) -> int:
        ensure_host_kp(self)
        return int(self.kp_valid.sum())


def ensure_host_kp(frame) -> None:
    """Materialize (once) the host keypoint mirror from the packed device
    pool: one readback; no-op when the mirror already exists."""
    if frame.kp_uv is not None or getattr(frame, "kp_packed_dev", None) is None:
        return
    from ..utils.profiling import phase

    with phase("frame.kp_pull"):
        packed = frame.kp_packed_dev.cpu().numpy()
    uv, level, angle, _, valid, desc = orb.unpack_keypoints_np(packed)
    frame.kp_uv = uv
    frame.kp_level = level
    frame.kp_angle = angle
    frame.kp_desc = desc
    frame.kp_valid = valid


def packed_kp_dev(frame, device) -> torch.Tensor:
    """The packed [N, 14] device keypoint pool of a Frame, building it from
    the host mirror when the frame was not device-built (tests, replays)."""
    if getattr(frame, "kp_packed_dev", None) is not None:
        return frame.kp_packed_dev
    n = frame.kp_uv.shape[0]
    kp = orb.Keypoints(
        uv=torch.as_tensor(frame.kp_uv, dtype=torch.float32, device=device),
        uv_level=torch.zeros((n, 2), device=device),
        level=torch.as_tensor(frame.kp_level, dtype=torch.int32, device=device),
        angle=torch.as_tensor(frame.kp_angle, dtype=torch.float32, device=device),
        score=torch.zeros(n, device=device),
        desc=desc_to_dev(frame.kp_desc, device),
        valid=torch.as_tensor(frame.kp_valid, dtype=torch.bool, device=device),
    )
    frame.kp_packed_dev = orb.pack_keypoints(kp)
    return frame.kp_packed_dev


def desc_to_dev(desc: np.ndarray, device) -> torch.Tensor:
    """Host uint32 descriptor words [N, 8] -> device int32 bits [N, 8]."""
    d = np.ascontiguousarray(desc, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(d.copy()).to(device)


def host_pyr(obj) -> Optional[np.ndarray]:
    """Materialize (once) and return the host mirror of a Frame/Keyframe
    packed pyramid; None when the object carries no pyramid."""
    if obj.pyr_data is None and obj.pyr_dev is not None:
        obj.pyr_data = obj.pyr_dev.cpu().numpy()
    return obj.pyr_data


def has_pyr(obj) -> bool:
    """Pyramid-existence check that does not force the host mirror."""
    return obj.pyr_shapes is not None


def check_device(device, what: str) -> torch.device:
    """The torch.device for `device`; a CUDA device without a GPU raises
    (nothing in the port falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}(device={str(device)!r}) needs a CUDA GPU and none is available")
    return dev


def build_frame(
    cfg: TextSLAMConfig,
    img,
    frame_id: int,
    timestamp: float,
    detections: Optional[List[TextDetection]] = None,
    n_features: Optional[int] = None,
    with_pyramid: bool = True,
    *,
    device,
) -> Frame:
    """Construct a Frame on `device` from an undistorted grayscale image
    (float32 [H, W]: a numpy array, or a tensor, which is used in place when
    it already lies on `device`)."""
    from ..utils.profiling import phase

    dev = check_device(device, "build_frame")
    if isinstance(img, torch.Tensor):
        imt = img.to(device=dev, dtype=torch.float32)
    else:
        imt = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    with phase("frame.orb"):
        kp = orb.extract_orb(
            imt,
            n_features=n_features or cfg.orb.n_features,
            n_levels=cfg.orb.n_levels,
            scale=cfg.orb.scale_factor,
            threshold=float(cfg.orb.fast_threshold_min),
        )
    pools = [kp]
    # in-box densification + boundary pruning of the text detections
    if detections and not cfg.no_text and cfg.orb.n_box_features > 0:
        with phase("frame.box_orb"):
            D = cfg.text.max_detections_per_frame
            quads = np.zeros((D, 4, 2), np.float32)
            qvalid = np.zeros(D, bool)
            for i, det in enumerate(detections[:D]):
                quads[i] = det.quad
                qvalid[i] = True
            pools.append(orb.extract_box_orb(
                imt, torch.as_tensor(quads, device=dev), torch.as_tensor(qvalid, device=dev),
                n_keep=cfg.orb.n_box_features,
                threshold=float(cfg.orb.fast_threshold_min),
                shrink=cfg.orb.box_boundary_margin,
            ))
    pyr_shapes = pyr_dev = None
    if with_pyramid and not cfg.no_text:
        with phase("frame.pyramid"):
            imgs, grads = pyramid.build_pyramid(imt, levels=max(cfg.pyramid.init_ba_levels) + 1)
            packed = pyramid.pack_pyramid(imgs, grads)
            pyr_dev, pyr_shapes = packed["data"], packed["shapes"]
    return Frame(
        frame_id=frame_id,
        timestamp=timestamp,
        shape=tuple(imt.shape),
        kp_packed_dev=orb.pack_keypoints(*pools),
        pyr_shapes=pyr_shapes,
        pyr_dev=pyr_dev,
        detections=list(detections or []),
    )

"""Data-parallel batched ORB extraction over a device mesh, port of
textslam_tpu/parallel/features.py: the frames of a batch are split over the
shards, each shard extracts its frames independently with ops.orb
(no reduction is needed), and the results come back with a leading batch
axis. With a process group, the processes' frames are gathered with one
all_gather."""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import orb
from .mesh import Mesh

# int32 columns of one packed keypoint: uv 2, uv_level 2, level 1, angle 1,
# score 1, valid 1, desc 8 (floats travel as their bits)
_COLS = (("uv", 2), ("uv_level", 2), ("level", 1), ("angle", 1), ("score", 1), ("valid", 1),
         ("desc", 8))


def _pack(kp: orb.Keypoints) -> torch.Tensor:
    cols = []
    for name, w in _COLS:
        x = getattr(kp, name).reshape(kp.uv.shape[0], w)
        if x.dtype == torch.float32:
            x = x.view(torch.int32)
        cols.append(x.to(torch.int32))
    return torch.cat(cols, dim=1)


def _unpack(packed: torch.Tensor) -> orb.Keypoints:
    """[..., N, 16] int32 -> Keypoints with the leading axes kept."""
    out, off = {}, 0
    ref = orb.Keypoints._fields
    for name, w in _COLS:
        x = packed[..., off:off + w].contiguous()
        off += w
        if name in ("uv", "uv_level", "angle", "score"):
            x = x.view(torch.float32)
        elif name == "valid":
            x = x.bool()
        if w == 1:
            x = x[..., 0]
        out[name] = x
    return orb.Keypoints(**{k: out[k] for k in ref})


def batched_extract(imgs: torch.Tensor, mesh: Mesh, n_features: int = 1000, n_levels: int = 8):
    """ORB keypoints of a batch of frames imgs [B, H, W], the frames split
    over the mesh's shards in contiguous blocks (B is padded to a multiple
    of the shard count with blank frames, which are dropped again).
    Returns a Keypoints whose fields have a leading batch axis [B, ...] on
    the mesh's home device, equal per frame to orb.extract_orb."""
    B = imgs.shape[0]
    n = mesh.size
    b = (B + n - 1) // n
    if b * n > B:
        imgs = torch.cat([imgs, imgs.new_zeros((b * n - B,) + tuple(imgs.shape[1:]))])
    local = []
    for s, d in mesh.local_shards():
        for im in imgs[s * b:(s + 1) * b]:
            kp = orb.extract_orb(im.to(d), n_features=n_features, n_levels=n_levels)
            local.append(_pack(kp).to(mesh.home))
    packed = torch.stack(local)
    if mesh.group is not None:
        gathered = [torch.empty_like(packed) for _ in range(mesh.world)]
        dist.all_gather(gathered, packed, group=mesh.group)
        packed = torch.cat(gathered)
    return _unpack(packed[:B])

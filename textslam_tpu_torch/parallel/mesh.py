"""A one-axis device mesh: the PyTorch counterpart of the JAX package's
`Mesh` + `shard_map` + `psum`.

JAX runs one controller over a list of devices, optionally spanning
processes (tests/multihost_worker.py: 2 processes x 4 devices form one
global mesh). Here a Mesh holds this process's local shards as a list of
devices and, optionally, a torch.distributed process group that joins the
processes. The global shard count is world_size x len(devices); local shard
i of rank r is global shard r * len(devices) + i. The same device may
repeat: two shards on one card are the counterpart of
--xla_force_host_platform_device_count on the CPU, and the only way to drive
the sharded path on a machine with one card.

A sharded computation runs its local shards one after another (PyTorch is
eager; on distinct cards their launches overlap, since each card has its
own stream), then `all_sum` reduces their partial results: local shards in
shard order on the home device, then one all_reduce across the group. The
group's backend is the caller's choice (gloo on the CPU, NCCL across GPUs).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


class Mesh:
    """Local shards `devices` (repeats allowed) and an optional process
    `group`; results are gathered on `home`, the first local device."""

    def __init__(self, devices: Sequence, group: Optional["dist.ProcessGroup"] = None):
        if not devices:
            raise ValueError("a Mesh needs at least one local device")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @property
    def size(self) -> int:
        """The global shard count."""
        return self.world * len(self.devices)

    def local_shards(self):
        """(global shard index, device) of each local shard, in order."""
        n = len(self.devices)
        return [(self.rank * n + i, d) for i, d in enumerate(self.devices)]

    def all_sum(self, parts: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        """Sum partial results over every shard of the mesh.

        parts[i] is local shard i's list of tensors (the same shapes on
        every shard). The tensors of each shard are packed into one flat
        float32 buffer, the local buffers summed on the home device in shard
        order (deterministic), then, with a group, reduced by ONE
        all_reduce(SUM). Returns the summed tensors, unpacked, on home."""
        shapes = [t.shape for t in parts[0]]
        flat = None
        for shard in parts:
            buf = torch.cat([t.reshape(-1).float() for t in shard]).to(self.home)
            flat = buf if flat is None else flat + buf
        if self.group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        out, off = [], 0
        for s in shapes:
            n = s.numel()
            out.append(flat[off: off + n].reshape(s))
            off += n
        return out


def make_mesh(n: int, device) -> Optional[Mesh]:
    """The mesh a config's `ba_devices` / `covis_devices` = n asks for on
    `device`, with the JAX package's cap: on CUDA, n = min(n, device count)
    distinct cards, starting at `device`'s (its home, so results land where
    the caller's tensors are) and going on in index order, wrapping; on the
    CPU, n shards on the CPU (the JAX test harness's virtual devices). No
    mesh (None) when n <= 1."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = min(n, count)
    if n <= 1:
        return None
    if dev.type != "cuda":
        return Mesh([dev] * n)
    first = torch.cuda.current_device() if dev.index is None else dev.index
    return Mesh([torch.device("cuda", (first + i) % count) for i in range(n)])

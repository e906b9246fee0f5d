"""A (data, coord) mesh of shards over torch.distributed — the port's
counterpart of jax.sharding.Mesh and of the collectives that
hal_tpu.parallel's shard_map steps use (psum, all_gather(tiled),
all_to_all(split_axis=0, concat_axis=0), axis_index).

Why a shard is not a rank.  NCCL refuses a communicator with two ranks on
one GPU, so D > 1 shards on one card cannot be D ranks.  The mesh follows
JAX's own model instead: P processes of a process group, each holding
L = D / P addressable local shards on its one device (what
hal_tpu.parallel.distributed.initialize(..., local_device_count) and
sharded.ensure_virtual_devices give the JAX package).  Shards are numbered
as JAX lays out devices.reshape(n_data, n_coord): shard k is (k // n_coord,
k % n_coord), and process p holds shards [p * L, (p + 1) * L).

The coord axis lies inside a process (L is a multiple of n_coord), so
every process holds every coord index, and the data axis is what spans
processes.  In every hal_tpu step the data-sharded inputs are replicated
over coord, so the coord replicas of a data shard hold equal values: the
steps compute each local data shard once, and the collectives below take
one value per local data index (`local_data`), stacked on a leading axis.
Among one process's shards a collective is a tensor operation on its
device (a sum, a cat, a transpose of the (src, dst) bucket axes); across
processes it is one torch.distributed call on `group` (NCCL on the card,
gloo on the CPU).  group None: one process, no torch.distributed call.
Each collective runs in a profiler range named mesh.<collective>, so a
trace shows the device time of the collectives, local and NCCL alike.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.profiler import record_function


class Mesh:
    """D = n_data * n_coord shards, L = D / P of them on this process's
    device."""

    def __init__(self, n_data: int, n_coord: int = 1, *, device, group=None):
        self.device = torch.device(device)
        self.group = group
        self.n_proc = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.shape = {"data": int(n_data), "coord": int(n_coord)}
        self.size = self.shape["data"] * self.shape["coord"]
        if self.size % self.n_proc:
            raise ValueError("%d shards do not divide over %d processes"
                             % (self.size, self.n_proc))
        self.n_local = self.size // self.n_proc
        if self.n_local % self.shape["coord"]:
            raise ValueError("the coord axis (%d) must lie within one "
                             "process's %d local shards"
                             % (self.shape["coord"], self.n_local))
        self.local_shards = range(self.rank * self.n_local,
                                  (self.rank + 1) * self.n_local)
        nd = self.n_local // self.shape["coord"]
        self.local_data = range(self.rank * nd, (self.rank + 1) * nd)

    def axis_index(self, shard: int, axis: str) -> int:
        """lax.axis_index of a shard along `axis`."""
        n_coord = self.shape["coord"]
        return shard // n_coord if axis == "data" else shard % n_coord

    def split(self, x: torch.Tensor, dim: int = 0) -> list:
        """This process's rows of a data-sharded array, cut into one equal
        block per local data index."""
        nd = len(self.local_data)
        if x.shape[dim] % nd:
            raise ValueError("%d rows do not divide over %d local data shards"
                             % (x.shape[dim], nd))
        return list(torch.chunk(x, nd, dim=dim)) if x.shape[dim] else [x] * nd

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """psum over 'data': x stacks one value per local data index; the
        sum over every data shard, on every process."""
        with record_function("mesh.psum"):
            s = x.sum(0)
            if self.group is not None:
                dist.all_reduce(s, group=self.group)
            return s

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """all_gather over 'data': x stacks one slab per local data index;
        returns (n_data, ...) in data order, on every process."""
        if self.group is None:
            return x
        with record_function("mesh.all_gather"):
            x = x.contiguous()
            out = [torch.empty_like(x) for _ in range(self.n_proc)]
            dist.all_gather(out, x, group=self.group)
            return torch.cat(out)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """all_to_all over 'data' (split_axis=0, concat_axis=0): x is
        (local src, n_data dst, ...), the bucket each local data shard
        sends to each data shard; returns (local dst, n_data src, ...),
        the buckets each local data shard receives."""
        nd = len(self.local_data)
        rest = tuple(x.shape[2:])
        with record_function("mesh.all_to_all"):
            # (dst process, local src, local dst, ...): a block a process
            y = x.reshape((nd, self.n_proc, nd) + rest).transpose(0, 1)
            if self.group is not None:
                y = y.contiguous()
                out = torch.empty_like(y)
                dist.all_to_all_single(out, y, group=self.group)
                y = out  # (src process, local src, local dst, ...)
            perm = (2, 0, 1) + tuple(range(3, y.dim()))
            return y.permute(perm).reshape((nd, self.n_proc * nd) + rest)

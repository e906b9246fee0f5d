"""Multi-process distribution over torch.distributed — the port of
hal_tpu.parallel.distributed.

Every process joins one process group (NCCL when its device is a CUDA
device, gloo on the CPU; the coordinator is a tcp:// address), query
batches are sharded over the global 'data' axis of a mesh whose shards
are spread over the processes (parallel.mesh: P processes, L local shards
each), reductions ride the collectives, and ordered outputs are merged
with a sorted-stream merge instead of file concatenation.

Entry points:
  * initialize(...)           — a process group for one process, destroyed
    when its `with` block ends
  * global_mesh(...)          — mesh over every process's local shards
  * shard_global_batch(...)   — this process's rows on its device
  * distributed_coverage(...) — the sharded liftover step with an exact
    per-position target coverage summed over every shard
  * merge_sorted_blocks(...)  — gather + k-way merge of per-process sorted
    block streams; every process returns the same array

One divergence: distributed_coverage indexes clipped coordinates in int64;
the JAX package casts them to int32 (ROADMAP §3.l).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from hal_tpu_torch.ops.segmap_torch import C_THI, C_TLO, C_VALID, _run_path
from hal_tpu_torch.parallel.mesh import Mesh


@contextlib.contextmanager
def initialize(coordinator: str, num_processes: int, process_id: int, *,
               device):
    """init_process_group for one process of a multi-process job: NCCL
    when `device` is a CUDA device, gloo when it is the CPU, rendezvous at
    tcp://<coordinator>.  Yields the group; the group is destroyed when the
    block ends.  A failed init raises.  The local shard count, which the
    original's local_device_count sets, is global_mesh's argument."""
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def global_mesh(group, local_shards: int, *, device) -> Mesh:
    """1-D 'data' mesh over every process's `local_shards` shards."""
    return Mesh(dist.get_world_size(group) * local_shards, 1, device=device,
                group=group)


def shard_global_batch(mesh: Mesh, arrays):
    """Each process passes ITS chunk (the global batch is the concatenation
    in process order, one block per local data shard); returns the chunks
    as tensors on mesh.device."""
    out = []
    for a in arrays:
        a = np.array(a)  # a copy: the caller's array may be read-only
        if len(a) % len(mesh.local_data):
            raise ValueError("%d rows do not divide over %d local data "
                             "shards" % (len(a), len(mesh.local_data)))
        out.append(torch.from_numpy(a).to(mesh.device))
    return tuple(out)


def distributed_coverage(path, caps, tgt_len: int, mesh: Mesh, lo, hi, owner):
    """Sharded step across processes: each shard maps its interval block
    through the genome path and scatter-adds an exact per-position target
    coverage (diff + cumsum, int64); one psum over 'data' merges across
    every shard and process.  Returns the coverage vector as numpy
    (identical on every process)."""
    d = torch.zeros(tgt_len + 1, dtype=torch.int64, device=mesh.device)
    for lo_i, hi_i, own_i in zip(*(mesh.split(x.to(path.dtype))
                                   for x in (lo, hi, owner))):
        F = _run_path(path, lo_i, hi_i, own_i, caps)[0]
        valid = (F[C_VALID] > 0).to(torch.int64)
        t0 = torch.clamp(F[C_TLO].to(torch.int64), 0, tgt_len)
        t1 = torch.clamp(F[C_THI].to(torch.int64), 0, tgt_len)
        d.index_add_(0, t0, valid).index_add_(0, t1, -valid)
    # the cumsum of the summed diffs is the sum of the shards' cumsums
    d = mesh.psum(d[None])
    return torch.cumsum(d, 0)[:tgt_len].cpu().numpy()


def merge_sorted_blocks(local_blocks: np.ndarray, *, device,
                        group=None) -> np.ndarray:
    """Globally merge per-process block streams sorted by their first
    column (e.g. reference-coordinate block starts): gather every
    process's row count, then its rows (padded to the largest count), then
    one k-way merge on the host.  Every process gets the same sorted array.
    group None: this process's blocks alone."""
    local_blocks = np.array(local_blocks)  # a copy: torch gets writable memory
    chunks = [local_blocks]
    if group is not None:
        n_proc = dist.get_world_size(group)
        t = torch.from_numpy(local_blocks).to(device)
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=device)
        sizes = [torch.zeros_like(n) for _ in range(n_proc)]
        dist.all_gather(sizes, n, group=group)
        sizes = [int(s.item()) for s in sizes]
        pad = max(sizes) - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        out = [torch.empty_like(t) for _ in range(n_proc)]
        dist.all_gather(out, t, group=group)
        chunks = [o[:k].cpu().numpy() for o, k in zip(out, sizes)]
    merged = np.concatenate(chunks, axis=0)
    if merged.ndim == 1:
        order = np.argsort(merged, kind="stable")
    else:
        order = np.lexsort(tuple(merged[:, k] for k in
                                 range(merged.shape[1] - 1, -1, -1)))
    return merged[order]

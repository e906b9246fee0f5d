"""Sharded liftover / depth steps over a mesh of shards — the port of
hal_tpu.parallel.sharded.

The canonical multi-device workload: a batch of query intervals is
sharded over the mesh's 'data' axis, each shard maps its rows through the
genome path (segmap_torch._run_path), computes a local coverage histogram
over the target coordinate space, and the histograms are summed across
'data' and sharded over 'coord'.  The table-sharded variant keeps each
level's segment tables resting 1/D per data shard and gathers one level
just before its hop (the level_xform hook of _run_path), then drops it.

Layouts are JAX's: a step takes this process's rows of the padded batch
(shard_batch) and returns F (8, n_local_data * cap), the local data shards'
fragment matrices stacked on the column axis (the whole (8, D * cap) at
one process), and the histogram in coord order.  The mesh and its
collectives are parallel.mesh; every tensor lives on mesh.device.

One divergence: the histogram bins in int64 (t_lo * n_bins // tgt_len);
the JAX package bins in the path's 32-bit dtype, whose product wraps
(ROADMAP §3.k).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from hal_tpu_torch.ops.segmap_torch import (C_THI, C_TLO, C_VALID, Level,
                                            PathData, _run_path,
                                            with_search_tables)
from hal_tpu_torch.parallel.mesh import Mesh


def make_mesh(n_data: int, n_coord: int = 1, *, device, group=None) -> Mesh:
    """A (n_data, n_coord) mesh; with group None all its shards are local
    shards of this process (the counterpart of ensure_virtual_devices'
    virtual devices)."""
    return Mesh(n_data, n_coord, device=device, group=group)


def coverage_histogram(F, tgt_len: int, n_bins: int) -> torch.Tensor:
    """int64 histogram over n_bins target bins of the valid fragments'
    target bases, each fragment binned by its t_lo."""
    valid = F[C_VALID] > 0
    t_lo = F[C_TLO].to(torch.int64)
    t_hi = F[C_THI].to(torch.int64)
    bin_of = torch.clamp(t_lo * n_bins // max(tgt_len, 1), 0, n_bins - 1)
    cov = torch.zeros(n_bins, dtype=torch.int64, device=F.device)
    return cov.index_add_(0, bin_of, torch.where(valid, t_hi - t_lo, 0))


def make_sharded_step(path: PathData, caps: tuple, tgt_len: int, n_bins: int,
                      mesh: Mesh):
    """Returns step(lo, hi, owner) -> (F (8, n_local_data * cap), the
    (n_bins,) coverage histogram summed over 'data'): replicated tables,
    queries sharded over 'data'."""
    n_coord = mesh.shape["coord"]
    if n_bins % n_coord:
        raise ValueError("n_bins %d is not a multiple of the coord axis %d"
                         % (n_bins, n_coord))

    def step(lo, hi, owner):
        Fs, covs = [], []
        for lo_i, hi_i, own_i in zip(*(mesh.split(x.to(path.dtype))
                                       for x in (lo, hi, owner))):
            F = _run_path(path, lo_i, hi_i, own_i, caps)[0]
            Fs.append(F)
            covs.append(coverage_histogram(F, tgt_len, n_bins))
        cov = mesh.psum(torch.stack(covs))
        # shard (i, j) keeps coord slice j of the sum: the slices in coord
        # order are the whole vector, which every process holds
        k = n_bins // n_coord
        cov = torch.cat([cov[j * k:(j + 1) * k] for j in range(n_coord)])
        return torch.cat(Fs, dim=1), cov

    return step


# ---------------------------------------------------------------------------
# table-sharded traversal: each level's tables rest 1/D per data shard and
# are gathered for the one hop that needs them, then dropped (the original's
# comment block, sharded.py:83-93)
# ---------------------------------------------------------------------------

def _pad_last(a: np.ndarray, mult: int, edge: bool):
    """Pad the last axis to a multiple of `mult` — repeating the edge value
    (sorted grids keep their searchsorted semantics: pad entries equal the
    end sentinel, which no in-range query ever reaches) or with zeros
    (gather-indexed tables: pad columns are only touched by masked-out
    slots)."""
    n = a.shape[-1]
    pad = (-n) % mult
    if pad == 0:
        return a
    widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return np.pad(a, widths, mode="edge" if edge else "constant")


def shard_path_tables(path: PathData, mesh: Mesh) -> PathData:
    """A PathData whose per-level tables are this process's data shards'
    slabs of them along the segment axis, stacked on a leading axis:
    grid (n_local_data, s), seg_table (n_local_data, 8, s), and so on, each
    table padded to a multiple of n_data first (_pad_last).  No shard
    holds more than ~1/D of a level's tables."""
    d = mesh.shape["data"]
    nd = len(mesh.local_data)
    first = mesh.local_data.start

    def put(x, edge):
        a = _pad_last(x.cpu().numpy(), d, edge)
        s = a.shape[-1] // d
        slabs = [a[..., (first + i) * s:(first + i + 1) * s] for i in range(nd)]
        return torch.from_numpy(np.stack(slabs)).to(mesh.device)

    def shard(level: Level) -> Level:
        return Level(kind=level.kind, grid=put(level.grid, True),
                     seg_table=put(level.seg_table, False),
                     ring_mem_tab=put(level.ring_mem_tab, False),
                     max_ring=level.max_ring,
                     page_tab=(None if level.page_tab is None
                               else put(level.page_tab, True)),
                     page_shift=level.page_shift, u32=level.u32)

    return replace(path, levels=tuple(shard(lv) for lv in path.levels),
                   para=tuple((shard(up), tuple(shard(dv) for dv in downs))
                              for (up, downs) in path.para),
                   device=mesh.device)


def gather_level(mesh: Mesh, level: Level) -> Level:
    """A table-sharded level gathered whole (all_gather over 'data',
    tiled), with the searchsorted kernel's tables rebuilt from the gathered
    grid: its lookups take the kernel, or the paged search, exactly as an
    unsharded level of that grid length would."""
    def g1(x):
        return mesh.all_gather(x).reshape(-1)

    def g2(x):
        y = mesh.all_gather(x)  # (n_data, fields, s)
        return y.transpose(0, 1).reshape(y.shape[1], -1)

    return with_search_tables(replace(
        level, grid=g1(level.grid), seg_table=g2(level.seg_table),
        ring_mem_tab=g2(level.ring_mem_tab),
        page_tab=None if level.page_tab is None else g1(level.page_tab)))


def make_table_sharded_step(path_sh: PathData, caps: tuple, mesh: Mesh):
    """Step over table-sharded PathData (shard_path_tables): queries shard
    over 'data'; each level's tables are gathered right before its
    split/hop and dropped after (the level_xform hook of _run_path).

    Returns step(lo, hi, owner) -> (F (8, n_local_data * cap), overflow
    flags (n_local_data,))."""
    def step(lo, hi, owner):
        Fs, ovfs = [], []
        for lo_i, hi_i, own_i in zip(*(mesh.split(x.to(path_sh.dtype))
                                       for x in (lo, hi, owner))):
            F, _bound, ovf, _lt = _run_path(
                path_sh, lo_i, hi_i, own_i, caps,
                level_xform=lambda lv: gather_level(mesh, lv))
            Fs.append(F)
            ovfs.append(ovf)
        return torch.cat(Fs, dim=1), torch.stack(ovfs)

    return step


def shard_batch(mesh: Mesh, lo: np.ndarray, hi: np.ndarray, owner: np.ndarray):
    """Pad a host batch to a multiple of the data-axis size (hi == lo:
    invalid rows, owner -1) and return this process's rows — its data
    shards' contiguous blocks — on mesh.device."""
    n_data = mesh.shape["data"]
    n = len(lo)
    pad = (-n) % n_data
    if pad:
        lo = np.concatenate([lo, np.zeros(pad, lo.dtype)])
        hi = np.concatenate([hi, np.zeros(pad, hi.dtype)])  # hi==lo -> invalid
        owner = np.concatenate([owner, np.full(pad, -1, owner.dtype)])
    per = len(lo) // n_data
    rows = slice(mesh.local_data.start * per, mesh.local_data.stop * per)
    return tuple(torch.from_numpy(np.array(a[rows])).to(mesh.device)
                 for a in (lo, hi, owner))

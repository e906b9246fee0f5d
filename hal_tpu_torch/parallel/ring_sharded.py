"""Shard-local table traversal — the port of hal_tpu.parallel.ring_sharded.

The memory-scaling variant of the table-sharded step: tables stay sharded
through the hop and the query fragments move instead.  Per level:

  1. split local fragments at the level's D-1 shard-boundary coordinates
     (a tiny replicated array), so every piece falls in exactly one
     shard's segment range (split_at),
  2. route each piece to its owning shard with ONE all_to_all over the
     mesh's data axis (bucketed fixed-capacity send buffers,
     overflow-flagged; route),
  3. hop against the LOCAL (fields, m/D) table slab — paralogy-ring
     expansion included; the ring member table is replicated (local_hop).

Peak memory per shard is (tables)/D + fragment buffers.  Capacities are
caller-chosen with overflow flags, as in the original.  The original's
module docstring gives the trade against the table-sharded step.

The step runs in int64, as its slabs are.  Each shard's slab is a
segmap_torch Level, so local_hop's segment lookups take the mapper's
dispatch: the searchsorted kernel (its tables built once per slab when the
step is made) for a slab of uint32-range coordinates within the kernel's
grid limit, which every path of fewer than 2^32 - 2 bases has.  split_at's
and route's searches of the D - 1 bounds are torch.searchsorted, as the
JAX package uses jnp.searchsorted there.  route's scatter drops
slot D * cap_send into a spare region that is cut off
(segmap_torch.spare_index), where the JAX package scatters with
mode="drop".
"""

from __future__ import annotations

import numpy as np
import torch

from hal_tpu_torch.ops.segmap_torch import (Level, _expand_owner, _lookup,
                                            spare_index, spare_width,
                                            with_search_tables)
from hal_tpu_torch.parallel.mesh import Mesh

_U32 = 0xFFFFFFFF


def _pad_to(a: np.ndarray, n: int, fill) -> np.ndarray:
    if a.shape[-1] >= n:
        return a[..., :n]
    pad = n - a.shape[-1]
    widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return np.pad(a, widths, constant_values=fill)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class RingLevel:
    """Host-built per-shard slabs for one traversal level (a copy of the
    original's, numpy; the level's tables may be torch tensors)."""

    def __init__(self, level, D: int):
        grid = _host(level.grid).astype(np.int64)          # m+1
        seg = _host(level.seg_table).astype(np.int64)      # (8, m)
        ring = _host(level.ring_mem_tab).astype(np.int64)  # (4, nnz)
        m = seg.shape[1]
        s = (m + D - 1) // D
        end = int(grid[-1]) if len(grid) else 0
        gridp = _pad_to(grid, D * s + 1, end)
        segp = _pad_to(seg, D * s, 0)  # has_link=0 on pad columns
        g_sh = np.stack([gridp[k * s:(k + 1) * s + 1] for k in range(D)])
        t_sh = np.stack([segp[:, k * s:(k + 1) * s] for k in range(D)])
        self.bounds = gridp[np.arange(1, D) * s].copy()  # (D-1,) replicated
        self.kind = level.kind
        self.max_ring = level.max_ring
        self.s = s
        self.grid_sh = g_sh
        self.seg_sh = t_sh
        # the ring member CSR table is REPLICATED: its offsets are indexed
        # through the (shuffled) child links, so contiguous per-shard slabs
        # do not exist; it is O(paralogous segments)
        self.ring_tab = ring if ring.shape[1] else np.zeros((4, 1), np.int64)


def build_ring_path(path, D: int):
    """Host prep: RingLevel per main-chain level of a PathData (the port's
    or any object with the same level attributes)."""
    if path.para:
        raise ValueError("ring-sharded traversal serves main-chain paths")
    return [RingLevel(lv, D) for lv in path.levels]


def shard_level(rl: RingLevel, k: int, ring, device) -> Level:
    """Shard k's slab of a RingLevel as a Level on the device: grid (s+1,),
    seg_table (8, s), the replicated ring table; u32 (the kernel's
    uint32-range entry) where the slab's coordinates fit."""
    grid = rl.grid_sh[k]
    return with_search_tables(Level(
        kind=rl.kind, grid=torch.from_numpy(grid).to(device),
        seg_table=torch.from_numpy(rl.seg_sh[k]).to(device),
        ring_mem_tab=ring, max_ring=rl.max_ring,
        u32=bool(grid.min() >= 0 and grid.max() < _U32)))


def split_at(values, F, cap_out: int):
    """Split fragment targets at a small sorted coordinate set so each
    piece lies within one shard's range."""
    dt = F.dtype
    nv = values.shape[0]
    valid = F[6] > 0
    i0 = torch.searchsorted(values, F[2].contiguous(), right=True).to(dt)
    i1 = torch.searchsorted(values, F[3].contiguous()).to(dt)
    counts = torch.where(valid, i1 - i0 + 1, 0)
    own, offs, total = _expand_owner(counts, cap_out)
    # only the rows the expansion reads (s_hi is re-derived, validity
    # re-computed)
    G = torch.stack([F[0], F[2], F[3], F[4], F[5], offs.to(dt), i0,
                     counts.to(dt)], dim=0)
    r_slo, r_tlo, r_thi, r_rev, r_own, r_offs, r_i0, r_cnt = \
        G.index_select(1, own.long())
    j = torch.arange(cap_out, dtype=dt, device=F.device)
    k = j - r_offs
    first = k == 0
    last = k == r_cnt - 1
    ci = r_i0 + k
    lo = torch.where(first, r_tlo, values[torch.clamp(ci - 1, 0, nv - 1)])
    hi = torch.where(last, r_thi, values[torch.clamp(ci, 0, nv - 1)])
    v = (j < total.to(dt)) & (hi > lo)
    adv = torch.where(r_rev > 0, r_thi - hi, lo - r_tlo)
    s_lo = r_slo + adv
    Fout = torch.stack([s_lo, s_lo + (hi - lo), lo, hi, r_rev, r_own,
                        v.to(dt), torch.zeros_like(s_lo)], dim=0)
    return Fout, total > cap_out


def route_buckets(F, bounds, D: int, cap_send: int):
    """Bucket fragments by destination shard: (D, 8, cap_send) send
    buckets, a stable sort by destination ranking each fragment in its
    bucket, and the overflow flag."""
    dt = F.dtype
    n = F.shape[1]
    dev = F.device
    valid = F[6] > 0
    dest = torch.searchsorted(bounds, F[2].contiguous(), right=True).to(
        torch.int32)
    dest = torch.where(valid, dest, D)
    dest_s, col_s = torch.sort(dest, stable=True)
    rank = (torch.arange(n, dtype=torch.int32, device=dev)
            - torch.searchsorted(dest_s, dest_s).to(torch.int32))
    keep = (dest_s < D) & (rank < cap_send)
    idx = spare_index(keep, dest_s.to(torch.int64) * cap_send + rank,
                      D * cap_send)
    buf = torch.zeros((8, D * cap_send + spare_width(n)), dtype=dt,
                      device=dev)
    buf.index_copy_(1, idx, F.index_select(1, col_s))
    ovf = torch.any((dest_s < D) & (rank >= cap_send))
    send = buf[:, :D * cap_send].reshape(8, D, cap_send).transpose(0, 1)
    return send, ovf


def local_hop(slab: Level, F, cap_hop: int, cap_ring: int):
    """Segment split + link hop against the LOCAL table slab."""
    dt = F.dtype
    dev = F.device
    seg = slab.seg_table  # (8, s)
    s = seg.shape[1]
    valid = F[6] > 0
    i0 = (_lookup(slab, F[2]) - 1).to(dt)
    i1 = (_lookup(slab, F[3] - 1) - 1).to(dt)
    i0 = torch.clamp(i0, 0, s - 1)
    i1 = torch.clamp(i1, 0, s - 1)
    counts = torch.where(valid & (i1 >= i0), i1 - i0 + 1, 0)
    own, offs, total = _expand_owner(counts, cap_hop)
    G = torch.cat([F[:6], offs[None, :].to(dt), i0[None, :]], dim=0)
    R = G.index_select(1, own.long())
    j = torch.arange(cap_hop, dtype=dt, device=dev)
    k = j - R[6]
    segi = torch.clamp(R[7] + k, 0, s - 1)
    ST = seg.index_select(1, segi.long())
    p_lo = torch.maximum(R[2], ST[0])
    p_hi = torch.minimum(R[3], ST[1])
    rev = R[4]
    adv = torch.where(rev > 0, R[3] - p_hi, p_lo - R[2])
    s_lo = R[0] + adv
    ln = p_hi - p_lo
    v = (j < total.to(dt)) & (p_hi > p_lo)
    has = v & (ST[4] > 0)
    ds = ST[2]
    off = p_lo - ST[0]
    mirrored = ST[1] - p_hi
    new_lo = torch.where(ST[3] > 0, ds + mirrored, ds + off)
    Fout = torch.stack([s_lo, s_lo + ln, new_lo, new_lo + ln, rev ^ ST[3],
                        R[5], has.to(dt), ds], dim=0)
    ovf = total > cap_hop
    if slab.kind == "down" and slab.max_ring > 0:
        ringtab = slab.ring_mem_tab  # replicated (4, nnz)
        rc = torch.where(has, ST[5], 0)
        ro = ST[6]
        own2, offs2, tot2 = _expand_owner(rc, cap_ring)
        off_row = Fout[2] - Fout[7]
        ln_row = Fout[3] - Fout[2]
        G2 = torch.cat([Fout[:2], off_row[None, :], ln_row[None, :],
                        Fout[4:6], offs2[None, :].to(dt), ro[None, :]], dim=0)
        R2 = G2.index_select(1, own2.long())
        j2 = torch.arange(cap_ring, dtype=dt, device=dev)
        k2 = j2 - R2[6]
        nnz = ringtab.shape[1]
        midx = torch.clamp(R2[7] + k2, 0, nnz - 1)
        MT = ringtab.index_select(1, midx.long())
        offm = R2[2]
        ln2 = R2[3]
        nlo = torch.where(MT[2] > 0, MT[1] - offm - ln2, MT[0] + offm)
        v2 = j2 < tot2.to(dt)
        F2 = torch.stack([R2[0], R2[1], nlo, nlo + ln2, R2[4] ^ MT[2],
                          R2[5], v2.to(dt), torch.zeros_like(nlo)], dim=0)
        Fout = torch.cat([Fout, F2], dim=1)
        ovf = ovf | (tot2 > cap_ring)
    return Fout, ovf


def make_ring_sharded_step(ring_levels, caps, mesh: Mesh):
    """Step over shard-local tables.

    caps: per level (cap_split, cap_send, cap_hop, cap_ring) — capacities
    for the boundary split, the per-destination all_to_all buckets, the
    local segment-split expansion, and the ring expansion (0 when the level
    has no rings).  Returns step(lo, hi, owner) -> (F (8, n_local_data *
    cols) fragments of the local data shards stacked on the column axis,
    overflow flags (n_local_data,))."""
    D = mesh.shape["data"]
    dev = mesh.device

    def level_arrays(rl):
        ring = torch.from_numpy(rl.ring_tab).to(dev)
        return dict(slabs=[shard_level(rl, k, ring, dev)
                           for k in mesh.local_data],
                    bounds=torch.from_numpy(rl.bounds).to(dev))

    arrays = [level_arrays(rl) for rl in ring_levels]

    def step(lo, hi, owner):
        Fs = []
        for lo_i, hi_i, own_i in zip(*(mesh.split(x.to(torch.int64))
                                       for x in (lo, hi, owner))):
            z = torch.zeros_like(lo_i)
            Fs.append(torch.stack([lo_i, hi_i, lo_i, hi_i, z, own_i,
                                   (hi_i > lo_i).to(torch.int64), z], dim=0))
        overflow = [torch.zeros((), dtype=torch.bool, device=dev) for _ in Fs]
        for arrs, cap in zip(arrays, caps):
            cap_split, cap_send, cap_hop, cap_ring = cap
            if D > 1:
                sends = []
                for i, F in enumerate(Fs):
                    Fsp, ov1 = split_at(arrs["bounds"], F, cap_split)
                    send, ov2 = route_buckets(Fsp, arrs["bounds"], D, cap_send)
                    sends.append(send)
                    overflow[i] = overflow[i] | ov1 | ov2
                recv = mesh.all_to_all(torch.stack(sends))  # (nd, D, 8, cap)
                Fs = [r.transpose(0, 1).reshape(8, D * cap_send).contiguous()
                      for r in recv]
            for i, F in enumerate(Fs):
                Fs[i], ov3 = local_hop(arrs["slabs"][i], F, cap_hop, cap_ring)
                overflow[i] = overflow[i] | ov3
        return torch.cat(Fs, dim=1), torch.stack(overflow)

    return step

"""Batched segment mapper in PyTorch — the port of hal_tpu.ops.segmap_jax.

The same fragment algebra with the same fixed-capacity contract: the tree
path (src -> mrca -> tgt) is unrolled on host into per-level tables
(PathData), every expansion writes into a capacity sized on host, and an
overflow flag comes back; the host wrappers (map_batch, BatchMapper)
double the capacities and rerun on overflow.  Fragment state is one
packed (8, cap) matrix, rows [s_lo, s_hi, t_lo, t_hi, rev, owner, valid,
aux], as in the JAX package, so both can be compared slot for slot.

The three Pallas kernels of the JAX package are hand-written CUDA kernels
here (hal_tpu_torch.ops.kernels): searchsorted over int32 and uint32-range
grids of at most _KERNEL_GRID_LIMIT segments, and the cumsum / cummax of
every expansion.  Everything XLA fused outside a Pallas kernel (column
gathers, the paged binary search, the sort, scatters and bit packing of
runs_packed) is plain torch.

Lookup dispatch.  Page tables are built, as in segmap_jax, for grids of
more than _PAGE_GRID_LIMIT (65,536) segments, so Levels equal the JAX
package's.  The searchsorted kernel takes every int32 or uint32-range grid
of at most _KERNEL_GRID_LIMIT segments (2,097,088: the top of its sector
B-tree fits a block's shared memory up to there), the bench-scale levels included; the
65,536 limit was the TPU kernel's (its compare-count grid must fit VMEM).
Larger grids and int64-coordinate paths keep the paged binary search, or
torch.searchsorted where no page table could be built.

Dtype rule.  Coordinates are int32 where the JAX package picks int32
(every genome length and segment count on the path below 2^31 - 2), and
int64 otherwise.  Where the JAX package picks uint32 (below 2^32 - 2) the
port holds the same values in int64 — torch has few uint32 operators — and
marks the Level `u32`: its grid is also kept as int32 under the
order-preserving 2^31 bias of segmap_jax's x ^ 2^31 (Level.grid_i32), which
the searchsorted kernel's uint32 entry searches with int64 queries biased
in registers, and the 32-bit run wire stays legal for the path.  Index math
(counts, offsets, owners of an expansion) is int32, as in _expand_owner.
u32 wraparound that runs_packed relies on is emulated in int64 with
& 0xFFFFFFFF.

Every entry point takes an explicit `device`; tensors of a path live on it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.ops import kernels
from hal_tpu_torch.ops import tables
from hal_tpu_torch.ops.tables import _PAGE_WINDOW

# packed fragment-state rows of the (8, cap) state matrix
C_SLO, C_SHI, C_TLO, C_THI, C_REV, C_OWN, C_VALID, C_AUX = range(8)

# grids of more than this many entries get a page table
# (segmap_jax._PALLAS_GRID_LIMIT)
_PAGE_GRID_LIMIT = 65536
# int32 / uint32-range grids up to this many entries take the searchsorted
# kernel; larger ones (and int64 paths) use the paged binary search
_KERNEL_GRID_LIMIT = kernels.SEARCH_GRID_LIMIT

_U32 = 0xFFFFFFFF
_BIAS = 1 << 31


@dataclass(frozen=True)
class Level:
    """One traversal level's device tensors (packed (fields, n) tables, as
    segmap_jax.Level).  u32: coordinates are int64 holding the values the
    JAX package keeps as uint32.  grid_i32, fences8, search_tree: what the
    searchsorted kernel searches (the grid itself when int32, its 2^31-
    biased int32 copy when u32) and kernels.search_tables of it; None where
    the kernel does not take the level."""

    kind: str  # 'up' | 'down'
    grid: torch.Tensor
    seg_table: torch.Tensor
    ring_mem_tab: torch.Tensor
    max_ring: int
    page_tab: torch.Tensor | None = None
    page_shift: int = 0
    u32: bool = False
    grid_i32: torch.Tensor | None = None
    fences8: torch.Tensor | None = None
    search_tree: torch.Tensor | None = None


def _level(kind, grid, seg_table, ring_mem_tab, max_ring, page_tab,
           page_shift, device) -> Level:
    """Level from numpy tables in the JAX package's dtypes (uint32 tables
    become int64 with u32 set)."""
    grid = np.asarray(grid)
    u32 = grid.dtype == np.uint32
    dt = np.int64 if (u32 or grid.dtype == np.int64) else np.int32

    def t(a, d):
        return torch.from_numpy(np.array(a, d)).to(device)

    return with_search_tables(Level(
        kind=str(kind), grid=t(grid, dt), seg_table=t(seg_table, dt),
        ring_mem_tab=t(ring_mem_tab, dt), max_ring=int(max_ring),
        page_tab=None if page_tab is None else t(page_tab, np.int32),
        page_shift=int(page_shift), u32=bool(u32)))


def with_search_tables(level: Level) -> Level:
    """The level with the searchsorted kernel's tables (grid_i32, fences8,
    search_tree) built from its grid, where the kernel takes a grid of that
    dtype and length; a level whose grid it does not take keeps None."""
    grid_i32 = f8 = tree = None
    if ((level.u32 or level.grid.dtype == torch.int32)
            and level.grid.shape[0] <= _KERNEL_GRID_LIMIT):
        grid_i32 = kernels.bias_u32(level.grid) if level.u32 else level.grid
        f8, tree = kernels.search_tables(grid_i32)
    return replace(level, grid_i32=grid_i32, fences8=f8, search_tree=tree)


@dataclass(frozen=True)
class PathData:
    levels: tuple
    n_up: int
    # paralogy branches above the MRCA: branch k = (up Level, down Levels)
    para: tuple = ()
    min_length: int = 0
    device: torch.device = torch.device("cpu")

    @property
    def dtype(self) -> torch.dtype:
        return self.levels[0].grid.dtype if self.levels else torch.int64

    @property
    def coord_kind(self) -> str:
        """The coordinate dtype the JAX package picks for this path."""
        if not self.levels:
            return "int64"
        if self.levels[0].u32:
            return "uint32"
        return "int32" if self.dtype == torch.int32 else "int64"

    @classmethod
    def build(cls, aln: Alignment, src: str, tgt: str, do_dupes: bool = True,
              dtype=None, coalescence_limit: str | None = None,
              min_length: int = 0, host_paralogies: bool = False, *,
              device, rings: tables.RingTables | None = None) -> "PathData":
        """dtype: the JAX package's coordinate dtype as numpy (np.int32,
        np.uint32 or np.int64); by default picked as segmap_jax does.

        rings: the caller's RingTables of `aln`, which every down level of
        the path, main and branch, reads; by default one of its own.

        host_paralogies: paralogy branch k expands rings only at its first
        down level (the paralogs of chain[k - 1]) and brings them down to
        the MRCA without rings, as segmap_host._map_paralogies does.  The
        default keeps segmap_jax's ring expansion at every down hop of a
        branch, which adds base pairs that map_source lacks once the chain
        above the MRCA holds three genomes (ROADMAP §3)."""
        device = torch.device(device)
        tree = aln.tree
        mrca = tree.lca(src, tgt)
        limit = coalescence_limit or mrca
        anc = mrca
        chain = [mrca]
        while anc != limit:
            anc = tree.parent(anc)
            if anc is None:
                raise ValueError("coalescence limit %s is not an ancestor of "
                                 "the MRCA %s" % (limit, mrca))
            chain.append(anc)
        nodes = set(tree.path(src, tgt)) | set(chain)
        if dtype is None:
            max_len = max(aln.open_genome(n).length for n in nodes)
            max_seg = max(max(aln.open_genome(n).num_top_segments,
                              aln.open_genome(n).num_bottom_segments)
                          for n in nodes)
            mx = max(max_len, max_seg)
            dtype = (np.int32 if mx < 2 ** 31 - 2 else
                     np.uint32 if mx < 2 ** 32 - 2 else np.int64)

        def up_level(cur: str) -> Level:
            return build_up_level(aln, cur, dtype, device=device)

        if rings is None:
            rings = tables.RingTables(aln)

        def down_level(cur: str, nxt: str, with_rings: bool) -> Level:
            return build_down_level(aln, cur, nxt,
                                    rings if with_rings else None, dtype,
                                    device=device)

        levels = []
        cur = src
        while cur != mrca:
            levels.append(up_level(cur))
            cur = tree.parent(cur)
        n_up = len(levels)
        if cur != tgt:
            for nxt in tree.path(cur, tgt)[1:]:
                levels.append(down_level(cur, nxt, do_dupes))
                cur = nxt

        para = []
        if do_dupes and limit != mrca:
            for k in range(1, len(chain)):
                up = up_level(chain[k - 1])
                downs = tuple(down_level(chain[j + 1], chain[j],
                                         j == k - 1 or not host_paralogies)
                              for j in range(k - 1, -1, -1))
                para.append((up, downs))
        return cls(levels=tuple(levels), n_up=n_up, para=tuple(para),
                   min_length=int(min_length), device=device)

    @classmethod
    def from_numpy(cls, levels, n_up: int, para=(), min_length: int = 0, *,
                   device) -> "PathData":
        """PathData from another package's level tables: each level is any
        object with attributes kind, grid, seg_table, ring_mem_tab,
        max_ring, page_tab, page_shift whose arrays np.asarray accepts
        (segmap_jax.Level included); para is ((up, (down, ...)), ...)."""
        device = torch.device(device)

        def conv(lv):
            pt = lv.page_tab
            return _level(lv.kind, np.asarray(lv.grid), np.asarray(lv.seg_table),
                          np.asarray(lv.ring_mem_tab), lv.max_ring,
                          None if pt is None else np.asarray(pt),
                          lv.page_shift, device)

        return cls(levels=tuple(conv(lv) for lv in levels), n_up=int(n_up),
                   para=tuple((conv(up), tuple(conv(d) for d in downs))
                              for up, downs in para),
                   min_length=int(min_length), device=device)


def _pages(starts):
    return ((None, 0) if len(starts) <= _PAGE_GRID_LIMIT
            else tables._build_page_table(starts))


def build_up_level(aln: Alignment, cur: str, dtype,
                   canonical_only: bool = False, *, device) -> Level:
    """canonical_only: only segments whose parent's child link points back
    hop up (the noDupes gate, segmap_jax.build_up_level)."""
    g = aln.open_genome(cur)
    parent = aln.tree.parent(cur)
    pg = aln.open_genome(parent)
    n_seg = g.num_top_segments
    np_dtype = tables._np_dtype_of(dtype)
    z0 = np.zeros(0, np.int64)
    pt, ps = _pages(g.top_start)
    link = np.asarray(g.top_parent[:n_seg], np.int64).copy()
    if canonical_only and n_seg:
        slot = aln.tree.child_index(parent, cur)
        pi = np.clip(link, 0, max(pg.num_bottom_segments - 1, 0))
        back = (pg.bot_child[pi, slot] if pg.num_bottom_segments
                else np.full(n_seg, NULL_INDEX))
        canon = (link != NULL_INDEX) & (back == np.arange(n_seg))
        link = np.where(canon, link, NULL_INDEX)
    return _level(
        "up", np.asarray(g.top_start).astype(np_dtype),
        tables._seg_tab(np_dtype, g.top_start, link,
                        g.top_parent_reversed[:n_seg],
                        pg.bot_start[:pg.num_bottom_segments], z0, z0),
        tables._pack4(np_dtype, np.zeros(0, np.int64)), 0, pt, ps, device)


def _ring_mem_tab(np_dtype, top_start, ring: tables.RingCSR):
    """The packed [start, next, flip] of each ring member."""
    mem = ring.rm
    return tables._pack4(np_dtype,
                         top_start[mem] if len(mem) else mem,
                         top_start[mem + 1] if len(mem) else mem,
                         ring.rf.astype(np.int64))


def build_down_level(aln: Alignment, cur: str, nxt: str,
                     rings: tables.RingTables | None, dtype, *,
                     device) -> Level:
    """rings: where `nxt`'s paralogy rings come from; None expands none."""
    g = aln.open_genome(cur)
    cg = aln.open_genome(nxt)
    slot = aln.tree.child_index(cur, nxt)
    n_seg = g.num_bottom_segments
    nd = cg.num_top_segments
    np_dtype = tables._np_dtype_of(dtype)
    ring = rings[nxt] if rings is not None else tables.RingCSR.empty(nd)
    link = (g.bot_child[:n_seg, slot] if n_seg
            else np.zeros(0, np.int64))
    lrev = (g.bot_child_reversed[:n_seg, slot].astype(np.int64)
            if n_seg else np.zeros(0, np.int64))
    pt, ps = _pages(g.bot_start)
    return _level(
        "down", np.asarray(g.bot_start).astype(np_dtype),
        tables._seg_tab(np_dtype, g.bot_start, link, lrev,
                        cg.top_start[:nd], ring.rc[:nd], ring.ro[:nd]),
        _ring_mem_tab(np_dtype, cg.top_start, ring),
        ring.max_ring, pt, ps, device)


def build_selfring_level(aln: Alignment, cur: str,
                         rings: tables.RingTables, dtype, *,
                         device) -> Level:
    """Self-ring level of the column engine (ops.column_torch): split
    fragments at `cur`'s TOP grid, identity link (dst = own segment), ring
    CSR (rings[cur]) keyed by the fragment's OWN top segment — the
    reference's toNextParalogy walk from the segment itself
    (halColumnIterator.cpp:642-682 updateNextTopDup).  The caller drops
    the pass-through base fragments after the expansion (members only)."""
    g = aln.open_genome(cur)
    nt = g.num_top_segments
    np_dtype = tables._np_dtype_of(dtype)
    ring = rings[cur]
    pt, ps = _pages(g.top_start)
    return _level(
        "down", np.asarray(g.top_start).astype(np_dtype),
        tables._seg_tab(np_dtype, g.top_start, np.arange(nt, dtype=np.int64),
                        np.zeros(nt, np.int64), g.top_start[:nt],
                        ring.rc[:nt], ring.ro[:nt]),
        _ring_mem_tab(np_dtype, g.top_start, ring),
        ring.max_ring, pt, ps, device)


# --------------------------------------------------------------------------
# fixed-capacity building blocks
# --------------------------------------------------------------------------

def _searchsorted_right(grid, q, page_tab=None, page_shift=0, u32=False,
                        grid_i32=None, tables=None):
    """searchsorted(grid, q, side='right') in q's dtype, by the dispatch of
    the module docstring.  grid_i32 / tables: the Level's cached kernel
    tables (built here when absent)."""
    if grid.shape[0] <= _KERNEL_GRID_LIMIT:
        if u32:
            # queries outside [0, 2^32) only occur in masked slots
            if grid_i32 is None:
                grid_i32 = kernels.bias_u32(grid)
            return kernels.searchsorted_right_u32(grid_i32, q, tables)
        if grid.dtype == torch.int32 and q.dtype == torch.int32:
            return kernels.searchsorted_right(grid, q, tables)
    if page_tab is None:
        return torch.searchsorted(grid, q, right=True).to(q.dtype)
    return _paged_searchsorted(grid, q, page_tab, page_shift)


def _lookup(level: Level, q):
    tables = None if level.fences8 is None else (level.fences8,
                                                 level.search_tree)
    return _searchsorted_right(level.grid, q, level.page_tab,
                               level.page_shift, level.u32, level.grid_i32,
                               tables)


def _paged_searchsorted(grid, q, page_tab, page_shift):
    """Page-table hop + unrolled binary search over the page window (plain
    torch); equals searchsorted_right(grid, q) for in-range q
    (0 <= q < end)."""
    n = grid.shape[0]
    page = torch.clamp(q >> page_shift, 0, page_tab.shape[0] - 1)
    i = page_tab[page.long()].to(q.dtype)
    step = _PAGE_WINDOW >> 1
    while step:
        j = torch.clamp(i + step, max=n - 1)
        i = torch.where(grid[j.long()] <= q, j, i)
        step >>= 1
    return i + 1


def _expand_owner(counts, cap_out):
    """own[j] = index i of the input owning output slot j, for the dense
    expansion where input i owns counts[i] consecutive slots: scatter-max
    an input-index mark at each segment start, then cummax.  Returns
    (own int32, offsets int32, total int32)."""
    if counts.dtype != torch.int32:
        counts = counts.to(torch.int32)
    offsets = kernels.cumsum_i32(counts) - counts
    total = offsets[-1] + counts[-1]
    n = counts.shape[0]
    # marks past the capacity land in one spare slot that is cut off
    idx = torch.where((counts > 0) & (offsets < cap_out), offsets, cap_out)
    marks = torch.zeros(cap_out + 1, dtype=torch.int32, device=counts.device)
    marks.scatter_reduce_(0, idx.long(),
                          torch.arange(n, dtype=torch.int32,
                                       device=counts.device), reduce="amax")
    own = kernels.cummax_i32(marks[:cap_out])
    return own, offsets, total


def _split_hop(level: Level, F, cap_out, min_length: int = 0):
    """Split fragment targets at this level's segment grid, then hop each
    piece across the link.  Returns the hopped state (8, cap_out) with
    C_AUX = destination segment start, per-slot ring counts and CSR
    offsets, the split total and the overflow flag."""
    dt = F.dtype
    dev = F.device
    m = level.seg_table.shape[1]
    t_lo = F[C_TLO]
    t_hi = F[C_THI]
    valid = F[C_VALID] > 0
    i0 = _lookup(level, t_lo) - 1
    i1 = _lookup(level, t_hi - 1) - 1
    counts = torch.where(valid & (i1 >= i0), i1 - i0 + 1, 0)
    own, offsets, total = _expand_owner(counts, cap_out)
    # gather-once source matrix: [s_lo, s_hi, t_lo, t_hi, rev, owner, offset, i0]
    G = torch.cat([F[:6], offsets[None, :].to(dt), i0[None, :]], dim=0)
    R = G.index_select(1, own.long())
    j = torch.arange(cap_out, dtype=dt, device=dev)
    k = j - R[6]
    seg = torch.clamp(R[7] + k, 0, m - 1)
    # [start, next, dst_start, lrev, has_link, ring_count, ring_offset]
    ST = level.seg_table.index_select(1, seg.long())
    p_lo = torch.maximum(R[C_TLO], ST[0])
    p_hi = torch.minimum(R[C_THI], ST[1])
    rev = R[C_REV]
    adv = torch.where(rev > 0, R[C_THI] - p_hi, p_lo - R[C_TLO])
    s_lo = R[C_SLO] + adv
    ln = p_hi - p_lo
    in_range = j < total.to(dt)
    v = in_range & (p_hi > p_lo) & (ln >= max(min_length, 1))
    lrev = ST[3]
    has = v & (ST[4] > 0)
    ds = ST[2]
    off = p_lo - ST[0]
    mirrored = ST[1] - p_hi
    new_lo = torch.where(lrev > 0, ds + mirrored, ds + off)
    new_rev = rev ^ lrev
    Fout = torch.stack(
        [s_lo, s_lo + ln, new_lo, new_lo + ln, new_rev, R[C_OWN],
         has.to(dt), ds], dim=0)
    ring_counts = torch.where(has, ST[5], 0)
    ring_offsets = ST[6]
    return Fout, ring_counts, ring_offsets, total, total > cap_out


def _ring_expand(level: Level, F, ring_counts, ring_offsets, cap_out):
    """Append all paralogy-ring members via one CSR expansion.  F's C_AUX
    row holds the destination segment start from the hop."""
    dt = F.dtype
    own, offsets, total = _expand_owner(ring_counts, cap_out)
    off_row = F[C_TLO] - F[C_AUX]
    ln_row = F[C_THI] - F[C_TLO]
    G = torch.cat(
        [F[:2], off_row[None, :], ln_row[None, :], F[4:6],
         offsets[None, :].to(dt), ring_offsets[None, :]], dim=0)
    R = G.index_select(1, own.long())
    j = torch.arange(cap_out, dtype=dt, device=F.device)
    k = j - R[6]
    nnz = max(level.ring_mem_tab.shape[1], 1)
    midx = torch.clamp(R[7] + k, 0, nnz - 1)
    MT = level.ring_mem_tab.index_select(1, midx.long())  # [start, next, flip]
    offm = R[2]
    ln = R[3]
    flip = MT[2]
    nlo = torch.where(flip > 0, MT[1] - offm - ln, MT[0] + offm)
    v = j < total.to(dt)
    F2 = torch.stack(
        [R[0], R[1], nlo, nlo + ln, R[4] ^ flip, R[5], v.to(dt),
         torch.zeros_like(nlo)], dim=0)
    return torch.cat([F, F2], dim=1), total, total > cap_out


# the most slots of a scatter's spare region
SPARE = 1 << 16


def spare_width(n_rows: int) -> int:
    """Slots of the spare region behind a scatter of n_rows rows (a power
    of two)."""
    return min(SPARE, tables._next_pow2(n_rows))


def spare_index(keep, idx, n_kept: int):
    """idx where keep, else the slot n_kept + (row index mod
    spare_width(rows)) of a spare region that the caller allocates past
    its n_kept slots and cuts off (int64).  It stands for the JAX
    package's mode="drop" and zero-valued scatters: consecutive dropped
    rows write consecutive spare slots, so no address takes a write from
    every dropped row, as one shared spare slot would."""
    j = torch.arange(idx.shape[0], dtype=torch.int64, device=idx.device)
    w = spare_width(idx.shape[0])
    return torch.where(keep, idx.to(torch.int64), n_kept + (j & (w - 1)))


def _final_bound(F):
    """Last-valid bound: the host copies F[:, :bound] and filters by the
    valid row."""
    valid = F[C_VALID] > 0
    idx = torch.arange(valid.shape[0], dtype=torch.int32, device=F.device)
    return torch.max(torch.where(valid, idx + 1, 0))


# the most distinct values _OrderKey's mixed-radix key may span
_KEY_LIMIT = 1 << 62


def _parents_as_owner(F):
    """F with its owner row replaced by the column index, so that the owner
    row of what _split_hop or _ring_expand makes of it names each output
    column's parent column."""
    F = F.clone()
    F[C_OWN] = torch.arange(F.shape[1], dtype=F.dtype, device=F.device)
    return F


class _OrderKey:
    """_run_path's order hook: an int64 order key per column, so that one
    owner's valid columns, stable-sorted by key, come in map_source's order
    before its final dedup and atomize (paths without paralogy branches).

    Why: map_source lists a fragment's split pieces in place (parent-
    major), as the device does, but its paralog_expand lists every
    original, then every ring's first members, then the second ones (step-
    major), where _ring_expand appends each piece's members after all the
    originals.  Its per-level dedup keeps first occurrences, which commutes
    with both expansions.  So its order is the lexicographic order of
    (s_m, ..., s_1, device order), s_l being a column's step at the l-th
    ring level (0 for an original, k + 1 for its ring's k-th CSR member,
    the ring walk's order).  The key packs the steps in mixed radix, the
    last ring level most significant, and is re-ranked densely before the
    product of radices would pass _KEY_LIMIT.

    Before each hop the owner row holds the parent column indices; after
    it the hook gathers the owners and keys through them."""

    def __init__(self, owner):
        self.own = owner.to(torch.int64)
        self.key = torch.zeros_like(self.own)
        self.radix = 1

    def split(self, F):
        par = F[C_OWN].long()
        self.own, self.key = self.own[par], self.key[par]

    def ring(self, level, F, ring_counts, split_cap, ring_cap):
        par = F[C_OWN, split_cap:].long()
        rc = ring_counts.to(torch.int32)
        first = (kernels.cumsum_i32(rc) - rc).to(torch.int64)
        step = torch.arange(1, ring_cap + 1, dtype=torch.int64,
                            device=F.device) - first[par]
        if self.radix > _KEY_LIMIT // level.max_ring:
            self.key = torch.unique(self.key, return_inverse=True)[1]
            self.radix = (int(self.key.max().item()) + 1
                          if self.key.numel() else 1)
        self.own = torch.cat([self.own, self.own[par]])
        self.key = torch.cat([self.key, self.key[par] + step * self.radix])
        self.radix *= level.max_ring


def _run_path(path: PathData, lo, hi, owner, caps, level_xform=None,
              order: _OrderKey | None = None):
    """Run the whole path; returns the packed (8, cap) fragment matrix, the
    last-valid bound, the overflow flag and per-level (split, ring) totals.
    caps is consumed in traversal order, as segmap_jax._run_path.

    level_xform: optional Level -> Level hook applied as each level is
    consumed; the table-sharded step (parallel.sharded) gathers a level's
    tables with it right before the hop.

    order: an _OrderKey(owner) that follows every hop; its key then
    orders each owner's columns as map_source does (BatchMapper.dispatch(
    ordered=True)).  Paths with paralogy branches refuse it."""
    if order is not None and path.para:
        raise ValueError("map_source's fragment order is not reproduced on "
                         "a path with paralogy branches (a coalescence "
                         "limit above the MRCA)")
    n = lo.shape[0]
    dt = lo.dtype
    ml = path.min_length
    z = torch.zeros(n, dtype=dt, device=lo.device)
    F = torch.stack([lo, hi, lo, hi, z, owner, (hi > lo).to(dt), z], dim=0)
    overflow = torch.zeros((), dtype=torch.bool, device=lo.device)
    level_totals = []
    caps = list(caps)
    cap_i = 0

    def next_cap():
        nonlocal cap_i
        c = caps[cap_i]
        cap_i += 1
        return c if isinstance(c, tuple) else (c, c)

    def apply_level(level, F):
        nonlocal overflow
        if level_xform is not None:
            level = level_xform(level)
        split_cap, ring_cap = next_cap()
        if order is not None:
            F = _parents_as_owner(F)
        F, ring_counts, ring_offsets, stot, ov1 = _split_hop(level, F,
                                                             split_cap, ml)
        overflow = overflow | ov1
        if order is not None:
            order.split(F)
        rv = torch.zeros((), dtype=torch.int32, device=F.device)
        if level.kind == "down" and level.max_ring > 0:
            if order is not None:
                F = _parents_as_owner(F)
            F, rtot, ov2 = _ring_expand(level, F, ring_counts, ring_offsets,
                                        ring_cap)
            overflow = overflow | ov2
            rv = rtot.to(torch.int32)
            if order is not None:
                order.ring(level, F, ring_counts, split_cap, ring_cap)
        level_totals.append(torch.stack([stot.to(torch.int32), rv]))
        return F

    for level in path.levels[:path.n_up]:
        F = apply_level(level, F)

    if path.para:
        branches = [F]
        G = F
        for (up, downs) in path.para:
            G = apply_level(up, G)
            H = G
            for dlv in downs:
                H = apply_level(dlv, H)
            branches.append(H)
        F = torch.cat(branches, dim=1)

    for level in path.levels[path.n_up:]:
        F = apply_level(level, F)

    if order is not None:
        F[C_OWN] = order.own.to(dt)
    bound = _final_bound(F)
    return F, bound, overflow, (
        torch.stack(level_totals) if level_totals
        else torch.zeros((0, 2), dtype=torch.int32, device=lo.device))


def start_cap_mult(genome, lo, hi) -> int:
    """The batched mapper's starting capacity multiple for intervals
    [lo, hi) of the source genome: 4 (its default) for short intervals;
    for long ones (whole sequences, 2^20-base windows), twice the source
    segments they cover, so that the first level fits without a run of
    doubling retries (_decode gives up at 4,096 times the batch from the
    default start)."""
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    covered = 0
    for starts in (genome.top_start, genome.bot_start):
        if len(starts) > 1:
            n = (np.searchsorted(starts, hi, side="left")
                 - np.searchsorted(starts, lo, side="right") + 1)
            covered = max(covered, int(n.sum()))
    need = -(-2 * covered // max(len(lo), 16))
    return max(4, 1 << max(need - 1, 0).bit_length())


def _mult_caps(path: PathData, n: int, mult: int):
    """Capacities n*mult (pow2) per level, rings min(max_ring, 4) times
    that — the map_batch / BatchMapper sizing of segmap_jax."""
    base = max(n, 16)

    def cap_for(level):
        c = tables._next_pow2(base * mult)
        if level.kind == "down" and level.max_ring:
            return (int(c), tables._next_pow2(c * min(level.max_ring, 4)))
        return int(c)

    caps = [cap_for(lv) for lv in path.levels[:path.n_up]]
    for (up, downs) in path.para:
        caps.append(cap_for(up))
        caps.extend(cap_for(d) for d in downs)
    caps.extend(cap_for(lv) for lv in path.levels[path.n_up:])
    return tuple(caps)


def coords(path: PathData, x) -> torch.Tensor:
    """Host coordinates -> the path's coordinate tensor on its device."""
    np_dt = np.int32 if path.dtype == torch.int32 else np.int64
    return torch.from_numpy(np.asarray(x).astype(np_dt)).to(path.device)


def _fragments(F, bound, key=None):
    """Valid columns of F[:, :bound] as int64 numpy rows (s_lo, s_hi, t_lo,
    t_hi, rev, owner); with an _OrderKey's key, stable-sorted by (owner,
    key) on F's device."""
    k = int(bound.item())
    if key is None:
        M = F[:, :k].cpu().numpy().astype(np.int64)
        M = M[:, M[C_VALID].astype(bool)]
    else:
        cols = torch.nonzero(F[C_VALID, :k] > 0).flatten()
        cols = cols[torch.sort(key[cols], stable=True).indices]
        cols = cols[torch.sort(F[C_OWN, cols], stable=True).indices]
        M = F[:, cols].cpu().numpy().astype(np.int64)
    return (M[C_SLO], M[C_SHI], M[C_TLO], M[C_THI], M[C_REV], M[C_OWN])


def _run_batch(path: PathData, lo_d, hi_d, own, mult: int, ordered: bool):
    """One _run_path of a batch at capacity multiple mult: (F, bound,
    overflow, order key or None)."""
    order = _OrderKey(own) if ordered else None
    F, bound, ovf, _lt = _run_path(path, lo_d, hi_d, own,
                                   _mult_caps(path, int(lo_d.shape[0]), mult),
                                   order=order)
    return F, bound, ovf, None if order is None else order.key


def _dispatch(path: PathData, lo, hi, owner=None, cap_mult: int = 4,
              ordered: bool = False):
    """Queue the device work for one batch; returns a pending handle."""
    lo_d = coords(path, lo)
    hi_d = coords(path, hi)
    n = int(lo_d.shape[0])
    own = (torch.arange(n, dtype=path.dtype, device=path.device)
           if owner is None else coords(path, owner))
    return (*_run_batch(path, lo_d, hi_d, own, cap_mult, ordered),
            lo_d, hi_d, own, cap_mult, ordered)


def _decode(path: PathData, pend):
    """Wait for one pending batch; on capacity overflow rerun THAT batch
    with doubled capacity.  Returns numpy int64 (src_lo, src_hi, tgt_lo,
    tgt_hi, rev, owner) of the valid fragments (an ordered batch's sorted
    by owner, each owner's in map_source's order).  The capacity may grow
    to 4096 times the batch, or 1024 times a larger starting multiple."""
    F, bound, ovf, key, lo_d, hi_d, own, mult, ordered = pend
    top = max(4096, mult << 10)
    while bool(ovf.item()):
        mult *= 2
        if mult > top:
            raise RuntimeError("segment-map capacity blowup")
        F, bound, ovf, key = _run_batch(path, lo_d, hi_d, own, mult, ordered)
    return _fragments(F, bound, key)


class BatchMapper:
    """Dispatch/decode split of map_batch for pipelined batch streams: the
    caller dispatches batch k+1 before decoding batch k, so the host work
    on batch k overlaps the device's work on batch k+1."""

    def __init__(self, aln: Alignment, src: str, tgt: str,
                 do_dupes: bool = True, coalescence_limit: str | None = None,
                 min_length: int = 0, host_paralogies: bool = False, *,
                 device):
        self.path = PathData.build(aln, src, tgt, do_dupes=do_dupes,
                                   coalescence_limit=coalescence_limit,
                                   min_length=min_length,
                                   host_paralogies=host_paralogies,
                                   device=device)
        self.dtype = self.path.dtype

    def dispatch(self, lo, hi, owner=None, cap_mult: int = 4,
                 ordered: bool = False):
        """ordered: decode returns the fragments sorted by owner, each
        owner's in map_source's order before its atomize, duplicates
        included (_run_path's _OrderKey hook; paths without paralogy
        branches)."""
        return _dispatch(self.path, lo, hi, owner, cap_mult, ordered)

    def decode(self, pend):
        return _decode(self.path, pend)


def map_batch(path: PathData, lo, hi, owner=None, cap_mult: int = 4):
    """Run the path, growing capacity on overflow.  Returns numpy
    (src_lo, src_hi, tgt_lo, tgt_hi, rev, owner) of valid fragments
    (un-atomized, un-deduped)."""
    return _decode(path, _dispatch(path, lo, hi, owner, cap_mult))


# --------------------------------------------------------------------------
# compaction programs (segmap_jax._compact_jit, _compact_packed_jit,
# _compact_u32_fixed_jit); nothing on the main path calls them.  Their
# slots and scatter are also column_torch._program_body's compaction.
# --------------------------------------------------------------------------

def _compact_slots(F, n_out: int):
    """(slot index per column, valid total) of a scatter-compaction of F's
    valid columns into n_out slots: a valid column's slot is its rank
    among the valid ones (the prefix sum on kernels.cumsum_i32); the rest,
    and ranks past n_out, go to a spare region past n_out (spare_index)."""
    valid = F[C_VALID] > 0
    if valid.shape[0] == 0:
        z = torch.zeros(0, dtype=torch.int64, device=F.device)
        return z, torch.zeros((), dtype=torch.int32, device=F.device)
    pos = kernels.cumsum_i32(valid.to(torch.int32)) - 1
    total = pos[-1] + 1
    return spare_index(valid & (pos < n_out), pos, n_out), total


def _scatter_cols(rows, idx, n_out: int):
    """rows (r, c) scattered to columns idx of a zero (r, n_out + spare)
    matrix, cut to n_out columns."""
    out = rows.new_zeros((rows.shape[0], n_out + spare_width(rows.shape[1])))
    out.index_copy_(1, idx, rows)
    return out[:, :n_out]


def compact(F):
    """segmap_jax._compact_jit: F's valid columns scatter-compacted to the
    front of a (6, cap) matrix (the valid and aux rows dropped) and the
    valid count (int32)."""
    idx, total = _compact_slots(F, F.shape[1])
    return _scatter_cols(F[:6], idx, F.shape[1]), total


def compact_packed(F):
    """segmap_jax._compact_packed_jit: (coords (2, cap) [s_lo, t_lo] in F's
    dtype, meta (3, cap) int32 [len, rev, owner], count).  Reconstruct
    with s_hi = s_lo + len, t_hi = t_lo + len."""
    idx, total = _compact_slots(F, F.shape[1])
    coords = torch.stack([F[C_SLO], F[C_TLO]], dim=0)
    meta = torch.stack([F[C_SHI] - F[C_SLO], F[C_REV], F[C_OWN]],
                       dim=0).to(torch.int32)
    return (_scatter_cols(coords, idx, F.shape[1]),
            _scatter_cols(meta, idx, F.shape[1]), total)


def compact_u32_fixed(F, out_cols: int, len_bits: int):
    """segmap_jax._compact_u32_fixed_jit: three u32 rows [s_lo, t_lo,
    owner << (len_bits + 1) | len << 1 | rev] of the valid columns
    compacted into a static (3, out_cols) matrix, as int32 bit patterns
    (wire_to_host gives the JAX package's np.uint32), plus the count and
    the overflow flag (more than out_cols rows, or a row whose len or owner
    the packing cannot hold).  u32 arithmetic is emulated in int64."""
    M = _U32
    idx, total = _compact_slots(F, out_cols)
    Fl = F.to(torch.int64)
    ln = (Fl[C_SHI] - Fl[C_SLO]) & M
    own = Fl[C_OWN] & M
    packed = ((own << (len_bits + 1)) | (ln << 1) | (Fl[C_REV] & 1)) & M
    rows = torch.stack([Fl[C_SLO] & M, Fl[C_TLO] & M, packed], dim=0)
    rows = torch.where(rows >= _BIAS, rows - (1 << 32), rows).to(torch.int32)
    valid = F[C_VALID] > 0
    bad = valid & ((ln >= (1 << len_bits)) | (own >= (1 << (31 - len_bits))))
    ovf = (total > out_cols) | bad.any()
    return _scatter_cols(rows, idx, out_cols), total, ovf


def decode_u32_fixed(M: np.ndarray, count: int, len_bits: int):
    """Host-side decode of compact_u32_fixed output (as np.uint32,
    wire_to_host): returns int64 (s_lo, s_hi, t_lo, t_hi, rev, owner)
    numpy arrays (segmap_jax.decode_u32_fixed)."""
    M = np.asarray(M)[:, :count].astype(np.int64)
    s_lo, t_lo, packed = M[0], M[1], M[2]
    rev = packed & 1
    ln = (packed >> 1) & ((1 << len_bits) - 1)
    own = packed >> (len_bits + 1)
    return s_lo, s_lo + ln, t_lo, t_lo + ln, rev, own


# --------------------------------------------------------------------------
# device run extraction + the u32 wire (segmap_jax._runs_packed_jit)
# --------------------------------------------------------------------------

def _padto(v, m):
    r = (-v.shape[0]) % m
    return torch.cat([v, v.new_zeros(r)]) if r else v


def _pack_words(v, per_word: int, bits: int):
    """Small values -> u32 words (per_word fields of `bits` bits each,
    little-endian), as int64."""
    b = _padto(v, per_word).view(-1, per_word)
    sh = torch.arange(per_word, dtype=torch.int64, device=v.device) * bits
    return (b << sh[None, :]).sum(dim=1)


def _prev(v, first):
    return torch.cat([v.new_full((1,), first), v[:-1]])


def runs_packed(F, lo, seq_grid, out_cols: int, len_bits: int,
                exc_cap: int | None = None):
    """Device run extraction + wire packing — segmap_jax._runs_packed_jit
    in torch, byte for byte.  Fragments sort by (owner, t_lo); target-
    and source-abutting same-orientation chains merge into runs; owners
    with overlapping targets pass through raw and flagged for the host's
    exact merge.

    Returns (wire int32 tensor of wire_words(out_cols, n_own) words —
    the u32 wire's bit patterns, view as np.uint32 on the host —,
    run_total int32, overflow bool).  u32 arithmetic is emulated in int64
    with & 0xFFFFFFFF."""
    M = _U32
    dev = F.device
    n_own = lo.shape[0]
    cap = F.shape[1]
    Fl = F.to(torch.int64)
    valid = F[C_VALID] > 0
    own_u = Fl[C_OWN] & M
    own_k = torch.where(valid, own_u, M)
    tlo = Fl[C_TLO] & M
    ln = (Fl[C_SHI] - Fl[C_SLO]) & M
    rev = Fl[C_REV] & 1
    own_i = own_u.clamp(max=n_own - 1)
    own_lo_in = (lo.to(torch.int64) & M)[own_i]
    s_off_in = ((Fl[C_SLO] & M) - own_lo_in) & M
    bad_in = valid & ((ln >= (1 << len_bits))
                      | (s_off_in >= (1 << (16 - len_bits))))
    meta = ((s_off_in << (len_bits + 1)) | (ln << 1) | rev) & M
    # stable 2-key sort (own_k, tlo) as ONE int64 key: own_k - 2^31 keeps
    # the unsigned order of own_k in a signed key
    key = (own_k - _BIAS) * (1 << 32) + tlo
    perm = torch.sort(key, stable=True).indices
    own_s = own_k[perm]
    tlo_s = tlo[perm]
    meta_s = meta[perm]
    soff_s = meta_s >> (len_bits + 1)
    ln_s = (meta_s >> 1) & ((1 << len_bits) - 1)
    rev_s = meta_s & 1
    valid_s = own_s != M
    prev_own = _prev(own_s, M)
    prev_tlo = _prev(tlo_s, 0)
    prev_soff = _prev(soff_s, 0)
    prev_ln = _prev(ln_s, 0)
    prev_rev = _prev(rev_s, 0)
    same_own = own_s == prev_own
    # any target overlap within an owner -> flag the owner for the host
    dup_pair = same_own & (tlo_s < ((prev_tlo + prev_ln) & M)) & valid_s
    own_idx = torch.where(valid_s, own_s, n_own)
    dup_own = torch.zeros(n_own + 1, dtype=torch.int64, device=dev)
    dup_own.scatter_reduce_(0, own_idx, dup_pair.to(torch.int64), reduce="amax")
    dup_own = dup_own[:n_own]
    row_dup = dup_own[own_idx.clamp(0, n_own - 1)] > 0
    # chain-merge predicate; runs never span target sequences
    abut_t = tlo_s == ((prev_tlo + prev_ln) & M)
    abut_s = torch.where(rev_s > 0, prev_soff == ((soff_s + ln_s) & M),
                         soff_s == ((prev_soff + prev_ln) & M))
    seq_id = torch.searchsorted(seq_grid, tlo_s, right=True)
    prev_seq = _prev(seq_id, 0)
    mergeable = (same_own & (rev_s == prev_rev) & abut_t & abut_s
                 & (seq_id == prev_seq) & ~row_dup & valid_s)
    start = valid_s & ~mergeable
    rid0 = torch.cumsum(start.to(torch.int32), 0, dtype=torch.int32) - 1
    run_total = (rid0[-1] + 1 if cap > 0
                 else torch.zeros((), dtype=torch.int32, device=dev))
    # segmented reduction per run; rows past out_cols land in a spare slot
    rid = torch.where(valid_s & (rid0 < out_cols), rid0, out_cols).long()

    def seg_reduce(init, vals, how):
        out = torch.full((out_cols + 1,), init, dtype=torch.int64, device=dev)
        if how == "sum":
            out.scatter_add_(0, rid, vals)
        else:
            out.scatter_reduce_(0, rid, vals, reduce=how)
        return out[:out_cols]

    zero = torch.zeros_like(tlo_s)
    out_tlo = seg_reduce(0, torch.where(start, tlo_s, zero), "amax")
    out_soff = seg_reduce(M, torch.where(valid_s, soff_s, M), "amin")
    out_len = seg_reduce(0, ln_s, "sum") & M
    out_rev = seg_reduce(0, torch.where(start, rev_s, zero), "amax")
    # per-owner run counts (2-bit wire codes; overflow-flagged)
    counts = torch.zeros(n_own + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, own_idx, start.to(torch.int64))
    counts = counts[:n_own]
    in_run = torch.arange(out_cols, dtype=torch.int32, device=dev) < run_total
    s_off = torch.where(in_run, out_soff, 0)
    pack = ((s_off << len_bits) | torch.where(in_run, out_len, 0)) & M
    overflow = ((run_total > out_cols)
                | bad_in.any()
                | (counts > 255).any()
                | (in_run & (out_len >= (1 << len_bits))).any()
                | (in_run & (s_off >= (1 << (16 - len_bits)))).any())

    # ---- the u32 wire: t_lo words, u16 pack pairs, rev bitset, 2-bit
    # run-count codes + escape bytes, dupe bitset (segmap_jax layout)
    codes = torch.clamp(counts, max=3)  # 3 = escape
    esc = codes == 3
    if exc_cap is None:
        exc_cap = tables._exc_cap(n_own)
    exc_pos = torch.cumsum(esc.to(torch.int32), 0, dtype=torch.int32) - 1
    n_exc = (exc_pos[-1] + 1 if n_own > 0
             else torch.zeros((), dtype=torch.int32, device=dev))
    exc_idx = torch.where(esc & (exc_pos < exc_cap), exc_pos, exc_cap).long()
    exc_vals = torch.zeros(exc_cap + 1, dtype=torch.int64, device=dev)
    exc_vals.scatter_(0, exc_idx, torch.clamp(counts, max=255))
    exc_vals = exc_vals[:exc_cap]
    overflow = overflow | (n_exc > exc_cap)

    p2 = _padto(pack, 2).view(-1, 2)
    wire = torch.cat([
        torch.where(in_run, out_tlo, 0),
        (p2[:, 0] | (p2[:, 1] << 16)) & M,
        _pack_words(torch.where(in_run, out_rev, 0), 32, 1),
        _pack_words(codes, 16, 2),
        _pack_words(exc_vals, 4, 8),
        _pack_words((dup_own > 0).to(torch.int64), 32, 1),
    ])
    wire = torch.where(wire >= _BIAS, wire - (1 << 32), wire).to(torch.int32)
    return wire, run_total.to(torch.int32), overflow


def wire_to_host(wire: torch.Tensor) -> np.ndarray:
    """runs_packed's wire as the host's np.uint32 words."""
    return wire.cpu().numpy().view(np.uint32)


def target_seq_grid(genome, *, device) -> torch.Tensor:
    """Inner sequence bounds of a target genome (int64 in uint32 range) for
    runs_packed's never-span-sequences check; single-sequence genomes get
    one unreachable sentinel."""
    # a copy: genome arrays are read-only (memory maps, remote buffers)
    inner = np.array(genome.seq_start[1:-1], np.int64)
    if inner.size == 0:
        inner = np.array([_U32], np.int64)
    return torch.from_numpy(inner).to(device)

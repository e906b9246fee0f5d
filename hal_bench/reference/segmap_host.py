"""Frozen copy of hal_tpu_torch/ops/segmap_host.py for the benchmark's plain reference (numpy
only; the same code, imports pointing at hal_bench.reference).  It is the
yardstick: the port may change, this copy does not.

Segment mapper (liftover kernel) — vectorized host implementation.

Re-designs reference api/impl/halSegmentMapper.cpp (677 LoC of
recursive iterator-pair surgery) as flat batched array transforms over
*fragments*.  A fragment is a pair of equal-length intervals

    source:  [src_lo, src_hi)   absolute coords in the (fixed) source genome
    target:  [tgt_lo, tgt_hi)   absolute coords in the current target genome
    rev:     orientation of target relative to source

and the whole mapper is a loop over the genome path (precomputed on host
from the tree) applying four vectorized ops to an entire batch:

  split_by_grid   fragment targets split at segment boundaries
                  (replaces the reference's toParseUp/toParseDown walks with
                  offset-delta re-slicing, halSegmentMapper.cpp:45-60)
  hop_up          top fragments -> parent bottom coords
                  (mapUp, :25-81; orientation composition per
                  BottomSegmentIterator::toParent, halBottomSegmentIterator.cpp:40-49)
  hop_down        bottom fragments -> child top coords (mapDown, :128-190)
  paralog_expand  top fragments -> all paralogy-ring members
                  (mapSelf, :263-330; offset mirroring per
                  TopSegmentIterator::toNextParalogy, halTopSegmentIterator.cpp:99-107)

plus dedup (the reference's sort+unique at every level) and a final
`atomize` which is the closed form of insertAndBreakOverlaps
(halSegmentMapper.cpp:475-523): split every fragment's target at every other
fragment's boundary inside it, so surviving intervals are pairwise
disjoint-or-identical.

The batched JAX/Pallas version (hal_tpu.ops.segmap) uses the same algebra
with static capacities; this host version is the correctness oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hal_bench.reference.constants import NULL_INDEX
from hal_bench.reference.alignment import Alignment
from hal_bench.reference.genome import GenomeArrays

TOP = 0
BOTTOM = 1


@dataclass
class Fragments:
    """A batch of co-sliced source/target interval pairs."""

    src_lo: np.ndarray
    src_hi: np.ndarray
    tgt_lo: np.ndarray
    tgt_hi: np.ndarray
    rev: np.ndarray  # uint8

    @classmethod
    def empty(cls) -> "Fragments":
        z = np.zeros(0, np.int64)
        return cls(z, z.copy(), z.copy(), z.copy(), np.zeros(0, np.uint8))

    @classmethod
    def identity(cls, lo: np.ndarray, hi: np.ndarray) -> "Fragments":
        lo = np.asarray(lo, np.int64)
        hi = np.asarray(hi, np.int64)
        keep = hi > lo
        lo, hi = lo[keep], hi[keep]
        return cls(lo.copy(), hi.copy(), lo.copy(), hi.copy(), np.zeros(len(lo), np.uint8))

    def __len__(self) -> int:
        return len(self.src_lo)

    def select(self, mask) -> "Fragments":
        return Fragments(self.src_lo[mask], self.src_hi[mask], self.tgt_lo[mask],
                         self.tgt_hi[mask], self.rev[mask])

    @staticmethod
    def concat(parts: list["Fragments"]) -> "Fragments":
        parts = [p for p in parts if len(p)]
        if not parts:
            return Fragments.empty()
        return Fragments(*[np.concatenate([getattr(p, f) for p in parts])
                           for f in ("src_lo", "src_hi", "tgt_lo", "tgt_hi", "rev")])

    def dedup(self) -> "Fragments":
        """sort+unique on all fields (reference results.sort+unique,
        halSegmentMapper.cpp:122-126)."""
        if len(self) == 0:
            return self
        key = np.stack([self.src_lo, self.src_hi, self.tgt_lo, self.tgt_hi,
                        self.rev.astype(np.int64)], axis=1)
        _, idx = np.unique(key, axis=0, return_index=True)
        return self.select(np.sort(idx))


def split_by_grid(frags: Fragments, grid: np.ndarray) -> tuple[Fragments, np.ndarray]:
    """Split fragment targets at segment-boundary `grid` (a start array with
    sentinel).  Returns (pieces, segment_index_per_piece).

    Source intervals are co-sliced: a piece [a, b) of a forward fragment
    advances the source by a - tgt_lo from the left; a reversed fragment
    advances it by tgt_hi - b.
    """
    n = len(frags)
    if n == 0:
        return frags, np.zeros(0, np.int64)
    i0 = np.searchsorted(grid, frags.tgt_lo, side="right") - 1
    i1 = np.searchsorted(grid, frags.tgt_hi - 1, side="right") - 1  # inclusive
    counts = i1 - i0 + 1
    total = int(counts.sum())
    # expansion: piece p belongs to fragment owner[p], covering segment seg[p]
    owner = np.repeat(np.arange(n, dtype=np.int64), counts)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    k = np.arange(total, dtype=np.int64) - offsets[owner]
    seg = i0[owner] + k
    piece_lo = np.maximum(frags.tgt_lo[owner], grid[seg])
    piece_hi = np.minimum(frags.tgt_hi[owner], grid[seg + 1])
    rev = frags.rev[owner]
    fwd_adv = piece_lo - frags.tgt_lo[owner]
    rev_adv = frags.tgt_hi[owner] - piece_hi
    adv = np.where(rev.astype(bool), rev_adv, fwd_adv)
    src_lo = frags.src_lo[owner] + adv
    src_hi = src_lo + (piece_hi - piece_lo)
    return Fragments(src_lo, src_hi, piece_lo, piece_hi, rev), seg


def hop_up(g: GenomeArrays, parent: GenomeArrays, child_slot: int,
           frags: Fragments, seg: np.ndarray, do_dupes: bool, min_length: int) -> Fragments:
    """Top fragments (already within single top segments `seg` of g) to the
    parent's bottom coordinates."""
    has = g.top_parent[seg] != NULL_INDEX
    if min_length:
        has &= (frags.tgt_hi - frags.tgt_lo) >= min_length
    if not do_dupes:
        # canonical paralog: parent's child entry points back
        # (Hdf5TopSegment::isCanonicalParalog, hdf5TopSegment.cpp:55-66)
        p = g.top_parent[seg]
        canon = np.zeros(len(frags), bool)
        ok = has
        canon[ok] = parent.bot_child[p[ok], child_slot] == seg[ok]
        has = has & canon
    frags, seg = frags.select(has), seg[has]
    if len(frags) == 0:
        return frags
    p = g.top_parent[seg]
    prev = g.top_parent_reversed[seg].astype(bool)
    ts = g.top_start[seg]
    te = g.top_start[seg + 1]
    bs = parent.bot_start[p]
    off = frags.tgt_lo - ts
    ln = frags.tgt_hi - frags.tgt_lo
    mirrored = te - frags.tgt_hi  # offset from segment's right end
    new_lo = np.where(prev, bs + mirrored, bs + off)
    return Fragments(frags.src_lo, frags.src_hi, new_lo, new_lo + ln,
                     frags.rev ^ prev.astype(np.uint8))


def hop_down(g: GenomeArrays, child: GenomeArrays, child_slot: int,
             frags: Fragments, seg: np.ndarray, min_length: int) -> Fragments:
    """Bottom fragments (within bottom segments `seg` of g) to the child's
    top coordinates."""
    c = g.bot_child[seg, child_slot]
    has = c != NULL_INDEX
    if min_length:
        has &= (frags.tgt_hi - frags.tgt_lo) >= min_length
    frags, seg, c = frags.select(has), seg[has], c[has]
    if len(frags) == 0:
        return frags
    crev = g.bot_child_reversed[seg, child_slot].astype(bool)
    bs = g.bot_start[seg]
    be = g.bot_start[seg + 1]
    ts = child.top_start[c]
    off = frags.tgt_lo - bs
    ln = frags.tgt_hi - frags.tgt_lo
    mirrored = be - frags.tgt_hi
    new_lo = np.where(crev, ts + mirrored, ts + off)
    return Fragments(frags.src_lo, frags.src_hi, new_lo, new_lo + ln,
                     frags.rev ^ crev.astype(np.uint8))


def paralog_expand(g: GenomeArrays, frags: Fragments, seg: np.ndarray,
                   min_length: int) -> Fragments:
    """Top fragments -> every member of their paralogy rings (including the
    original, as the reference's mapSelf does, halSegmentMapper.cpp:263-296).

    A ring member whose parent orientation differs gets a mirrored offset and
    flipped rev (TopSegmentIterator::toNextParalogy semantics).
    """
    out = [frags]  # the originals
    if len(frags) == 0:
        return frags
    orig = seg
    orig_rev_par = g.top_parent_reversed[seg].astype(bool)
    off = frags.tgt_lo - g.top_start[seg]
    ln = frags.tgt_hi - frags.tgt_lo
    cur = g.top_paralogy[seg]
    active = cur != NULL_INDEX
    # walk rings until back at the original (rings are disjoint cycles)
    while active.any():
        active &= cur != orig
        if not active.any():
            break
        a = np.flatnonzero(active)
        ca = cur[a]
        flip = g.top_parent_reversed[ca].astype(bool) != orig_rev_par[a]
        ts, te = g.top_start[ca], g.top_start[ca + 1]
        lo_f = ts + off[a]
        lo_r = te - off[a] - ln[a]
        new_lo = np.where(flip, lo_r, lo_f)
        piece = Fragments(frags.src_lo[a], frags.src_hi[a], new_lo, new_lo + ln[a],
                          frags.rev[a] ^ flip.astype(np.uint8))
        if min_length:
            keep = ln[a] >= min_length
            piece = piece.select(keep)
        out.append(piece)
        cur = cur.copy()
        cur[a] = g.top_paralogy[ca]
        active = active & (cur != NULL_INDEX)
    return Fragments.concat(out)


def _parse_split(g: GenomeArrays, frags: Fragments, to_kind: int):
    grid = g.top_start if to_kind == TOP else g.bot_start
    return split_by_grid(frags, grid)


def _self_expand_bottom(g: GenomeArrays, frags: Fragments, min_length: int) -> Fragments:
    """mapSelf on bottom fragments: cross the parse edge to tops, then ring
    expand (result fragments are TOP kind, reference halSegmentMapper.cpp:296-330)."""
    pieces, seg = _parse_split(g, frags, TOP)
    return paralog_expand(g, pieces, seg, min_length)


def map_source(
    aln: Alignment,
    src_genome: str,
    intervals_lo: np.ndarray,
    intervals_hi: np.ndarray,
    tgt_genome: str,
    do_dupes: bool = True,
    min_length: int = 0,
    coalescence_limit: str | None = None,
) -> Fragments:
    """halMapSegment over a batch of source intervals
    (reference api/impl/halSegmentMapper.cpp:639-671 mapSource/halMapSegment).

    Returns fragments in `tgt_genome` coordinates, atomized (targets pairwise
    disjoint-or-identical) and deduped.
    """
    tree = aln.tree
    mrca = tree.lca(src_genome, tgt_genome)
    limit = coalescence_limit or mrca

    frags = Fragments.identity(intervals_lo, intervals_hi)
    cur = src_genome
    kind = BOTTOM if cur == mrca else TOP

    # ---- map up to the MRCA (mapRecursiveUp, :85-126) -------------------
    while cur != mrca:
        g = aln.open_genome(cur)
        parent_name = tree.parent(cur)
        pg = aln.open_genome(parent_name)
        slot = tree.child_index(parent_name, cur)
        if kind == BOTTOM:
            pieces, seg = _parse_split(g, frags, TOP)
        else:
            pieces, seg = split_by_grid(frags, g.top_start)
        frags = hop_up(g, pg, slot, pieces, seg, True, min_length).dedup()
        cur, kind = parent_name, BOTTOM

    # state carries both kinds because paralogy results re-enter as TOP
    # while the up-phase output is BOTTOM (the reference tracks isTop() per
    # MappedSegment, halMappedSegment.h:25-198)
    state = {TOP: Fragments.empty(), BOTTOM: Fragments.empty()}
    state[kind] = frags

    # ---- paralogies above the MRCA (mapRecursiveParalogies, :525-576) ---
    if do_dupes and limit != mrca:
        state = _map_paralogies(aln, state, mrca, limit, min_length)

    # ---- map down to the target (mapRecursiveDown, :191-262) ------------
    state = _map_down(aln, state, cur, tgt_genome, do_dupes, min_length)

    return atomize(Fragments.concat([state[TOP], state[BOTTOM]]).dedup())


def _map_down(aln: Alignment, state: dict, cur: str, tgt_genome: str,
              do_dupes: bool, min_length: int) -> dict:
    tree = aln.tree
    if cur == tgt_genome:
        return state
    path = tree.path(cur, tgt_genome)  # descending chain cur -> ... -> tgt
    for nxt in path[1:]:
        g = aln.open_genome(cur)
        cg = aln.open_genome(nxt)
        slot = tree.child_index(cur, nxt)
        hopped = []
        if len(state[TOP]):
            pieces, seg = _parse_split(g, state[TOP], BOTTOM)
            hopped.append(hop_down(g, cg, slot, pieces, seg, min_length))
        if len(state[BOTTOM]):
            pieces, seg = split_by_grid(state[BOTTOM], g.bot_start)
            hopped.append(hop_down(g, cg, slot, pieces, seg, min_length))
        frags = Fragments.concat(hopped)
        if do_dupes and len(frags):
            pieces, seg = split_by_grid(frags, cg.top_start)
            frags = paralog_expand(cg, pieces, seg, min_length)
        state = {TOP: frags.dedup(), BOTTOM: Fragments.empty()}
        cur = nxt
    return state


def _map_paralogies(aln: Alignment, state: dict, mrca: str, limit: str,
                    min_length: int) -> dict:
    """Map to paralogs coalescing in or below `limit` (an ancestor of mrca):
    at each genome from mrca up to (not incl.) limit, self-expand and bring
    the paralogs back down to the mrca; union with the originals."""
    tree = aln.tree
    results = [dict(state)]
    cur = mrca
    cur_state = state
    while cur != limit:
        g = aln.open_genome(cur)
        to_self = []
        if len(cur_state[BOTTOM]):
            to_self.append(_self_expand_bottom(g, cur_state[BOTTOM], min_length))
        if len(cur_state[TOP]):
            pieces, seg = split_by_grid(cur_state[TOP], g.top_start)
            to_self.append(paralog_expand(g, pieces, seg, min_length))
        paralogs = {TOP: Fragments.concat(to_self), BOTTOM: Fragments.empty()}
        results.append(_map_down(aln, paralogs, cur, mrca, False, min_length))
        parent_name = tree.parent(cur)
        if parent_name is None:
            raise ValueError("Hit root genome when attempting to map paralogies")
        if parent_name == limit:
            break
        pg = aln.open_genome(parent_name)
        slot = tree.child_index(parent_name, cur)
        up = []
        if len(cur_state[BOTTOM]):
            pieces, seg = _parse_split(g, cur_state[BOTTOM], TOP)
            up.append(hop_up(g, pg, slot, pieces, seg, True, min_length))
        if len(cur_state[TOP]):
            pieces, seg = split_by_grid(cur_state[TOP], g.top_start)
            up.append(hop_up(g, pg, slot, pieces, seg, True, min_length))
        cur_state = {TOP: Fragments.empty(), BOTTOM: Fragments.concat(up).dedup()}
        cur = parent_name
    merged = {TOP: Fragments.concat([r[TOP] for r in results]).dedup(),
              BOTTOM: Fragments.concat([r[BOTTOM] for r in results]).dedup()}
    return merged


def atomize(frags: Fragments) -> Fragments:
    """Split every fragment's target at every other fragment's boundaries
    that fall strictly inside it — the closed form of the reference's
    insertAndBreakOverlaps/clipAagainstB (halSegmentMapper.cpp:397-523).
    Afterwards target intervals are pairwise disjoint or identical."""
    n = len(frags)
    if n <= 1:
        return frags
    bounds = np.unique(np.concatenate([frags.tgt_lo, frags.tgt_hi]))
    # number of interior cut points per fragment
    i0 = np.searchsorted(bounds, frags.tgt_lo, side="right")
    i1 = np.searchsorted(bounds, frags.tgt_hi, side="left")
    counts = (i1 - i0) + 1  # pieces per fragment
    total = int(counts.sum())
    owner = np.repeat(np.arange(n, dtype=np.int64), counts)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    k = np.arange(total, dtype=np.int64) - offsets[owner]
    # piece k of fragment f spans [cut_k, cut_{k+1}) where cuts are
    # tgt_lo, bounds[i0..i1-1], tgt_hi
    lo = np.where(k == 0, frags.tgt_lo[owner], bounds[np.minimum(i0[owner] + k - 1, len(bounds) - 1)])
    is_last = k == (counts[owner] - 1)
    hi = np.where(is_last, frags.tgt_hi[owner], bounds[np.minimum(i0[owner] + k, len(bounds) - 1)])
    rev = frags.rev[owner]
    fwd_adv = lo - frags.tgt_lo[owner]
    rev_adv = frags.tgt_hi[owner] - hi
    adv = np.where(rev.astype(bool), rev_adv, fwd_adv)
    src_lo = frags.src_lo[owner] + adv
    out = Fragments(src_lo, src_lo + (hi - lo), lo, hi, rev)
    return out.dedup()


def merge_colinear(frags: Fragments, seq_bounds: np.ndarray | None = None) -> Fragments:
    """Merge runs of fragments contiguous in both source and target with the
    same orientation (BlockMapper::extractSegment fragment stitching,
    liftover/inc/halBlockMapper.h:73-100).  Optionally breaks merged runs at
    target sequence boundaries."""
    n = len(frags)
    if n <= 1:
        return frags
    order = np.lexsort((frags.tgt_lo, frags.src_lo))
    f = frags.select(order)
    rev = f.rev.astype(bool)
    # fragment i chains to i+1 if: same orientation; source contiguous;
    # target contiguous in the right direction
    src_adj = f.src_hi[:-1] == f.src_lo[1:]
    same_rev = f.rev[:-1] == f.rev[1:]
    tgt_adj_f = f.tgt_hi[:-1] == f.tgt_lo[1:]
    tgt_adj_r = f.tgt_lo[:-1] == f.tgt_hi[1:]
    chain = src_adj & same_rev & np.where(rev[:-1], tgt_adj_r, tgt_adj_f)
    if seq_bounds is not None and len(seq_bounds) > 2:
        # do not merge across target sequence boundaries
        joint = np.where(rev[:-1], f.tgt_lo[:-1], f.tgt_hi[:-1])
        interior = seq_bounds[1:-1]
        crosses = np.isin(joint, interior)
        chain &= ~crosses
    # run starts
    starts = np.concatenate([[True], ~chain])
    run_id = np.cumsum(starts) - 1
    n_runs = int(run_id[-1]) + 1
    first = np.flatnonzero(starts)
    src_hi = np.zeros(n_runs, np.int64)
    tgt_lo = np.full(n_runs, np.iinfo(np.int64).max, np.int64)
    tgt_hi = np.zeros(n_runs, np.int64)
    np.maximum.at(src_hi, run_id, f.src_hi)
    np.minimum.at(tgt_lo, run_id, f.tgt_lo)
    np.maximum.at(tgt_hi, run_id, f.tgt_hi)
    return Fragments(f.src_lo[first], src_hi, tgt_lo, tgt_hi, f.rev[first])

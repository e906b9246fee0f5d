"""Plain reference of the batched segment mapper: HAL's halMapSegment over a
batch of source intervals, each fragment tagged with the index of the
interval it came from (its owner).

It applies the algebra of the frozen segmap_host copy (split a fragment's
target at the genome's segment grid, hop across the parent or child link,
expand every paralogy-ring member after each hop down) to the whole batch
at once, with a dedup per owner at every level where map_source dedups.
No capacities, no device, no tables.

canonical() brings any fragment set of a batch to one form: per owner,
every target split at every fragment boundary of that owner (map_source's
atomize), duplicates dropped, rows sorted.  The port's BatchMapper returns
its fragments un-atomized and with duplicates; canonical() of its output
and of map_intervals() agree when the mapping is right.
"""

from __future__ import annotations

import numpy as np

from hal_bench.reference.alignment import Alignment
from hal_bench.reference.constants import NULL_INDEX

# row order of a fragment matrix
FIELDS = ("s_lo", "s_hi", "t_lo", "t_hi", "rev", "owner")


def _split(F: np.ndarray, grid: np.ndarray):
    """F's targets split at the segment starts `grid` (with its sentinel):
    (pieces, segment index of each piece)."""
    s_lo, s_hi, t_lo, t_hi, rev, own = F
    if not len(t_lo):
        return F, np.zeros(0, np.int64)
    i0 = np.searchsorted(grid, t_lo, side="right") - 1
    i1 = np.searchsorted(grid, t_hi - 1, side="right") - 1
    counts = i1 - i0 + 1
    src = np.repeat(np.arange(len(t_lo)), counts)
    first = np.cumsum(counts) - counts
    seg = i0[src] + np.arange(int(counts.sum())) - first[src]
    lo = np.maximum(t_lo[src], grid[seg])
    hi = np.minimum(t_hi[src], grid[seg + 1])
    r = rev[src]
    adv = np.where(r > 0, t_hi[src] - hi, lo - t_lo[src])
    sl = s_lo[src] + adv
    return np.stack([sl, sl + (hi - lo), lo, hi, r, own[src]]), seg


def _hop(F, seg, link, lrev, seg_start, seg_end, dst_start):
    """Pieces within segments `seg` moved across `link` to the destination
    segment starts, mirrored where the link is reversed."""
    keep = link[seg] != NULL_INDEX
    F, seg = F[:, keep], seg[keep]
    d = link[seg]
    flip = lrev[seg].astype(np.int64)
    ln = F[3] - F[2]
    new_lo = np.where(flip > 0, dst_start[d] + (seg_end[seg] - F[3]),
                      dst_start[d] + (F[2] - seg_start[seg]))
    return np.stack([F[0], F[1], new_lo, new_lo + ln, F[4] ^ flip, F[5]])


def _paralogs(g, F, seg):
    """F (pieces within top segments `seg` of g) and every other member of
    each piece's paralogy ring, in ring order, mirrored where the member's
    parent orientation differs (TopSegmentIterator::toNextParalogy)."""
    out = [F]
    off = F[2] - g.top_start[seg]
    ln = F[3] - F[2]
    orig_rev = g.top_parent_reversed[seg].astype(np.int64)
    cur = g.top_paralogy[seg].copy()
    active = cur != NULL_INDEX
    while True:
        active &= cur != seg
        if not active.any():
            break
        a = np.flatnonzero(active)
        m = cur[a]
        flip = (g.top_parent_reversed[m].astype(np.int64) != orig_rev[a])
        lo = np.where(flip, g.top_start[m + 1] - off[a] - ln[a],
                      g.top_start[m] + off[a])
        out.append(np.stack([F[0, a], F[1, a], lo, lo + ln[a],
                             F[4, a] ^ flip.astype(np.int64), F[5, a]]))
        cur[a] = g.top_paralogy[m]
        active &= cur != NULL_INDEX
    return np.concatenate(out, axis=1)


def _dedup(F):
    if not F.shape[1]:
        return F
    return np.unique(F, axis=1)


def map_intervals(aln: Alignment, src: str, tgt: str, lo, hi,
                  do_dupes: bool = True) -> np.ndarray:
    """Fragments (6, n) int64, rows FIELDS, of intervals [lo, hi) of genome
    src in genome tgt; owner k is interval k.  Paralogies below the MRCA
    are traversed when do_dupes (the port's default)."""
    tree = aln.tree
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    own = np.arange(len(lo), dtype=np.int64)
    keep = hi > lo
    z = np.zeros(int(keep.sum()), np.int64)
    F = np.stack([lo[keep], hi[keep], lo[keep], hi[keep], z, own[keep]])
    mrca = tree.lca(src, tgt)
    cur = src
    while cur != mrca:
        g = aln.open_genome(cur)
        parent = tree.parent(cur)
        pg = aln.open_genome(parent)
        F, seg = _split(F, g.top_start)
        n = g.num_top_segments
        F = _dedup(_hop(F, seg, g.top_parent, g.top_parent_reversed,
                        g.top_start[:n], g.top_start[1:], pg.bot_start))
        cur = parent
    for nxt in tree.path(cur, tgt)[1:]:
        g = aln.open_genome(cur)
        cg = aln.open_genome(nxt)
        slot = tree.child_index(cur, nxt)
        F, seg = _split(F, g.bot_start)
        n = g.num_bottom_segments
        F = _hop(F, seg, g.bot_child[:, slot], g.bot_child_reversed[:, slot],
                 g.bot_start[:n], g.bot_start[1:], cg.top_start)
        if do_dupes and F.shape[1]:
            F, seg = _split(F, cg.top_start)
            F = _paralogs(cg, F, seg)
        F = _dedup(F)
        cur = nxt
    return F


def canonical(F: np.ndarray, scale: int) -> np.ndarray:
    """Per owner: targets split at every boundary of that owner's fragments,
    duplicates dropped, rows sorted by (owner, t_lo, t_hi, s_lo, s_hi,
    rev).  scale: above every coordinate (owner-scoped keys)."""
    F = np.asarray(F, np.int64)
    if not F.shape[1]:
        return F.reshape(6, 0)
    s_lo, s_hi, t_lo, t_hi, rev, own = F
    k_lo = own * scale + t_lo
    k_hi = own * scale + t_hi
    keys = np.unique(np.concatenate([k_lo, k_hi]))
    i0 = np.searchsorted(keys, k_lo, side="right")
    i1 = np.searchsorted(keys, k_hi, side="left")
    counts = i1 - i0 + 1
    src = np.repeat(np.arange(len(s_lo)), counts)
    k = np.arange(int(counts.sum())) - (np.cumsum(counts) - counts)[src]
    cut = keys % scale
    last = len(keys) - 1
    lo = np.where(k == 0, t_lo[src], cut[np.minimum(i0[src] + k - 1, last)])
    hi = np.where(k == counts[src] - 1, t_hi[src],
                  cut[np.minimum(i0[src] + k, last)])
    r = rev[src]
    sl = s_lo[src] + np.where(r > 0, t_hi[src] - hi, lo - t_lo[src])
    A = np.stack([own[src], lo, hi, sl, sl + (hi - lo), r])
    A = np.unique(A, axis=1)
    return A[[3, 4, 1, 2, 5, 0]]


def mismatches(a: np.ndarray, b: np.ndarray) -> int:
    """Columns in one canonical fragment set and not in the other."""
    both = np.concatenate([a, b], axis=1)
    if not both.shape[1]:
        return 0
    _, counts = np.unique(both, axis=1, return_counts=True)
    return int((counts == 1).sum())

"""Host helpers of the batched segment mapper, numpy only.

Verbatim copies of the host-side functions of hal_tpu.ops.segmap_jax
(page tables, ring CSR, packed segment tables, capacity sizing, the run
wire decode).  The originals cannot be imported without jax — importing
segmap_jax turns on jax_enable_x64 for the whole process — so the port
carries these copies, and tests/test_torch_tables.py holds each one equal
to its original.  The only edits: _np_dtype_of takes numpy dtypes and
_pack4 returns a numpy array instead of a jax one.
"""

from __future__ import annotations

import numpy as np

from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.constants import NULL_INDEX

# paged lookup: window of candidate segments per query after the page-table
# hop; pages are sized on host so a page never spans more segments
_PAGE_WINDOW = 64


def _build_page_table(starts: np.ndarray):
    """Host precompute for mammal-scale grids: page_first[k] = index of the
    segment containing coordinate k << shift.  The page shift is chosen so
    no page overlaps more than _PAGE_WINDOW-1 segment starts, bounding the
    device-side binary search to log2(_PAGE_WINDOW) clipped gathers — this
    replaces both the O(n*q) compare-count (too big past ~64k segments) and
    jnp.searchsorted(method='sort') (a bitonic sort, the single slowest XLA
    op here) for arbitrarily large genomes.

    Returns (page_first int32 array, shift) or (None, 0) when unbuildable."""
    n_seg = len(starts) - 1
    total = int(starts[-1]) if len(starts) else 0
    if n_seg <= 1 or total <= 1:
        return None, 0
    starts = np.asarray(starts, np.int64)
    shift = max(int(total - 1).bit_length(), 1)
    while True:
        bounds = np.arange(0, total + (1 << shift), 1 << shift, dtype=np.int64)
        firsts = np.searchsorted(starts, bounds[:-1], side="right") - 1
        lasts = np.searchsorted(
            starts, np.minimum(bounds[1:], total) - 1, side="right") - 1
        span = int((lasts - firsts).max()) + 1 if len(firsts) else 1
        if span <= _PAGE_WINDOW - 1:
            return np.maximum(firsts, 0).astype(np.int32), shift
        if shift == 1 or len(bounds) > 4 * n_seg + 16:
            return None, 0  # pathological clustering: caller falls back
        shift -= 1


def _build_ring_csr(ring: np.ndarray, reversed_: np.ndarray):
    """Host precompute: per top segment, the OTHER members of its paralogy
    ring (ring order starting after the segment) plus an orientation-flip
    bit per member (TopSegmentIterator::toNextParalogy semantics)."""
    n = len(ring)
    counts = np.zeros(n, np.int64)
    members: list[int] = []
    flips: list[int] = []
    offsets = np.zeros(n, np.int64)
    for i in np.flatnonzero(ring != NULL_INDEX):
        offsets[i] = len(members)
        j = int(ring[i])
        c = 0
        while j != i and j != NULL_INDEX:
            members.append(j)
            flips.append(1 if reversed_[j] != reversed_[i] else 0)
            c += 1
            j = int(ring[j])
        counts[i] = c
    return (counts, offsets, np.asarray(members, np.int64),
            np.asarray(flips, np.uint8))


def _np_dtype_of(dtype):
    return {np.dtype(np.int32): np.int32,
            np.dtype(np.uint32): np.uint32}.get(np.dtype(dtype), np.int64)


def _pack4(np_dtype, *cols):
    n = len(cols[0])
    m = np.zeros((max(len(cols), 4), max(n, 1)), np_dtype)
    for k, c in enumerate(cols):
        if n:
            m[k, :] = c
    return m


def _seg_tab(np_dtype, starts, link, lrev, dst_start, rc, ro):
    """Pre-join the link hop (host): [start, next, dst_start, lrev,
    has_link, ring_count, ring_offset, 0] — link-dependent values are pure
    functions of the segment index, so the device does ONE column gather
    per hop instead of a second indirection."""
    n_seg = len(link)
    link = np.asarray(link, np.int64)
    lc = np.clip(link, 0, max(len(dst_start) - 1, 0))
    has = (link != NULL_INDEX).astype(np.int64)
    ds = (dst_start[lc] if len(dst_start) else np.zeros(n_seg, np.int64)) * has
    rcj = (rc[lc] if len(rc) else np.zeros(n_seg, np.int64)) * has
    roj = (ro[lc] if len(ro) else np.zeros(n_seg, np.int64)) * has
    z = np.zeros(n_seg, np.int64)
    return _pack4(np_dtype, starts[:n_seg], starts[1:n_seg + 1], ds,
                  np.asarray(lrev, np.int64), has, rcj, roj, z)


def _exc_cap(n_own: int) -> int:
    """Static size of the run-count escape region: only owners with >= 3
    runs escape the 2-bit code (rare — an owner needs two+ break points
    inside one query interval), but never less than full coverage for
    small batches."""
    return max(n_own // 32, min(n_own, 4096), 4)


def wire_words(out_cols: int, n_own: int) -> int:
    """Length in u32 words of _runs_packed_jit's wire buffer."""
    exc_cap = _exc_cap(n_own)
    return (out_cols + (out_cols + 1) // 2 + (out_cols + 31) // 32
            + (n_own + 15) // 16 + (exc_cap + 3) // 4
            + (n_own + 31) // 32)


def decode_runs_packed(wire, run_total, lo, out_cols: int, len_bits: int,
                       exc_cap: int | None = None):
    """Host decode of _runs_packed_jit's single u32 wire buffer: returns
    int64 numpy arrays (s_lo, s_hi, t_lo, t_hi, rev, owner) of the merged
    runs plus the boolean per-owner needs-host-merge mask."""
    k = int(run_total)
    n_own = len(lo)
    w = np.asarray(wire)
    c = out_cols
    c2 = (c + 1) // 2
    cb = (c + 31) // 32
    nb = (n_own + 15) // 16
    if exc_cap is None:
        exc_cap = _exc_cap(n_own)
    e4 = (exc_cap + 3) // 4
    tl = w[:c][:k].astype(np.int64)
    pw = w[c:c + c2]
    pack = np.empty(c2 * 2, np.int64)
    pack[0::2] = pw & 0xFFFF
    pack[1::2] = pw >> 16
    pack = pack[:k]
    ln = pack & ((1 << len_bits) - 1)
    s_off = pack >> len_bits
    rb = np.unpackbits(w[c + c2:c + c2 + cb].view(np.uint8),
                       bitorder="little")[:k]
    o = c + c2 + cb
    cw = w[o:o + nb]
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    codes = ((cw[:, None] >> shifts) & 3).reshape(-1)[:n_own].astype(np.int64)
    exc = w[o + nb:o + nb + e4].view(np.uint8)
    counts = codes.copy()
    esc = codes == 3
    n_exc = int(esc.sum())
    counts[esc] = exc[:n_exc].astype(np.int64)
    dupes = np.unpackbits(w[o + nb + e4:].view(np.uint8),
                          bitorder="little")[:n_own].astype(bool)
    own = np.repeat(np.arange(n_own, dtype=np.int64), counts)
    assert len(own) == k, (len(own), k)
    s_lo = np.asarray(lo, np.int64)[own] + s_off
    return (s_lo, s_lo + ln, tl, tl + ln, rb.astype(np.int64), own, dupes)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def _bucket_cap(x: int) -> int:
    """Round up to a quarter-octave bucket ({4,5,6,7} * 2^k): at most 25%
    slack instead of pow2's 100%, while keeping the compile-cache key space
    finite."""
    x = max(int(x), 16)
    base = 1 << max(x.bit_length() - 1, 2)  # largest pow2 <= x
    quarter = base >> 2
    for m in (4, 5, 6, 7, 8):
        c = m * quarter
        if c >= x:
            return c
    return 2 * base


class _HostSim:
    """Host twin of _run_path's split/hop/ring algebra (numpy, exact).

    Sizes device capacities without a device sizing pass; also yields the
    exact final row count for static-output compaction.  Ring CSR tables
    are cached per child genome so multi-path sizing (depth over a whole
    scope) builds each at most once."""

    def __init__(self, aln: Alignment, do_dupes: bool = True):
        self.aln = aln
        self.tree = aln.tree
        self.do_dupes = do_dupes
        self._csr: dict = {}

    def _rings(self, child_name: str):
        r = self._csr.get(child_name)
        if r is None:
            cg = self.aln.open_genome(child_name)
            if (self.do_dupes and cg.top_paralogy.size
                    and (cg.top_paralogy != NULL_INDEX).any()):
                rc, ro, rm, rf = _build_ring_csr(cg.top_paralogy,
                                                 cg.top_parent_reversed)
                r = (rc, ro, rm, rf, cg.top_start)
            else:
                r = False
            self._csr[child_name] = r
        return r

    def level(self, cur: str, nxt: str, t_lo, t_hi, rings: bool):
        """Apply one level; returns (t_lo', t_hi', split_total, ring_total)."""
        g = self.aln.open_genome(cur)
        ng = self.aln.open_genome(nxt)
        going_up = self.tree.parent(cur) == nxt
        ring_count = None
        if going_up:
            starts = g.top_start
            link = g.top_parent
            lrev = g.top_parent_reversed.astype(np.int64)
            dst = ng.bot_start
        else:
            slot = self.tree.child_index(cur, nxt)
            starts = g.bot_start
            link = (g.bot_child[:, slot] if g.num_bottom_segments
                    else np.zeros(0, np.int64))
            lrev = (g.bot_child_reversed[:, slot].astype(np.int64)
                    if g.num_bottom_segments else np.zeros(0, np.int64))
            dst = ng.top_start
            if rings:
                ring_count = self._rings(nxt) or None
        i0 = np.searchsorted(starts, t_lo, side="right") - 1
        i1 = np.searchsorted(starts, t_hi - 1, side="right") - 1
        counts = np.maximum(i1 - i0 + 1, 0) * (t_hi > t_lo)
        split_total = int(counts.sum())
        own = np.repeat(np.arange(len(counts)), counts)
        offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
        seg = i0[own] + (np.arange(len(own)) - offs[own])
        p_lo = np.maximum(t_lo[own], starts[seg])
        p_hi = np.minimum(t_hi[own], starts[seg + 1])
        li = link[seg] if len(link) else np.full(len(seg), NULL_INDEX)
        keep = (p_hi > p_lo) & (li != NULL_INDEX)
        seg, p_lo, p_hi, li = seg[keep], p_lo[keep], p_hi[keep], li[keep]
        lr = lrev[seg] if len(lrev) else np.zeros(len(seg), np.int64)
        ds = dst[li]
        off = p_lo - starts[seg]
        mirrored = starts[seg + 1] - p_hi
        new_lo = np.where(lr > 0, ds + mirrored, ds + off)
        ln = p_hi - p_lo
        t_lo2, t_hi2 = new_lo, new_lo + ln
        ring_total = 0
        if ring_count is not None:
            rc, ro, rm, rf, cstarts = ring_count
            rcs = rc[li]
            ring_total = int(rcs.sum())
            rown = np.repeat(np.arange(len(rcs)), rcs)
            roffs = np.concatenate([[0], np.cumsum(rcs)])[:-1]
            midx = rm[ro[li][rown] + (np.arange(len(rown)) - roffs[rown])]
            offm = t_lo2[rown] - cstarts[li[rown]]
            mln = ln[rown]
            flip = rf[ro[li][rown] + (np.arange(len(rown)) - roffs[rown])]
            nlo = np.where(flip > 0, cstarts[midx + 1] - offm - mln,
                           cstarts[midx] + offm)
            t_lo2 = np.concatenate([t_lo2, nlo])
            t_hi2 = np.concatenate([t_hi2, nlo + mln])
        return t_lo2, t_hi2, split_total, ring_total


def host_level_totals(aln: Alignment, src: str, tgt: str, lo, hi,
                      do_dupes: bool = True, with_final: bool = False,
                      sim: "_HostSim | None" = None):
    """Exact per-level expansion totals for a MAIN-CHAIN path, computed on
    host with numpy in one vectorized pass per level (mirrors _run_path's
    split/ring algebra via _HostSim).

    Replaces the device 'sizing pass' — a separate generous-caps compile
    that dominated round-1 bench time — so the device program compiles
    ONCE with tight power-of-two caps.  Returns [(split_total, ring_total)]
    per level; with_final=True returns (totals, final_valid_rows) where
    final_valid_rows is the exact post-filter fragment count the device
    compaction will produce (sizes _compact_u32_fixed_jit's static
    output)."""
    if sim is None:
        sim = _HostSim(aln, do_dupes)
    tree = aln.tree
    t_lo = np.asarray(lo, np.int64)
    t_hi = np.asarray(hi, np.int64)
    totals = []
    cur = src
    for nxt in tree.path(src, tgt)[1:]:
        t_lo, t_hi, sv, rv = sim.level(cur, nxt, t_lo, t_hi,
                                       rings=do_dupes)
        totals.append((sv, rv))
        cur = nxt
    if with_final:
        return totals, len(t_lo)
    return totals


def host_path_totals(aln: Alignment, src: str, tgt: str, lo, hi,
                     do_dupes: bool = True,
                     coalescence_limit: str | None = None,
                     sim: "_HostSim | None" = None):
    """Exact expansion totals for the FULL _run_path traversal order —
    up levels, paralogy branches above the MRCA (coalescence limit,
    reference mapRecursiveParalogies halSegmentMapper.cpp:525-576), then
    main down levels on the unioned fragment set.  One (sv, rv) entry per
    cap _run_path consumes, so caps_from_totals sizes every program
    exactly and device overflow becomes a hard invariant violation."""
    if sim is None:
        sim = _HostSim(aln, do_dupes)
    tree = aln.tree
    mrca = tree.lca(src, tgt)
    limit = coalescence_limit or mrca
    chain = [mrca]
    anc = mrca
    while anc != limit:
        anc = tree.parent(anc)
        if anc is None:
            raise ValueError("coalescence limit %s is not an ancestor of "
                             "the MRCA %s" % (limit, mrca))
        chain.append(anc)
    t_lo = np.asarray(lo, np.int64)
    t_hi = np.asarray(hi, np.int64)
    totals = []
    cur = src
    while cur != mrca:
        nxt = tree.parent(cur)
        t_lo, t_hi, sv, rv = sim.level(cur, nxt, t_lo, t_hi, rings=do_dupes)
        totals.append((sv, rv))
        cur = nxt
    if do_dupes and limit != mrca:
        branches = [(t_lo, t_hi)]
        g_lo, g_hi = t_lo, t_hi
        for k in range(1, len(chain)):
            g_lo, g_hi, sv, rv = sim.level(chain[k - 1], chain[k], g_lo,
                                           g_hi, rings=False)
            totals.append((sv, rv))
            h_lo, h_hi = g_lo, g_hi
            for j in range(k - 1, -1, -1):
                h_lo, h_hi, sv, rv = sim.level(chain[j + 1], chain[j], h_lo,
                                               h_hi, rings=True)
                totals.append((sv, rv))
            branches.append((h_lo, h_hi))
        t_lo = np.concatenate([b[0] for b in branches])
        t_hi = np.concatenate([b[1] for b in branches])
    if cur != tgt:
        for nxt in tree.path(cur, tgt)[1:]:
            t_lo, t_hi, sv, rv = sim.level(cur, nxt, t_lo, t_hi,
                                           rings=do_dupes)
            totals.append((sv, rv))
            cur = nxt
    return totals, len(t_lo)


def caps_from_totals(path: PathData, totals, slack: float = 1.0):
    """Quarter-octave bucketed caps for the FULL traversal (up levels,
    paralogy branches, main down levels) from host_path_totals output —
    one cap per level in _run_path's consumption order."""
    seq = list(path.levels[:path.n_up])
    for (up, downs) in path.para:
        seq.append(up)
        seq.extend(downs)
    seq.extend(path.levels[path.n_up:])
    assert len(seq) == len(totals), (len(seq), len(totals))
    caps = []
    for level, (sv, rv) in zip(seq, totals):
        c = _bucket_cap(int(sv * slack))
        if level.kind == "down" and level.max_ring:
            caps.append((c, _bucket_cap(int(rv * slack))))
        else:
            caps.append(c)
    return tuple(caps)


def tight_caps(path: PathData, totals, slack: float = 1.0):
    """Quarter-octave bucketed caps from host_level_totals output
    (main-chain paths only; full paths use caps_from_totals)."""
    assert not path.para, "tight_caps sizes main-chain paths only"
    return caps_from_totals(path, totals, slack)

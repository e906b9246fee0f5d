"""Port copy of hal_tpu/ops/lod.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

Levels of detail: generate a coarser alignment for browser-scale queries.

Re-design of the reference's LodExtract/LodGraph/LodBlock
(lod/impl/halLod*.cpp, ~2.3k LoC of sampled-column graph building) on top
of the gapped-run machinery: per branch, matched top segments are chained
into runs that absorb indels < scale (the same coarsening the reference
achieves by sampling probe columns every `scale` bases), runs shorter than
the scale are dropped, and child/parent lengths are equalized by trimming
to the shorter side (LOD alignments are approximate by design).  Paralogy
is retained (like the reference's column-sampled graph, which carries
duplications): non-canonical run chains keep their parent links, and
paralogy rings are rebuilt over the coarse segments wherever two or more
child tops land exactly on one parent tile (`only_orthologs=True` restores
the round-2 ortholog-only behavior).  DNA is omitted unless keep_sequences
(reference --keepSequences; Genome::setDimensions(storeDNAArrays=false),
api/inc/halGenome.h:53-57).
"""

from __future__ import annotations

import numpy as np

from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.genome import GenomeArrays, SequenceInfo
from hal_tpu_torch.ops.rearrangement import analyze_branch


def _chain_runs(g, pg, t_idx, p_idx, rev, scale, canon_flag):
    """Chain one canonicity class of matched tops into coarse runs: indels
    below `scale` absorbed, runs shorter than scale dropped, lengths
    equalized by trimming anchored at the run's leading edge."""
    out = []
    n = len(t_idx)
    if n == 0:
        return out
    t_seq = g.seq_index_at(g.top_start[t_idx])
    p_seq = pg.seq_index_at(pg.bot_start[p_idx])
    same = (t_seq[:-1] == t_seq[1:]) & (p_seq[:-1] == p_seq[1:]) & (rev[:-1] == rev[1:])
    child_gap = (g.top_start[t_idx[1:]] - g.top_start[t_idx[:-1] + 1]).astype(np.int64)
    plo = np.where(rev[:-1], p_idx[1:], p_idx[:-1]) + 1
    phi = np.where(rev[:-1], p_idx[:-1], p_idx[1:])
    par_gap = np.where(phi >= plo,
                       pg.bot_start[np.minimum(phi, pg.num_bottom_segments)] -
                       pg.bot_start[np.minimum(plo, pg.num_bottom_segments)], -1)
    ordered = np.where(rev[:-1], p_idx[1:] <= p_idx[:-1], p_idx[1:] >= p_idx[:-1])
    chain = same & ordered & (child_gap >= 0) & (child_gap < scale) & \
        (par_gap >= 0) & (par_gap < scale)

    starts = np.concatenate([[True], ~chain])
    first = np.flatnonzero(starts)
    last = np.append(first[1:] - 1, n - 1)
    for a, b in zip(first, last):
        c_lo = int(g.top_start[t_idx[a]])
        c_hi = int(g.top_start[t_idx[b] + 1])
        pmin = int(min(pg.bot_start[p_idx[a]], pg.bot_start[p_idx[b]]))
        pmax = int(max(pg.bot_start[p_idx[a] + 1], pg.bot_start[p_idx[b] + 1]))
        ln = min(c_hi - c_lo, pmax - pmin)
        if ln < scale:
            continue
        r = bool(rev[a])
        # trim to equal lengths, anchored to preserve the run's leading edge
        c_hi = c_lo + ln
        if r:
            pmin = pmax - ln
        else:
            pmax = pmin + ln
        out.append((c_lo, c_hi, pmin, pmax, r, canon_flag))
    return out


def _largest_free(c_lo, c_hi, blockers):
    """Largest subinterval of [c_lo, c_hi) not covered by the sorted,
    disjoint `blockers` intervals (None if fully covered)."""
    best = None
    cur = c_lo
    for lo, hi in blockers:
        if hi <= c_lo:
            continue
        if lo >= c_hi:
            break
        if lo > cur and (best is None or lo - cur > best[1] - best[0]):
            best = (cur, lo)
        cur = max(cur, hi)
    if cur < c_hi and (best is None or c_hi - cur > best[1] - best[0]):
        best = (cur, c_hi)
    return best


def _branch_runs(aln, child: str, scale: int, only_orthologs: bool = False):
    """(child_lo, child_hi, parent_lo, parent_hi, rev, canon) runs.
    Canonical matches chain exactly as the ortholog-only model did
    (interleaved paralogs absorb as gaps); paralogous matches chain
    separately, then are trimmed against the canonical runs' child
    coverage so every child base belongs to at most one coarse segment —
    the duplication-retention analogue of the reference's column-sampled
    LodGraph (lod/impl/halLodExtract.cpp), which carries paralogous column
    members into its blocks."""
    g = aln.open_genome(child)
    parent = aln.tree.parent(child)
    pg = aln.open_genome(parent)
    slot = aln.tree.child_index(parent, child)

    t_idx = np.flatnonzero(g.top_parent != NULL_INDEX)
    if len(t_idx) == 0:
        return []
    p_idx = g.top_parent[t_idx]
    rev = g.top_parent_reversed[t_idx].astype(bool)
    canon = pg.bot_child[p_idx, slot] == t_idx

    out = _chain_runs(g, pg, t_idx[canon], p_idx[canon], rev[canon],
                      scale, True)
    if only_orthologs or canon.all():
        return out
    par_runs = _chain_runs(g, pg, t_idx[~canon], p_idx[~canon], rev[~canon],
                           scale, False)
    blockers = sorted((cl, ch) for (cl, ch, _pl, _ph, _r, _c) in out)
    for (cl, ch, pl, ph, r, _c) in par_runs:
        free = _largest_free(cl, ch, blockers)
        if free is None or free[1] - free[0] < scale:
            continue
        nlo, nhi = free
        if r:
            npl, nph = pl + (ch - nhi), ph - (nlo - cl)
        else:
            npl, nph = pl + (nlo - cl), ph - (ch - nhi)
        out.append((nlo, nhi, npl, nph, r, False))
    return out


def extract_lod(aln: Alignment, scale: int, root: str | None = None,
                keep_sequences: bool = False,
                only_orthologs: bool = False) -> Alignment:
    root = root or aln.root_name
    names = list(aln.tree.preorder(root))
    out = Alignment()
    from hal_tpu_torch.tree import Tree

    t = Tree()
    t.add_root(root)
    for n in names:
        for c in aln.tree.children(n):
            t.add_child(n, c, aln.tree.branch_length(c))
    out.tree = t
    out.metadata = dict(aln.metadata)
    out.metadata["lodScale"] = str(scale)

    runs_by_child = {c: _branch_runs(aln, c, scale, only_orthologs)
                     for c in names if c != root}

    # bottom cut sets first (union of children's parent-side run bounds) so
    # each child can refine its top cuts against its parent's bottom grid
    bot_cuts_by_genome = {}
    for name in names:
        cuts = set()
        for c in t.children(name):
            for (_cl, _ch, pl, ph, _r, _canon) in runs_by_child[c]:
                cuts.add(pl)
                cuts.add(ph)
        bot_cuts_by_genome[name] = cuts

    for name in names:
        src = aln.open_genome(name)
        children = t.children(name)
        bot_cuts = bot_cuts_by_genome[name]
        # top breakpoints: own run bounds + projections of the parent's
        # bottom cuts falling inside each run (keeps links 1:1)
        my_runs = runs_by_child.get(name, [])
        top_cuts = set()
        parent_name = t.parent(name)
        parent_cuts = sorted(bot_cuts_by_genome.get(parent_name, set()))
        for (cl, ch, pl, ph, r, _canon) in my_runs:
            top_cuts.add(cl)
            top_cuts.add(ch)
            for pc in parent_cuts:
                if pl < pc < ph:
                    top_cuts.add(cl + (ph - pc) if r else cl + (pc - pl))
        seq_bounds = src.seq_start.tolist()

        def tiles_from(cuts):
            cuts = sorted(set(cuts) | set(seq_bounds))
            return [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]

        bot_tiles = tiles_from(bot_cuts) if children else []
        top_tiles = tiles_from(top_cuts) if name != root else []

        n_seq = src.num_sequences
        infos = []
        bt = np.array([x[0] for x in bot_tiles], np.int64)
        tt = np.array([x[0] for x in top_tiles], np.int64)
        for si in range(n_seq):
            lo, hi = int(src.seq_start[si]), int(src.seq_start[si + 1])
            infos.append(SequenceInfo(
                src.seq_names[si], hi - lo,
                int(((tt >= lo) & (tt < hi)).sum()) if len(tt) else 0,
                int(((bt >= lo) & (bt < hi)).sum()) if len(bt) else 0))
        g = GenomeArrays.create(name, infos, num_children=len(children),
                                store_dna=keep_sequences)
        for i, (a, b) in enumerate(top_tiles):
            g.top_start[i] = a
        for i, (a, b) in enumerate(bot_tiles):
            g.bot_start[i] = a
        if keep_sequences and src.has_dna and src.length:
            g.dna = np.array(src.dna, copy=True)
        g.metadata = dict(src.metadata)
        out._genomes[name] = g

    # ---- links -------------------------------------------------------
    for name in names:
        if name == root:
            continue
        parent = t.parent(name)
        g = out._genomes[name]
        pg = out._genomes[parent]
        slot = t.child_index(parent, name)
        ring_members = {}  # parent tile -> [(canonical?, top tile), ...]
        for (cl, ch, pl, ph, r, canon) in runs_by_child[name]:
            # the run may have been refined by sibling cuts on the parent
            # side: split into pieces per parent tile
            p0 = int(np.searchsorted(pg.bot_start, pl, side="right")) - 1
            p1 = int(np.searchsorted(pg.bot_start, ph - 1, side="right")) - 1
            for pi in range(p0, p1 + 1):
                blo = max(pl, int(pg.bot_start[pi]))
                bhi = min(ph, int(pg.bot_start[pi + 1]))
                if r:
                    tlo = cl + (ph - bhi)
                else:
                    tlo = cl + (blo - pl)
                ti = int(np.searchsorted(g.top_start, tlo, side="right")) - 1
                # refine child tops at these positions too
                g_ok = (int(g.top_start[ti]) == tlo and
                        int(g.top_start[ti + 1]) == tlo + (bhi - blo))
                if not g_ok:
                    continue  # piece boundary not representable; drop link
                bp_ok = (int(pg.bot_start[pi]) == blo and
                         int(pg.bot_start[pi + 1]) == bhi)
                if not bp_ok:
                    continue
                g.top_parent[ti] = pi
                g.top_parent_reversed[ti] = 1 if r else 0
                ring_members.setdefault(pi, []).append((not canon, ti, r))
        # paralogy rings over coarse tops that share one parent tile; the
        # canonical member leads the ring (reference validateDuplications
        # contract, halValidate.cpp:223: disjoint cycles, shared parent).
        # If coarsening dropped the canonical copy, the first surviving
        # paralog is promoted so the parent still reaches the family.
        for pi, members in ring_members.items():
            members.sort()
            _, ti0, r0 = members[0]
            pg.bot_child[pi, slot] = ti0
            pg.bot_child_reversed[pi, slot] = 1 if r0 else 0
            if len(members) < 2:
                continue
            tis = [m[1] for m in members]
            for k, ti in enumerate(tis):
                g.top_paralogy[ti] = tis[(k + 1) % len(tis)]

    # ---- parse links by position ------------------------------------
    for name in names:
        g = out._genomes[name]
        if g.num_top_segments and g.num_bottom_segments:
            g.top_bottom_parse = np.searchsorted(
                g.bot_start, g.top_start[:-1], side="right").astype(np.int64) - 1
            g.bot_top_parse = np.searchsorted(
                g.top_start, g.bot_start[:-1], side="right").astype(np.int64) - 1
    return out

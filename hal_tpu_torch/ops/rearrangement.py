"""Port copy of hal_tpu/ops/rearrangement.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

Rearrangement classification — vectorized gapped-run model.

Replaces the reference's gapped iterators + breakpoint cycle scans
(api/impl/halGappedTopSegmentIterator.cpp 611 LoC,
halGappedBottomSegmentIterator.cpp 573 LoC, halRearrangement.cpp 545 LoC)
with whole-array chain construction over the matched-top-segment arrays:

  1. matched tops (parent != NULL) are chained into *gapped runs* when
     consecutive matches are colinear and separated only by indels
     <= gapThreshold (gap insertions on the child side, clean gap deletions
     on the parent side) — the gapped-segment equivalence,
  2. events are classified per run / per junction with the reference's
     taxonomy (halRearrangement.h:27-39): Insertion, Deletion, Duplication,
     Transposition, Inversion, Gap (GI/GD), Missing (N fraction),
     Complex/Other,
  3. substitutions (transitions/transversions/matches) are bulk DNA
     compares over the matched runs.

Event definitions follow identifyFromLeftBreakpoint
(halRearrangement.cpp:66-133): a reversed run flanked by parent-adjacent
neighbors is an Inversion; an unparented child run is Insertion (> gap
threshold) or GI; a clean unaligned parent range between child-adjacent
runs is Deletion or GD; a run of non-canonical paralogs is a Duplication;
a parented run whose flanks are parent-adjacent to each other is a
Transposition; remaining breaks are Complex.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.constants import NULL_INDEX

DEFAULT_GAP_THRESHOLD = 10   # Rearrangement::DefaultGapThreshold
DEFAULT_N_THRESHOLD = 0.10   # Rearrangement::DefaultNThreshold


@dataclass
class Event:
    kind: str            # I D GI GD V U P DB GDB O M(issing)
    child_lo: int = -1   # child genome coords (NULL for parent-only events)
    child_hi: int = -1
    parent_lo: int = -1  # parent genome coords
    parent_hi: int = -1


@dataclass
class GappedRun:
    """One gapped segment: a maximal chain of matched top segments
    (the reference's GappedTopSegmentIterator equivalence,
    api/impl/halGappedTopSegmentIterator.cpp)."""

    t_first: int   # first/last top segment array index
    t_last: int
    p_min: int     # parent bottom index range touched
    p_max: int
    rev: bool
    canon: bool


@dataclass
class BranchAnalysis:
    events: list = field(default_factory=list)
    runs: list = field(default_factory=list)  # [GappedRun] in child order
    subs: int = 0
    transitions: int = 0
    transversions: int = 0
    matches: int = 0

    def count(self, kind):
        return sum(1 for e in self.events if e.kind == kind)

    def bases(self, kind):
        total = 0
        for e in self.events:
            if e.kind == kind:
                if e.child_lo != -1:
                    total += e.child_hi - e.child_lo
                else:
                    total += e.parent_hi - e.parent_lo
        return total


def _n_fraction(g, lo, hi):
    b = g.get_dna(lo, hi - lo)
    up = np.where((b >= 97) & (b <= 122), b - 32, b)
    return float((up == ord("N")).sum()) / max(hi - lo, 1)


def analyze_branch(aln: Alignment, child: str,
                   gap_threshold: int = DEFAULT_GAP_THRESHOLD,
                   n_threshold: float = DEFAULT_N_THRESHOLD,
                   just_subs: bool = False,
                   do_subs: bool = True) -> BranchAnalysis:
    g = aln.open_genome(child)
    parent = aln.tree.parent(child)
    pg = aln.open_genome(parent)
    slot = aln.tree.child_index(parent, child)
    out = BranchAnalysis()

    t_idx = np.flatnonzero(g.top_parent != NULL_INDEX)
    if len(t_idx) == 0:
        return out
    p_idx = g.top_parent[t_idx]
    rev = g.top_parent_reversed[t_idx].astype(bool)

    # ---- substitutions (bulk; native fast path when built) ----------
    if do_subs and g.has_dna and pg.has_dna and g.dna.size and pg.dna.size:
        from hal_tpu_torch import native

        if native.available():
            c_off = g.top_start[t_idx]
            lens = g.top_start[t_idx + 1] - c_off
            p_off = pg.bot_start[p_idx]
            m, s, ts, tv = native.substitution_stats(
                g.dna, pg.dna, c_off, p_off, lens,
                rev.astype(np.uint8))
            out.matches += m
            out.subs += s
            out.transitions += ts
            out.transversions += tv
            do_subs = False
    if do_subs:
        for k in range(len(t_idx)):
            lo = int(g.top_start[t_idx[k]])
            hi = int(g.top_start[t_idx[k] + 1])
            cb = g.get_dna(lo, hi - lo)
            pb = pg.get_dna(int(pg.bot_start[p_idx[k]]), hi - lo, reversed_=bool(rev[k]))
            cu = np.where((cb >= 97) & (cb <= 122), cb - 32, cb)
            pu = np.where((pb >= 97) & (pb <= 122), pb - 32, pb)
            ok = (cu != ord("N")) & (pu != ord("N"))
            eq = ok & (cu == pu)
            ne = ok & ~eq
            out.matches += int(eq.sum())
            out.subs += int(ne.sum())
            c_pur = np.isin(cu, [ord("A"), ord("G")])
            p_pur = np.isin(pu, [ord("A"), ord("G")])
            out.transitions += int((ne & (c_pur == p_pur)).sum())
            out.transversions += int((ne & (c_pur != p_pur)).sum())
    if just_subs:
        return out

    # ---- gapped-run construction ------------------------------------
    t_seq = g.seq_index_at(g.top_start[t_idx])
    p_seq = pg.seq_index_at(pg.bot_start[p_idx])
    canon = pg.bot_child[p_idx, slot] == t_idx

    # per-bottom unaligned indicator with prefix sums (clean-deletion check)
    unchilded = pg.bot_child[:, slot] == NULL_INDEX
    pre = np.concatenate([[0], np.cumsum(unchilded.astype(np.int64))])

    n = len(t_idx)
    t1, t2 = t_idx[:-1], t_idx[1:]
    p1, p2 = p_idx[:-1], p_idx[1:]
    r1, r2 = rev[:-1], rev[1:]
    same = (t_seq[:-1] == t_seq[1:]) & (p_seq[:-1] == p_seq[1:]) & (r1 == r2) & \
        (canon[:-1] == canon[1:])  # duplication cycles break gapped runs
    # child-side gap bases between consecutive matches
    child_gap = (g.top_start[t2] - g.top_start[t1 + 1]).astype(np.int64)
    # parent-side gap (direction-aware)
    plo = np.where(r1, p2, p1) + 1
    phi = np.where(r1, p1, p2)
    par_gap_segs = np.maximum(phi - plo, 0)
    par_gap = np.where(phi > plo,
                       pg.bot_start[np.minimum(phi, pg.num_bottom_segments)] -
                       pg.bot_start[np.minimum(plo, pg.num_bottom_segments)], 0)
    par_adj = np.where(r1, p1 == p2 + 1, p2 == p1 + 1)
    par_clean = (pre[np.minimum(phi, pg.num_bottom_segments)] -
                 pre[np.minimum(plo, pg.num_bottom_segments)]) == par_gap_segs

    # junction chains: 'm' colinear, 'gi' small child gap, 'gd' small clean
    # parent gap, 'gg' BOTH a small child gap and a small clean parent gap
    # (the reference's gapped iterators take gap-insertion and gap-deletion
    # extension steps independently, so one junction can carry both —
    # exercised by RearrangementGappedInversionTest,
    # api/tests/halRearrangementTest.cpp:124-196); everything else breaks
    # the gapped run
    small_cgap = (child_gap > 0) & (child_gap <= gap_threshold)
    small_pgap = par_clean & (par_gap > 0) & (par_gap <= gap_threshold)
    j_m = same & (child_gap == 0) & par_adj
    j_gi = same & small_cgap & par_adj
    j_gd = same & (child_gap == 0) & ~par_adj & small_pgap
    j_gg = same & small_cgap & ~par_adj & small_pgap
    chain = j_m | j_gi | j_gd | j_gg

    for k in np.flatnonzero(j_gi | j_gg):
        out.events.append(Event("GI", int(g.top_start[t1[k] + 1]), int(g.top_start[t2[k]])))
    for k in np.flatnonzero(j_gd | j_gg):
        out.events.append(Event("GD", parent_lo=int(pg.bot_start[plo[k]]),
                                parent_hi=int(pg.bot_start[phi[k]])))

    # runs of matches
    starts = np.concatenate([[True], ~chain])
    run_id = np.cumsum(starts) - 1
    n_runs = int(run_id[-1]) + 1
    run_first = np.flatnonzero(starts)
    run_last = np.append(run_first[1:] - 1, n - 1)

    # per-run facts
    run_rev = rev[run_first]
    run_canon = np.ones(n_runs, bool)
    np.logical_and.at(run_canon, run_id, canon)
    run_child_lo = g.top_start[t_idx[run_first]]
    run_child_hi = g.top_start[t_idx[run_last] + 1]
    run_p_min = np.minimum(pg.bot_start[p_idx[run_first]], pg.bot_start[p_idx[run_last]])
    run_p_max = np.maximum(pg.bot_start[p_idx[run_first] + 1], pg.bot_start[p_idx[run_last] + 1])
    run_t_seq = t_seq[run_first]
    run_p_seq = p_seq[run_first]

    for ri in range(n_runs):
        out.runs.append(GappedRun(
            int(t_idx[run_first[ri]]), int(t_idx[run_last[ri]]),
            int(min(p_idx[run_first[ri]], p_idx[run_last[ri]])),
            int(max(p_idx[run_first[ri]], p_idx[run_last[ri]])),
            bool(run_rev[ri]), bool(run_canon[ri])))

    def missing(lo, hi):
        return _n_fraction(g, int(lo), int(hi)) >= n_threshold

    # ---- per-run events ---------------------------------------------
    for ri in range(n_runs):
        c_lo, c_hi = int(run_child_lo[ri]), int(run_child_hi[ri])
        p_lo, p_hi = int(run_p_min[ri]), int(run_p_max[ri])
        if not run_canon[ri]:
            # duplication: run of non-canonical paralog copies
            out.events.append(Event("M" if missing(c_lo, c_hi) else "U",
                                    c_lo, c_hi, p_lo, p_hi))
            continue
        if run_rev[ri]:
            # inversion if flanking runs are parent-adjacent to this one
            out.events.append(Event("M" if missing(c_lo, c_hi) else "V",
                                    c_lo, c_hi, p_lo, p_hi))
            continue
        # transposition: flanking runs adjacent to each other in parent but
        # this run's parent elsewhere
        left_ri, right_ri = ri - 1, ri + 1
        if 0 <= left_ri and right_ri < n_runs and \
                run_t_seq[left_ri] == run_t_seq[ri] == run_t_seq[right_ri]:
            gap_l = run_child_lo[ri] - run_child_hi[left_ri]
            gap_r = run_child_lo[right_ri] - run_child_hi[ri]
            if gap_l == 0 and gap_r == 0 and run_p_seq[left_ri] == run_p_seq[right_ri]:
                lf, rf = run_last[left_ri], run_first[right_ri]
                adj = (pg.bot_start[p_idx[rf]] == pg.bot_start[p_idx[lf] + 1]) or \
                      (pg.bot_start[p_idx[lf]] == pg.bot_start[p_idx[rf] + 1])
                sep = not (run_p_min[ri] < run_p_max[left_ri] and
                           run_p_max[ri] > run_p_min[left_ri])
                if adj and sep:
                    out.events.append(Event("M" if missing(c_lo, c_hi) else "P",
                                            c_lo, c_hi, p_lo, p_hi))

    # ---- insertions: maximal unparented child runs -------------------
    unparented = g.top_parent == NULL_INDEX
    if unparented.any():
        u = np.flatnonzero(unparented)
        brk = np.concatenate([[True], np.diff(u) != 1])
        ustarts = u[brk]
        uid = np.cumsum(brk) - 1
        uends = np.zeros(int(uid[-1]) + 1, np.int64)
        np.maximum.at(uends, uid, u + 1)
        for s, e in zip(ustarts, uends):
            lo = int(g.top_start[s])
            hi = int(g.top_start[e])
            # keep within one sequence
            if g.seq_index_at(lo) != g.seq_index_at(hi - 1):
                continue
            if missing(lo, hi):
                out.events.append(Event("M", lo, hi))
            elif hi - lo > gap_threshold:
                out.events.append(Event("I", lo, hi))
            elif not any(e2.kind == "GI" and e2.child_lo == lo for e2 in out.events):
                out.events.append(Event("GI", lo, hi))

    # ---- deletions: clean unaligned parent ranges between ADJACENT child
    # tops.  The reference's scanDeletionCycle forward-normalizes both
    # parents and swaps them ("don't care about inversions",
    # halRearrangement.cpp:446-500), so the flanking tops' orientations
    # need not match — only parent-sequence identity and a childless
    # flanked range matter
    nb = pg.num_bottom_segments
    tops_adj = (t2 == t1 + 1) & (t_seq[:-1] == t_seq[1:])
    same_pseq = p_seq[:-1] == p_seq[1:]
    plo2 = np.minimum(p1, p2) + 1
    phi2 = np.maximum(p1, p2)
    clean2 = (pre[np.minimum(phi2, nb)] - pre[np.minimum(plo2, nb)]) == \
        np.maximum(phi2 - plo2, 0)
    gap2 = np.where(phi2 > plo2,
                    pg.bot_start[np.minimum(phi2, nb)] -
                    pg.bot_start[np.minimum(plo2, nb)], 0)
    del_cycle = tops_adj & same_pseq & (phi2 > plo2) & clean2
    j_del = del_cycle & (gap2 > gap_threshold)
    for k in np.flatnonzero(j_del):
        pl, ph = int(pg.bot_start[plo2[k]]), int(pg.bot_start[phi2[k]])
        out.events.append(Event("D", parent_lo=pl, parent_hi=ph))
        out.events.append(Event("DB", int(g.top_start[t1[k] + 1] - 1),
                                int(g.top_start[t2[k]]) + 1, pl, ph))
    # small clean deletions at junctions the run chaining didn't absorb
    # (e.g. between opposite-orientation flanks) are Gap events
    # (identifyFromLeftBreakpoint's `<= gapThreshold -> Gap`,
    # halRearrangement.cpp:86-88)
    for k in np.flatnonzero(del_cycle & (gap2 <= gap_threshold) & ~chain):
        out.events.append(Event("GD", parent_lo=int(pg.bot_start[plo2[k]]),
                                parent_hi=int(pg.bot_start[phi2[k]])))

    # ---- complex/other: junctions that neither chain nor classify.
    # Cross-sequence junctions are array-scan artifacts, not breakpoints
    # (the reference's iterators never evaluate across a sequence end)
    for k in np.flatnonzero((~chain) & ~del_cycle &
                            (t_seq[:-1] == t_seq[1:])):
        out.events.append(Event("O", int(g.top_start[t1[k] + 1] - 1),
                                int(g.top_start[t2[k]]) + 1))
    return out

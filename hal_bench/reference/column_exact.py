"""Frozen copy of hal_tpu_torch/ops/column.py for the benchmark's plain reference (numpy
only; the same code, imports pointing at hal_bench.reference).  It is the
yardstick: the port may change, this copy does not.

Column engine: multiple-alignment columns relative to a reference window.

Re-designs the reference's ColumnIterator (api/impl/halColumnIterator.cpp,
832 LoC of recursive per-column tree spreading with an explicit stack) as a
*block-parallel* computation:

  1. for every genome in scope, map the whole reference window to it with
     the batched segment mapper (dupes follow paralogy rings coalescing
     anywhere under the scope root — equivalent to the recursive
     updateParent/updateChild/updateNextTopDup spreading),
  2. cut all fragments at the union of their reference-coordinate
     boundaries: between consecutive breakpoints every row advances
     contiguously, so each atomic slice is a run of identical columns,
  3. stream slices through a MafBlock builder that reproduces the
     reference's entry persistence/gap/break rules
     (maf/impl/halMafBlock.cpp: initBlock :294, appendColumn :370,
     canAppendColumn :401, printBlock :499).

Row order inside a column follows the reference's SequenceLess (genome
name, then sequence index — api/inc/halColumnIterator.h:45-50); dupe rows
within one sequence are ordered by forward target position (the reference's
order there is traversal-dependent; ours is the deterministic equivalent).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from hal_bench.reference.alignment import Alignment
from hal_bench.reference import segmap_host as sm


@dataclass(slots=True)
class Row:
    """One aligned run within a slice (a future MAF 's' entry chunk)."""

    genome: str
    seq_idx: int
    tgt_lo: int
    tgt_hi: int
    rev: bool
    is_ref: bool = False


def _row_key(r: Row):
    """SequenceLess (halColumnIterator.h:45-50); python sorts are stable so
    duplicate rows keep DFS insertion order."""
    return (r.genome, r.seq_idx)


@dataclass(slots=True)
class Slice:
    """Atomic reference slice [lo, hi) with its aligned rows.

    width: number of alignment columns.  Normally hi - lo; insertion
    slices (maxRefGap > 0) have lo == hi and width == inserted bases —
    the reference row shows '-' there (reference handleInsertion,
    halColumnIterator.cpp:382-440).
    sorted_rows: rows are already in SequenceLess order (builders skip the
    per-slice re-sort)."""

    lo: int
    hi: int
    rows: list = field(default_factory=list)
    width: int = -1
    sorted_rows: bool = False

    def __post_init__(self):
        if self.width < 0:
            self.width = self.hi - self.lo


@dataclass
class TreeNode:
    """Gene-tree node for --printTree (reference MafBlock::buildTreeR,
    maf/impl/halMafBlock.cpp:203-237): one node per segment visited by the
    root-down spread; label = entry name when a block row matches, else the
    genome name (ancestor without sequence output)."""

    genome: str
    pos: int        # genome coordinate of the column base
    rev: bool
    label: str = ""
    row_key: tuple | None = None   # (genome, seq_idx, fwd_pos, rev) of matched row
    children: list = field(default_factory=list)

    def newick(self) -> str:
        if self.children:
            return "(%s)%s" % (",".join(c.newick() for c in self.children),
                               self.label)
        return self.label

    def same_shape(self, other: "TreeNode") -> bool:
        """Topology+label equality (stTree_equals in canAppendColumn,
        halMafBlock.cpp:443-448); positions excluded — labels carry
        genome/sequence identity only."""
        if self.label != other.label or len(self.children) != len(other.children):
            return False
        return all(a.same_shape(b) for a, b in zip(self.children, other.children))


def compute_scope(aln: Alignment, ref: str, targets=None, root: str | None = None):
    """Genomes participating in column construction + the scope root
    (reference getGenomesInSpanningTree usage, halColumnIterator.h:117)."""
    tree = aln.tree
    if root is not None:
        scope = set(tree.postorder(root))
        if ref not in scope:
            raise ValueError("reference genome %s not under root %s" % (ref, root))
    elif targets:
        scope = tree.spanning_tree(sorted(set(targets) | {ref}))
    else:
        scope = set(tree.names())
    scope_root = min(scope, key=lambda n: tree.depth(n))
    return scope, scope_root


def window_fragments(aln: Alignment, ref: str, gs: int, ge: int, scope, scope_root,
                     do_dupes: bool = True):
    """Per-genome fragments of the reference window (ref coords in src)."""
    out = {}
    for g in sorted(scope):
        frags = sm.map_source(aln, ref, np.array([gs]), np.array([ge]), g,
                              do_dupes=do_dupes,
                              coalescence_limit=scope_root)
        if len(frags):
            out[g] = frags
    return out


def _column_root(aln: Alignment, genome: str, pos: int):
    """Walk up from (genome, pos) to the column's root segment
    (reference MafBlock::buildTree up-walk, halMafBlock.cpp:258-281).
    Returns (root_genome_name, root_pos, rev)."""
    tree = aln.tree
    rev = False
    while True:
        g = aln.open_genome(genome)
        if g.num_top_segments == 0:
            return genome, pos, rev
        i = int(g.top_index_at(pos))
        pi = int(g.top_parent[i])
        if pi < 0:
            return genome, pos, rev
        parent = tree.parent(genome)
        pg = aln.open_genome(parent)
        off = pos - int(g.top_start[i])
        seg_len = int(g.top_start[i + 1] - g.top_start[i])
        prev = bool(g.top_parent_reversed[i])
        ppos = (int(pg.bot_start[pi]) + (seg_len - 1 - off) if prev
                else int(pg.bot_start[pi]) + off)
        genome, pos, rev = parent, ppos, rev ^ prev


def _tree_node(aln, genome, pos, rev) -> TreeNode:
    g = aln.open_genome(genome)
    si = int(np.searchsorted(g.seq_start, pos, side="right")) - 1
    fwd = pos  # single base; forward coordinate
    return TreeNode(genome=genome, pos=pos, rev=rev,
                    row_key=(genome, si, fwd, rev))


def _build_tree_down(aln, node: TreeNode) -> None:
    """Recursive down-spread mirroring MafBlock::buildTreeR
    (halMafBlock.cpp:203-237): canonical child + its paralogy-ring
    members, each recursed into."""
    tree = aln.tree
    g = aln.open_genome(node.genome)
    if g.num_bottom_segments == 0:
        return
    bi = int(g.bot_index_at(node.pos))
    off = node.pos - int(g.bot_start[bi])
    seg_len = int(g.bot_start[bi + 1] - g.bot_start[bi])
    for slot, child in enumerate(tree.children(node.genome)):
        j = int(g.bot_child[bi, slot])
        if j < 0:
            continue
        cg = aln.open_genome(child)
        crev = bool(g.bot_child_reversed[bi, slot])
        cpos = (int(cg.top_start[j]) + (seg_len - 1 - off) if crev
                else int(cg.top_start[j]) + off)
        cn = _tree_node(aln, child, cpos, node.rev ^ crev)
        node.children.append(cn)
        _build_tree_down(aln, cn)
        # paralogy ring of the canonical child segment
        if cg.top_paralogy.shape[0] and int(cg.top_paralogy[j]) >= 0:
            coff = cpos - int(cg.top_start[j])
            m = int(cg.top_paralogy[j])
            while m != j and m >= 0:
                mlen = int(cg.top_start[m + 1] - cg.top_start[m])
                flip = bool(cg.top_parent_reversed[m]) != bool(cg.top_parent_reversed[j])
                mpos = (int(cg.top_start[m]) + (mlen - 1 - coff) if flip
                        else int(cg.top_start[m]) + coff)
                mn = _tree_node(aln, child, mpos, cn.rev ^ flip)
                node.children.append(mn)
                _build_tree_down(aln, mn)
                m = int(cg.top_paralogy[m])


def build_gene_tree(aln: Alignment, ref: str, pos: int) -> TreeNode:
    """Per-column gene tree rooted at the column's root segment
    (reference MafBlock::buildTree, halMafBlock.cpp:239-293).  Node
    row_keys identify the slice row (genome, seq_idx, fwd position, rev)
    so the MAF builder can label nodes with entry names and print s-lines
    in tree post-order."""
    genome, rpos, rev = _column_root(aln, ref, pos)
    root = _tree_node(aln, genome, rpos, rev)
    _build_tree_down(aln, root)
    return root


# ------------------------------------------------------------- exact DFS
#
# Byte-exact MAF output needs the reference ColumnIterator's *insertion
# order* of duplicate rows within a sequence (the MafBlock multimap keeps
# per-sequence entries in insertion order, halMafBlock.cpp:294-368).  The
# recursion below mirrors recursiveUpdate/updateParent/updateChild/
# updateNextTopDup/updateParseUp/updateParseDown
# (api/impl/halColumnIterator.cpp:246-356, 557-745) exactly, hoisted from
# per-column to per-run: within a run no visited segment boundary is
# crossed, so the DFS shape — and therefore row order — is constant.

class _GT:
    """Per-genome tables as plain Python lists: the DFS reads scalar fields
    tens of times per run; list indexing (~40 ns) beats numpy scalar access
    (~250 ns per int(arr[i])) ~6x, which is the difference between the
    exact column path streaming at mammal density or not.  Memory is
    ~300 B/segment transient per genome — bounded by the scope, freed with
    the DFS object."""

    __slots__ = ("top_start", "top_parent", "top_rev", "top_para",
                 "bot_start", "bot_child", "bot_crev", "bot_tparse",
                 "top_bparse", "seq_start", "seq_top", "seq_bot", "n_top",
                 "n_bot", "single_seq", "children", "parent", "gen", "name")

    def __init__(self, aln, tree, name):
        gen = aln.open_genome(name)
        self.gen = gen
        self.name = name
        nt = gen.num_top_segments
        nb = gen.num_bottom_segments
        self.n_top = nt
        self.n_bot = nb
        self.top_start = gen.top_start[:nt + 1].tolist()
        self.top_parent = gen.top_parent[:nt].tolist()
        self.top_rev = gen.top_parent_reversed[:nt].tolist()
        self.top_para = (gen.top_paralogy[:nt].tolist()
                         if gen.top_paralogy.shape[0] else [])
        self.bot_start = gen.bot_start[:nb + 1].tolist()
        self.bot_child = [gen.bot_child[:nb, s].tolist()
                          for s in range(gen.bot_child.shape[1])] if nb else []
        self.bot_crev = [gen.bot_child_reversed[:nb, s].tolist()
                         for s in range(gen.bot_child.shape[1])] if nb else []
        self.bot_tparse = (gen.bot_top_parse[:nb].tolist()
                           if gen.bot_top_parse.shape[0] else [])
        self.top_bparse = (gen.top_bottom_parse[:nt].tolist()
                           if gen.top_bottom_parse.shape[0] else [])
        self.seq_start = gen.seq_start.tolist()
        self.seq_top = gen.seq_top.tolist()
        self.seq_bot = gen.seq_bot.tolist()
        self.single_seq = gen.num_sequences <= 1
        self.parent = tree.parent(name)
        self.children = tree.children(name)


class ColumnDFS:
    """One reference column's tree spreading, with run-length tracking."""

    def __init__(self, aln: Alignment, ref: str, scope=None, targets=None,
                 no_dupes=False, no_ancestors=False, only_orthologs=False,
                 max_ref_gap: int = 0, track_visits: bool = False):
        self.aln = aln
        self.tree = aln.tree
        self.ref = ref
        self.scope = scope          # None/empty = everything in scope
        self.targets = targets      # None/empty = insert everything
        self.no_dupes = no_dupes
        self.no_ancestors = no_ancestors
        self.only_orthologs = only_orthologs
        self.max_ref_gap = max_ref_gap
        self.track_visits = track_visits or max_ref_gap > 0
        self._g = {}
        self._t = {}
        self._leaf = {}
        self._slot = {}

    def g(self, name):
        gen = self._g.get(name)
        if gen is None:
            gen = self._g[name] = self.aln.open_genome(name)
        return gen

    def t(self, name) -> _GT:
        tab = self._t.get(name)
        if tab is None:
            tab = self._t[name] = _GT(self.aln, self.tree, name)
        return tab

    def is_leaf(self, name):
        v = self._leaf.get(name)
        if v is None:
            v = self._leaf[name] = self.tree.is_leaf(name)
        return v

    def _parent_in_scope(self, gname):
        return not self.scope or self.tree.parent(gname) in self.scope

    def _child_in_scope(self, gname, child):
        return not self.scope or child in self.scope

    # ---- one column -----------------------------------------------------
    def run(self, pos: int):
        """DFS from reference position `pos` (genome coords, forward).

        Returns (rows, run_limit, ref_positions) where rows is the ordered
        list of (genome, pos, rev) inserted into the column, run_limit the
        number of columns before any visited segment boundary, and
        ref_positions every visited reference-genome base as (pos, rev)
        (the _leftmostRefPos feed, halColumnIterator.cpp:812-815)."""
        return self.run_from(self.ref, pos, False)

    def run_from(self, genome: str, pos: int, rev: bool):
        """DFS from any (genome, pos, rev) — `rev` walks the entry
        right-to-left (a reversed indel stack entry,
        halColumnIteratorStack.h:50).  Sub-reference walks of insertion/
        deletion stack entries use this with genome != self.ref."""
        from bisect import bisect_right

        self.rows = []
        self.ref_pos = []
        if self.max_ref_gap > 0:
            # (table, seg, rem, node_rev) discovery sites, in DFS order
            self.del_sites = []
            self.ins_sites = []
        if self.track_visits:
            # every visited (genome, pos, rev) BEFORE the noAncestors /
            # targets output filters — the reference's visit cache records
            # visited positions regardless of output filtering
            # (colMapInsert caches first, filters after,
            # halColumnIterator.cpp:766-800)
            self.visits = []
        t = self.t(genome)
        gen = t.gen
        si = 0 if t.single_seq else int(gen.seq_index_at(pos))
        seq_has_tops = int(gen.seq_top[si + 1] - gen.seq_top[si]) > 0
        # clamp the run at the reference sequence end (toRight jumps
        # sequences, re-initializing iterators)
        self.limit = (pos - t.seq_start[si] + 1) if rev else (
            t.seq_start[si + 1] - pos)
        if seq_has_tops:
            i = bisect_right(t.top_start, pos) - 1
            self._limit_seg(t.top_start, i, pos, rev)
            self._insert(genome, pos, rev)
            if self.max_ref_gap > 0:
                self._site(self.del_sites, t, i, pos, rev)
            self._update_parent(genome, t, i, pos, rev)
            if not self.only_orthologs:
                self._next_top_dup(genome, t, i, pos, rev)
            self._parse_down(genome, t, i, pos, rev)
        else:
            b = bisect_right(t.bot_start, pos) - 1
            self._limit_seg(t.bot_start, b, pos, rev)
            self._insert(genome, pos, rev)
            for slot, child in enumerate(t.children):
                self._update_child(genome, t, b, pos, rev, slot, child)
        return self.rows, self.limit, self.ref_pos

    @staticmethod
    def _site(sites, t, i, pos, rev):
        """Record an indel discovery site: the reference evaluates handle
        Deletion/handleInsertion at every column but they fire only when
        the iterator's end offset is 0 — i.e. when the run ends exactly at
        this segment's traversal-end (rem == run, checked by the caller)."""
        rem = (pos - t.top_start[i] + 1) if rev else (t.top_start[i + 1] - pos)
        sites.append((t, i, rem, rev))

    # ---- helpers ----------------------------------------------------------
    def _limit_seg(self, starts, i, pos, rev):
        rem = (pos - starts[i] + 1) if rev else (starts[i + 1] - pos)
        if rem < self.limit:
            self.limit = rem

    def _insert(self, gname, pos, rev):
        if gname == self.ref:
            self.ref_pos.append((pos, rev))
        if self.track_visits:
            self.visits.append((gname, pos, rev))
        if self.no_ancestors and not self.is_leaf(gname):
            return
        if self.targets and gname not in self.targets:
            return
        self.rows.append((gname, pos, rev))

    def _is_canonical(self, gname, t, i):
        pi = t.top_parent[i]
        if pi < 0:
            return False
        slot = self._slot_of(t.parent, gname)
        return self.t(t.parent).bot_child[slot][pi] == i

    def _slot_of(self, parent, child):
        key = (parent, child)
        s = self._slot.get(key)
        if s is None:
            s = self._slot[key] = self.tree.child_index(parent, child)
        return s

    # ---- recursion (halColumnIterator.cpp:557-745) -------------------------
    def _update_parent(self, gname, t, i, pos, rev):
        pi = t.top_parent[i]
        if pi < 0 or not self._parent_in_scope(gname):
            return
        if self.no_dupes and not self._is_canonical(gname, t, i):
            return
        parent = t.parent
        pt = self.t(parent)
        prev = t.top_rev[i] != 0
        off = pos - t.top_start[i]
        seg_len = t.top_start[i + 1] - t.top_start[i]
        ppos = pt.bot_start[pi] + ((seg_len - 1 - off) if prev else off)
        nrev = rev ^ prev
        self._limit_seg(pt.bot_start, pi, ppos, nrev)
        self._insert(parent, ppos, nrev)
        self._parse_up(parent, pt, pi, ppos, nrev)
        my_slot = self._slot_of(parent, gname)
        for slot, child in enumerate(pt.children):
            if slot != my_slot:
                self._update_child(parent, pt, pi, ppos, nrev, slot, child)

    def _update_child(self, gname, t, b, pos, rev, slot, child):
        j = t.bot_child[slot][b]
        if j < 0 or not self._child_in_scope(gname, child):
            return
        ct = self.t(child)
        crev = t.bot_crev[slot][b] != 0
        off = pos - t.bot_start[b]
        seg_len = t.bot_start[b + 1] - t.bot_start[b]
        cpos = ct.top_start[j] + ((seg_len - 1 - off) if crev else off)
        nrev = rev ^ crev
        self._limit_seg(ct.top_start, j, cpos, nrev)
        self._insert(child, cpos, nrev)
        if self.max_ref_gap > 0:
            self._site(self.ins_sites, ct, j, cpos, nrev)
        self._next_top_dup(child, ct, j, cpos, nrev)
        self._parse_down(child, ct, j, cpos, nrev)

    def _next_top_dup(self, gname, t, i, pos, rev):
        if (self.no_dupes or not t.top_para or t.top_para[i] < 0
                or t.parent is None or not self._parent_in_scope(gname)):
            return
        first = i
        para = t.top_para
        starts = t.top_start
        trev = t.top_rev
        cur, cpos, crev = i, pos, rev
        while True:
            m = para[cur]
            flip = trev[cur] != trev[m]
            off = cpos - starts[cur]
            seg_len = starts[cur + 1] - starts[cur]
            mpos = starts[m] + ((seg_len - 1 - off) if flip else off)
            mrev = crev ^ flip
            self._limit_seg(starts, m, mpos, mrev)
            self._insert(gname, mpos, mrev)
            if self.max_ref_gap > 0:
                self._site(self.ins_sites, t, m, mpos, mrev)
            self._parse_down(gname, t, m, mpos, mrev)
            cur, cpos, crev = m, mpos, mrev
            nxt = para[cur]
            if nxt < 0 or nxt == first:
                break

    def _parse_up(self, gname, t, b, pos, rev):
        if not t.bot_tparse or t.bot_tparse[b] < 0:
            return
        from bisect import bisect_right

        i = bisect_right(t.top_start, pos) - 1
        self._limit_seg(t.top_start, i, pos, rev)
        self._update_parent(gname, t, i, pos, rev)
        if not self.only_orthologs:
            self._next_top_dup(gname, t, i, pos, rev)
        # deletion site registered AFTER the parse-up recursion, matching
        # the reference's call order in updateParent (handleDeletion at
        # halColumnIterator.cpp:594 runs after updateParseUp returns)
        if self.max_ref_gap > 0:
            self._site(self.del_sites, t, i, pos, rev)

    def _parse_down(self, gname, t, i, pos, rev):
        if not t.top_bparse or t.top_bparse[i] < 0:
            return
        from bisect import bisect_right

        b = bisect_right(t.bot_start, pos) - 1
        self._limit_seg(t.bot_start, b, pos, rev)
        for slot, child in enumerate(t.children):
            self._update_child(gname, t, b, pos, rev, slot, child)

    # ---- indel stacks (halColumnIterator.cpp:357-440, atomic
    # rearrangement scans halRearrangement.cpp:368-518) -------------------

    @staticmethod
    def _seq_span(bounds, i):
        """(first, last) segment index of the sequence owning segment i,
        given the per-sequence first-segment table (seq_top / seq_bot)."""
        from bisect import bisect_right

        s = bisect_right(bounds, i) - 1
        return bounds[s], bounds[s + 1] - 1

    def _eval_del_site(self, t: _GT, i: int, o: bool, cum: int):
        """handleDeletion, atomic: fires when segment i's parent and its
        iterator-right neighbour's parent flank EXACTLY ONE child-less
        bottom segment (or, at a sequence end, when the parent has an
        unaligned neighbour).  Returns (genome, first, last, reversed) of
        the deleted parent range, or None."""
        pi = t.top_parent[i]
        if pi < 0 or t.parent is None:
            return None
        pt = self.t(t.parent)
        slot = self._slot_of(t.parent, t.name)
        pori = o ^ (t.top_rev[i] != 0)
        pfirst, plast = self._seq_span(pt.seq_bot, pi)
        sfirst, slast = self._seq_span(t.seq_top, i)
        if (i == sfirst) if o else (i == slast):
            # sequence endpoint: candidate = parent's iterator-left
            # neighbour, else iterator-right (scanDeletionCycle case 1)
            p_is_first = (pi == plast) if pori else (pi == pfirst)
            p_is_last = (pi == pfirst) if pori else (pi == plast)
            if not p_is_first:
                cand = pi + 1 if pori else pi - 1
            elif not p_is_last:
                cand = pi - 1 if pori else pi + 1
            else:
                return None
        else:
            j = i - 1 if o else i + 1
            pj = t.top_parent[j]
            if pj < 0:
                return None
            lo_i, hi_i = (pi, pj) if pi <= pj else (pj, pi)
            # forward-normalized: parents in the same sequence flanking
            # exactly one segment (adjacentTo after one toRight)
            if hi_i != lo_i + 2 or self._seq_span(pt.seq_bot, pj) != (pfirst, plast):
                return None
            cand = lo_i + 1
        if pt.bot_child and pt.bot_child[slot][cand] >= 0:
            return None  # source of a transposition, not a deletion
        lo = pt.bot_start[cand]
        hi = pt.bot_start[cand + 1]
        if hi - lo + cum > self.max_ref_gap:
            return None
        return (t.parent, lo, hi - 1, pori)

    def _eval_ins_site(self, t: _GT, i: int, o: bool, cum: int):
        """handleInsertion, atomic: fires when segment i's iterator-right
        neighbour j is parentless and the insertion cycle closes (the
        parentless run is flanked by segments whose parents are adjacent,
        or a sequence endpoint is involved).  Returns the (genome, first,
        last, reversed) of segment j ONLY — the reference walks just the
        breakpoint-adjacent segment; deeper parentless segments never
        re-trigger handleInsertion (hasParent guard) — or None."""
        if t.top_parent[i] < 0:
            return None
        sfirst, slast = self._seq_span(t.seq_top, i)
        if (i == sfirst) if o else (i == slast):
            return None  # isLast in iterator orientation
        step = -1 if o else 1
        j = i + step
        if t.top_parent[j] >= 0:
            return None
        # eat the adjacent parentless run (scanInsertionCycle:373-381)
        k = j
        while True:
            nxt = k + step
            if (nxt < sfirst or nxt > slast) or t.top_parent[nxt] >= 0:
                break
            k = nxt
        first_iter = (j == slast) if o else (j == sfirst)
        last_iter = (k == sfirst) if o else (k == slast)
        if not (first_iter or last_iter):
            b = k + step
            pa, pb = t.top_parent[i], t.top_parent[b]
            if pb < 0:
                return None
            pt = self.t(t.parent)
            fa, la = self._seq_span(pt.seq_bot, pa)
            fb, lb = self._seq_span(pt.seq_bot, pb)
            if abs(pa - pb) == 1:
                pass  # parents adjacent: cycle closes
            elif (fa, la) == (fb, lb) and (pa in (fa, la) or pb in (fb, lb)):
                pass  # flanking parent at a sequence endpoint
            else:
                return None
        lo = t.top_start[j]
        hi = t.top_start[j + 1]
        if hi - lo + cum > self.max_ref_gap:
            return None
        return (t.name, lo, hi - 1, o)

    def collect_indels(self, run: int, cum: int):
        """Evaluate this run's discovery sites (those whose segment ends
        exactly at the run's last column) and return new stack entries,
        ordered for a pop-from-end walk: deletions REVERSED, then
        insertions in discovery order — so insertions drain first in
        reverse-discovery order, then deletions in discovery order
        (toRight's pushStackReversed(deletions) + pushStack(insertions),
        halColumnIterator.cpp:122-123).  Entry cumulative sizes replicate
        ColumnIteratorStack::push (first entry of a fresh stack: 0)."""
        del_entries = []
        for (t, i, rem, o) in self.del_sites:
            if rem != run:
                continue
            r = self._eval_del_site(t, i, o, cum)
            if r is not None:
                g, first, last, erev = r
                c = (0 if not del_entries
                     else del_entries[-1][5] + (last - first + 1))
                del_entries.append([g, last if erev else first, first, last,
                                    erev, c])
        ins_entries = []
        for (t, i, rem, o) in self.ins_sites:
            if rem != run:
                continue
            r = self._eval_ins_site(t, i, o, cum)
            if r is not None:
                g, first, last, erev = r
                c = (0 if not ins_entries
                     else ins_entries[-1][5] + (last - first + 1))
                ins_entries.append([g, last if erev else first, first, last,
                                    erev, c])
        return del_entries[::-1] + ins_entries


def _make_rows(dfs, rows, k, mark_ref):
    """Row objects for a k-column run; row direction decides the target
    range ([p, p+k) forward, [p-k+1, p+1) reversed)."""
    from bisect import bisect_right

    out_rows = []
    for (gname, p, rev) in rows:
        t = dfs.t(gname)
        si = 0 if t.single_seq else bisect_right(t.seq_start, p) - 1
        if rev:
            out_rows.append(Row(gname, si, p - k + 1, p + 1, True))
        else:
            out_rows.append(Row(gname, si, p, p + k, False))
    if out_rows and mark_ref:
        out_rows[0].is_ref = True
    out_rows.sort(key=_row_key)  # stable: keeps DFS order within a sequence
    return out_rows


def iter_slices_exact(aln: Alignment, ref: str, gs: int, ge: int,
                      scope=None, targets=None, no_dupes=False,
                      no_ancestors=False, only_orthologs=False,
                      unique=False, max_ref_gap: int = 0,
                      shared_visit: dict | None = None):
    """Yield Slices over [gs, ge) with reference-exact row order.

    Rows come back sorted by SequenceLess (genome name, sequence index —
    halColumnIterator.h:45-50) with duplicates within a sequence in DFS
    insertion order (stable sort).  unique implements the visit-cache
    semantics: a column is emitted iff the current reference position is
    the leftmost reference-genome base the traversal touches
    (colMapInsert cache + isCanonicalOnRef, halColumnIterator.cpp:146-245,
    halMafExport.cpp:52-62).

    max_ref_gap > 0 enables the reference's indel stacks: runs discover
    insertions/deletions at their last column (the endOffset==0 gate,
    hoisted), and the discovered ranges are walked as sub-references
    emitting ref-gap Slices (lo == hi, width = columns) right after the
    run — insertions first in reverse discovery order, then deletions in
    discovery order, nesting recursively under the cumulative budget
    (toRight stack drain, halColumnIterator.cpp:122-126).

    shared_visit ({genome -> PositionCache}, mutated in place) activates
    the cross-pass unique semantics of hal2maf --global: a column any of
    whose member positions is already in the cache is skipped outright
    (colMapInsert returns !found and every recursion site then sets
    _break, halColumnIterator.cpp:295-299/818; toRight retries the next
    position while _break), and every REFERENCE-genome position visited is
    recorded (updateCache = genome == stack[0] genome,
    halColumnIterator.cpp:772-780).  Runs containing visited columns are
    split into their maximal unvisited sub-runs."""
    from hal_bench.reference.poscache import PositionCache

    dfs = ColumnDFS(aln, ref, scope=scope, targets=targets, no_dupes=no_dupes,
                    no_ancestors=no_ancestors, only_orthologs=only_orthologs,
                    max_ref_gap=max_ref_gap,
                    track_visits=shared_visit is not None)
    pos = gs
    # active indel stack entries: [genome, index, first, last, rev, cum]
    stack: list = []
    # visit cache (genome name -> PositionCache): active with indel stacks,
    # mirroring the reference's VisitCache (halColumnIterator.cpp:753-800) —
    # positions of genomes currently serving as a (sub-)reference are
    # recorded, and any row whose range was already recorded is dropped, so
    # a re-discovered indel range is never emitted twice
    visit: dict = {}

    def _filter_and_record(out_rows, k):
        """colMapInsert at run granularity: drop rows fully covered by the
        cache, then record this run's visits for the live (stack) genomes."""
        kept = [r for r in out_rows
                if not ((pc := visit.get(r.genome)) is not None
                        and pc.covers(r.tgt_lo, r.tgt_hi))]
        live = {ref}
        for s in stack:
            live.add(s[0])
        for (gname, p, rv) in dfs.visits:
            if gname in live:
                pc = visit.get(gname)
                if pc is None:
                    pc = visit[gname] = PositionCache()
                pc.add(p - k + 1, p + 1) if rv else pc.add(p, p + k)
        return kept

    while pos < ge or stack:
        if stack:
            e = stack[-1]
            genome, idx, first, last, erev, cum = e
            pc = visit.get(genome)
            if pc is not None:
                # nextFreeIndex: the iterator index moves right past
                # already-visited bases; if none remain in range the entry
                # pops unwalked (halColumnIterator.cpp:747-762, 82-86)
                while idx <= last:
                    iv = pc.interval_at(idx)
                    if iv is None:
                        break
                    idx = iv[1]
                e[1] = idx
                if idx < first or idx > last:
                    stack.pop()
                    continue
            rows, limit, _rp = dfs.run_from(genome, idx, erev)
            remaining = (idx - first + 1) if erev else (last - idx + 1)
            run = min(limit, remaining)
            if pc is not None:
                # stop the run at the next already-visited base
                run = min(run, pc.free_run(idx, not erev))
            out_rows = _filter_and_record(
                _make_rows(dfs, rows, run, mark_ref=False), run)
            if out_rows:
                yield Slice(pos, pos, out_rows, width=run, sorted_rows=True)
            subs = (dfs.collect_indels(run, cum)
                    if max_ref_gap > 0 and len(stack) < 64 else [])
            e[1] = idx - run if erev else idx + run
            if (e[1] < first) if erev else (e[1] > last):
                stack.pop()
            stack.extend(subs)
            continue
        rows, limit, ref_positions = dfs.run(pos)
        run = min(limit, ge - pos)
        if shared_visit is not None:
            k = run
            # columns any of whose member positions was already visited are
            # skipped (the _break-on-found retry loop); compute the visited
            # column offsets from every genome's cache
            bad = np.zeros(k, bool)
            for (gname, p, rv) in dfs.visits:
                pc = shared_visit.get(gname)
                if pc is None:
                    continue
                vlo, vhi = (p - k + 1, p + 1) if rv else (p, p + k)
                for (a, b) in pc.overlaps(vlo, vhi):
                    o0, o1 = (p - b + 1, p - a + 1) if rv else (a - p, b - p)
                    bad[o0:o1] = True
            # record the REFERENCE genome's row positions over the full run
            # (updateCache: only stack[0]'s genome is recorded; broken
            # columns still cache their DFS prefix, so record all offsets)
            pc = shared_visit.get(ref)
            if pc is None:
                pc = shared_visit[ref] = PositionCache()
            for (gname, p, rv) in dfs.visits:
                if gname == ref:
                    pc.add(p - k + 1, p + 1) if rv else pc.add(p, p + k)
            o = 0
            while o < k:
                if bad[o]:
                    o += 1
                    continue
                o1 = o
                while o1 < k and not bad[o1]:
                    o1 += 1
                sub = [(g2, (p2 - o if rv2 else p2 + o), rv2)
                       for (g2, p2, rv2) in rows]
                out_rows = _make_rows(dfs, sub, o1 - o, mark_ref=True)
                if out_rows:
                    yield Slice(pos + o, pos + o1, out_rows, sorted_rows=True)
                o = o1
            pos += run
            continue
        kemit = run
        if unique:
            for (p0, rev) in ref_positions:
                if rev:
                    if p0 < pos:
                        kemit = 0
                    elif p0 > pos:
                        kemit = min(kemit, (p0 - pos) // 2 + 1)
                elif p0 < pos:
                    kemit = 0
        if kemit > 0:
            out_rows = _make_rows(dfs, rows, kemit, mark_ref=True)
            if max_ref_gap > 0:
                out_rows = _filter_and_record(out_rows, run)
            if out_rows:
                yield Slice(pos, pos + kemit, out_rows, sorted_rows=True)
        if max_ref_gap > 0:
            stack.extend(dfs.collect_indels(run, 0))
        pos += run


def iter_slices(aln: Alignment, ref: str, gs: int, ge: int,
                frags_by_genome: dict, no_ancestors: bool = False,
                unique_start: int | None = None):
    """Yield atomic Slices over [gs, ge).

    unique_start: when set (--unique), positions whose column's leftmost
    ref-genome coordinate is < unique_start are skipped (reference
    isCanonicalOnRef, halColumnIterator.cpp:208).

    Indel recursion (--maxRefGap) lives exclusively in iter_slices_exact's
    stack walker; this fragment-table engine serves the bulk/batched
    consumers (halPhyloP windows, --global) that never request indels."""
    tree = aln.tree
    # global breakpoint set in ref coords
    cuts = {gs, ge}
    for g, f in frags_by_genome.items():
        cuts.update(f.src_lo.tolist())
        cuts.update(f.src_hi.tolist())
    bounds = sorted(c for c in cuts if gs <= c <= ge)

    # canonical mask for --unique: per ref position, the leftmost ref-genome
    # position among its ref-genome rows
    ref_frags = frags_by_genome.get(ref)

    # ---- vectorized (fragment x slice) expansion ------------------------
    # every fragment boundary is a cut, so a fragment covers slices
    # [searchsorted(bnd, src_lo), searchsorted(bnd, src_hi)) exactly; the
    # per-slice python double loop this replaces was the hal2maf hot spot
    bnd = np.asarray(bounds, np.int64)
    nsl = max(len(bnd) - 1, 0)
    genome_names = sorted(frags_by_genome)
    cols = {k: [] for k in ("sl", "gid", "seq", "tlo", "thi", "rev", "isref")}
    for gid, g in enumerate(genome_names):
        if no_ancestors and not tree.is_leaf(g):
            continue
        f = frags_by_genome[g]
        gen = aln.open_genome(g)
        lo_i = np.searchsorted(bnd, f.src_lo, side="left")
        hi_i = np.searchsorted(bnd, f.src_hi, side="left")
        count = np.maximum(hi_i - lo_i, 0)
        total = int(count.sum())
        if not total:
            continue
        rep = np.repeat(np.arange(len(count)), count)
        offs = np.cumsum(count) - count
        sl = lo_i[rep] + (np.arange(total) - offs[rep])
        a = bnd[sl]
        b = bnd[sl + 1]
        rev = f.rev[rep].astype(bool)
        adv = a - f.src_lo[rep]
        t_hi_r = f.tgt_hi[rep] - adv
        t_lo_f = f.tgt_lo[rep] + adv
        t_lo = np.where(rev, t_hi_r - (b - a), t_lo_f)
        t_hi = np.where(rev, t_hi_r, t_lo_f + (b - a))
        seq = np.searchsorted(gen.seq_start, f.tgt_lo[rep], side="right") - 1
        isref = (g == ref) & ~rev & (t_lo == a)
        cols["sl"].append(sl)
        cols["gid"].append(np.full(total, gid))
        cols["seq"].append(seq)
        cols["tlo"].append(t_lo)
        cols["thi"].append(t_hi)
        cols["rev"].append(rev)
        cols["isref"].append(isref)
    if cols["sl"]:
        sl = np.concatenate(cols["sl"])
        gid = np.concatenate(cols["gid"])
        seq = np.concatenate(cols["seq"])
        tlo = np.concatenate(cols["tlo"])
        thi = np.concatenate(cols["thi"])
        rev = np.concatenate(cols["rev"])
        isref = np.concatenate(cols["isref"])
    else:
        sl = gid = seq = tlo = thi = np.zeros(0, np.int64)
        rev = isref = np.zeros(0, bool)
    # deterministic row order within a slice: ref first, then SequenceLess +
    # forward position (genome_names is sorted, so gid order == name order)
    order = np.lexsort((rev, tlo, seq, gid, ~isref, sl))
    sl, gid, seq, tlo, thi, rev, isref = (x[order] for x in
                                          (sl, gid, seq, tlo, thi, rev, isref))
    starts = np.searchsorted(sl, np.arange(nsl), side="left")
    ends = np.searchsorted(sl, np.arange(nsl), side="right")

    # --unique: leftmost ref-genome position per slice
    skip = np.zeros(nsl, bool)
    if unique_start is not None and ref_frags is not None:
        ref_gid = genome_names.index(ref) if ref in genome_names else -1
        leftpos = np.where(rev, thi - 1, tlo)
        skip_all = np.full(nsl, np.iinfo(np.int64).max)
        m = gid == ref_gid
        if m.any():
            np.minimum.at(skip_all, sl[m], leftpos[m])
        skip = skip_all < unique_start

    ref_gen = aln.open_genome(ref)
    for i in range(nsl):
        a, b = int(bnd[i]), int(bnd[i + 1])
        if b <= a:
            continue
        if skip[i]:
            continue
        rows = [Row(genome_names[gid[k]], int(seq[k]), int(tlo[k]),
                    int(thi[k]), bool(rev[k]), bool(isref[k]))
                for k in range(starts[i], ends[i])]
        if not (rows and rows[0].is_ref):
            # ensure the reference's own position is present even when the
            # ref genome mapping lost it (shouldn't happen; identity row)
            si = int(np.searchsorted(ref_gen.seq_start, a, side="right")) - 1
            rows.append(Row(ref, si, a, b, False, True))
            rows.sort(key=lambda r: (not r.is_ref, r.genome, r.seq_idx,
                                     r.tgt_lo, r.rev))
        yield Slice(a, b, rows)

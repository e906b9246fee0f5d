"""Port copy of hal_tpu/ops/validate.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

Vectorized structural validation of an alignment.

Checks the invariants of the reference's api/impl/halValidate.cpp
(validateTopSegment :103, validateBottomSegment :27, validateSequence :174,
validateDuplications :223, validateGenome :253, validateAlignment :306) as
whole-array numpy predicates instead of per-segment loops.
"""

from __future__ import annotations

import numpy as np

from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.genome import GenomeArrays


class ValidationError(AssertionError):
    pass


def _req(cond: bool, msg: str, *args) -> None:
    if not cond:
        raise ValidationError(msg % args if args else msg)


def validate_segment_tiling(g: GenomeArrays) -> None:
    """Segments tile the genome: starts strictly increasing, sequences start
    on segment boundaries (reference validateSequence, halValidate.cpp:174)."""
    for kind, start, seq_off in (("top", g.top_start, g.seq_top), ("bottom", g.bot_start, g.seq_bot)):
        n = len(start) - 1
        if n == 0:
            continue
        _req(bool(start[0] == 0), "%s: genome %s first segment start %d != 0", kind, g.name, start[0])
        _req(bool((np.diff(start) > 0).all()), "%s segments of %s not strictly increasing", kind, g.name)
        _req(bool(start[-1] == g.length), "%s segments of %s do not cover genome (%d != %d)",
             kind, g.name, start[-1], g.length)
        # each sequence with segments begins exactly at a segment start
        for si in range(g.num_sequences):
            lo, hi = int(seq_off[si]), int(seq_off[si + 1])
            if hi > lo:
                _req(bool(start[lo] == g.seq_start[si]),
                     "%s: sequence %s of %s does not start on segment boundary", kind, g.seq_names[si], g.name)
                _req(bool(start[hi] == g.seq_start[si + 1]),
                     "%s: sequence %s of %s does not end on segment boundary", kind, g.seq_names[si], g.name)


def validate_top_segments(g: GenomeArrays, parent: GenomeArrays | None, child_slot: int) -> None:
    """Parent links: index ranges, equal homolog lengths, reciprocity and
    orientation agreement (reference validateTopSegment, halValidate.cpp:103)."""
    n = g.num_top_segments
    if n == 0:
        return
    has_parent = g.top_parent != NULL_INDEX
    if parent is None:
        _req(bool(~has_parent.any()) if n else True,
             "genome %s has parent links but no parent genome", g.name)
        return
    p = g.top_parent[has_parent]
    _req(bool((p >= 0).all() and (p < parent.num_bottom_segments).all()),
         "genome %s: parent index out of range", g.name)
    t_len = np.diff(g.top_start)[has_parent]
    b_len = np.diff(parent.bot_start)[p]
    _req(bool((t_len == b_len).all()),
         "genome %s: homologous segment lengths differ from parent %s", g.name, parent.name)
    # reciprocity where the parent points back at us (canonical paralog)
    back = parent.bot_child[p, child_slot]
    canon = back == np.flatnonzero(has_parent)
    rev_par = parent.bot_child_reversed[p[canon], child_slot]
    rev_top = g.top_parent_reversed[has_parent][canon]
    _req(bool((rev_par == rev_top).all()),
         "genome %s: orientation disagreement with parent %s", g.name, parent.name)


def validate_bottom_segments(g: GenomeArrays, children: list[GenomeArrays]) -> None:
    """Child links: ranges, equal lengths, child's parent points back with the
    same orientation (reference validateBottomSegment, halValidate.cpp:27)."""
    n = g.num_bottom_segments
    if n == 0:
        return
    b_len = np.diff(g.bot_start)
    for slot, cg in enumerate(children):
        ci = g.bot_child[:, slot]
        has = ci != NULL_INDEX
        if not has.any():
            continue
        c = ci[has]
        _req(bool((c >= 0).all() and (c < cg.num_top_segments).all()),
             "genome %s: child index out of range for child %s", g.name, cg.name)
        _req(bool((b_len[has] == np.diff(cg.top_start)[c]).all()),
             "genome %s: homolog length mismatch with child %s", g.name, cg.name)
        _req(bool((cg.top_parent[c] == np.flatnonzero(has)).all()),
             "genome %s: child %s does not point back at bottom segment", g.name, cg.name)
        _req(bool((cg.top_parent_reversed[c] == g.bot_child_reversed[has, slot]).all()),
             "genome %s: orientation mismatch with child %s", g.name, cg.name)


def validate_parse_links(g: GenomeArrays) -> None:
    """Parse edges: the referenced segment must contain this segment's start
    (reference halValidate.cpp topParse/bottomParse checks)."""
    n_top, n_bot = g.num_top_segments, g.num_bottom_segments
    if n_top and n_bot:
        bp = g.top_bottom_parse
        _req(bool(((bp >= 0) & (bp < n_bot)).all()), "genome %s: bottom parse out of range", g.name)
        ts = g.top_start[:-1]
        _req(bool((g.bot_start[bp] <= ts).all() and (ts < g.bot_start[bp + 1]).all()),
             "genome %s: bottom parse does not contain top start", g.name)
        tp = g.bot_top_parse
        _req(bool(((tp >= 0) & (tp < n_top)).all()), "genome %s: top parse out of range", g.name)
        bs = g.bot_start[:-1]
        _req(bool((g.top_start[tp] <= bs).all() and (bs < g.top_start[tp + 1]).all()),
             "genome %s: top parse does not contain bottom start", g.name)
    elif n_top:
        _req(bool((g.top_bottom_parse == NULL_INDEX).all()),
             "genome %s: tops have parse links but genome has no bottoms", g.name)
    elif n_bot:
        _req(bool((g.bot_top_parse == NULL_INDEX).all()),
             "genome %s: bottoms have parse links but genome has no tops", g.name)


def validate_paralogies(g: GenomeArrays) -> None:
    """Paralogy rings are closed cycles whose members share one parent index
    (reference validateDuplications, halValidate.cpp:223)."""
    n = g.num_top_segments
    if n == 0:
        return
    nxt = g.top_paralogy
    in_ring = nxt != NULL_INDEX
    if not in_ring.any():
        return
    _req(bool((nxt[in_ring] >= 0).all() and (nxt[in_ring] < n).all()),
         "genome %s: paralogy index out of range", g.name)
    _req(bool((nxt[in_ring] != np.flatnonzero(in_ring)).all()),
         "genome %s: self-paralogy", g.name)
    # successor of a ring member must itself be in a ring and share the parent
    succ = nxt[in_ring]
    _req(bool(in_ring[succ].all()), "genome %s: paralogy ring not closed", g.name)
    _req(bool((g.top_parent[in_ring] == g.top_parent[succ]).all()),
         "genome %s: paralogs have different parents", g.name)
    # rings are permutations: every ring member has exactly one predecessor
    count = np.zeros(n, np.int64)
    np.add.at(count, succ, 1)
    _req(bool((count[in_ring] == 1).all() and (count[~in_ring] == 0).all()),
         "genome %s: paralogy links do not form disjoint rings", g.name)


def validate_genome(aln: Alignment, name: str) -> None:
    g = aln.open_genome(name)
    g.validate_shapes()
    parent_name = aln.tree.parent(name)
    parent = aln.open_genome(parent_name) if parent_name else None
    children = [aln.open_genome(c) for c in aln.tree.children(name)]
    _req(g.num_children == len(children),
         "genome %s: child array width %d != %d children in tree", name, g.num_children, len(children))
    validate_segment_tiling(g)
    slot = aln.tree.child_index(parent_name, name) if parent_name else 0
    validate_top_segments(g, parent, slot)
    validate_bottom_segments(g, children)
    validate_parse_links(g)
    validate_paralogies(g)


def validate_alignment(aln: Alignment) -> None:
    """Whole-alignment validation (reference validateAlignment,
    halValidate.cpp:306)."""
    for name in aln.genome_names():
        validate_genome(aln, name)

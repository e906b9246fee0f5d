"""Port copy of hal_tpu/tools/halSummarizeMutations.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

halSummarizeMutations — per-branch mutation census CSV
(reference mutations/impl/halSummarizeMutations.cpp, output format
halMutationsStats.cpp:15-44)."""

from __future__ import annotations

import sys

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops.rearrangement import (DEFAULT_GAP_THRESHOLD, DEFAULT_N_THRESHOLD,
                                       analyze_branch)
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main

HEADER = ("BranchLength, GenomeLength, ParentLength, Subtitutions, Transitions, "
          "Transversions, Matches, GapInsertions, GapInsertedBases, GapDeletions, "
          "GapDeletedBases, Insertions, InsertionBases, Deletions, DeletionBases, "
          "Inversions, InvertedBases, Duplications, DuplicatedBases, Transpositions, "
          "TranspositionBases, Other")


def _other_count(res):
    # breakpoint pairs of detected events are marked Other; subtract them
    # (reference halMutationsStats.cpp:24-33)
    other = res.count("O") - res.count("I") - res.count("D") - res.count("V") \
        - res.count("U") - res.count("P")
    return max(other, 0)


def _stats_row(aln, child, res):
    g = aln.open_genome(child)
    pg = aln.open_genome(aln.tree.parent(child))
    vals = [
        "%g" % aln.tree.branch_length(child),
        g.length, pg.length,
        res.subs, res.transitions, res.transversions, res.matches,
        res.count("GI"), res.bases("GI"), res.count("GD"), res.bases("GD"),
        res.count("I"), res.bases("I"), res.count("D"), res.bases("D"),
        res.count("V"), res.bases("V"), res.count("U"), res.bases("U"),
        res.count("P"), res.bases("P"), _other_count(res),
    ]
    return ", ".join(str(v) for v in vals)


def run(argv=None):
    p = make_parser("halSummarizeMutations", "Print summary table of mutation events")
    p.add_argument("halFile")
    p.add_argument("--rootGenome", default="")
    p.add_argument("--targetGenomes", default="")
    p.add_argument("--maxGap", type=int, default=DEFAULT_GAP_THRESHOLD)
    p.add_argument("--maxNFraction", type=float, default=DEFAULT_N_THRESHOLD)
    p.add_argument("--justSubs", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln = open_alignment(o.halFile)

    root = o.rootGenome or aln.root_name
    targets = set(t for t in o.targetGenomes.split(",") if t)
    names = [n for n in aln.tree.preorder(root) if aln.tree.parent(n) is not None]
    if targets:
        names = [n for n in names if n in targets]

    os_ = sys.stdout
    os_.write("GenomeName, ParentName, " + HEADER + "\n")
    totals = None
    rows = []
    for child in names:
        res = analyze_branch(aln, child, o.maxGap, o.maxNFraction, o.justSubs)
        rows.append((child, aln.tree.parent(child), res))
        os_.write("%s, %s, %s\n" % (child, aln.tree.parent(child), _stats_row(aln, child, res)))

    # totals row (reference printCsv :35-47)
    if rows:
        import copy

        total = copy.deepcopy(rows[0][2])
        tg_len = aln.open_genome(rows[0][0]).length
        tp_len = aln.open_genome(rows[0][1]).length
        bl = aln.tree.branch_length(rows[0][0])
        for child, par, res in rows[1:]:
            total.events.extend(res.events)
            total.subs += res.subs
            total.transitions += res.transitions
            total.transversions += res.transversions
            total.matches += res.matches
            tg_len += aln.open_genome(child).length
            tp_len += aln.open_genome(par).length
            bl += aln.tree.branch_length(child)
        vals = [
            "%g" % bl, tg_len, tp_len,
            total.subs, total.transitions, total.transversions, total.matches,
            total.count("GI"), total.bases("GI"), total.count("GD"), total.bases("GD"),
            total.count("I"), total.bases("I"), total.count("D"), total.bases("D"),
            total.count("V"), total.bases("V"), total.count("U"), total.bases("U"),
            total.count("P"), total.bases("P"), _other_count(total),
        ]
        os_.write("Total, ," + ", ".join(str(v) for v in vals) + "\n")


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

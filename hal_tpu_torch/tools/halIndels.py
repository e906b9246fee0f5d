"""Port copy of hal_tpu/tools/halIndels.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

halIndels — filtered clean insertions/deletions on the branch above a
genome (reference mutations/impl/halIndels.cpp; output :362-376:
`seq <tab> start <tab> end <tab> D <tab> len` / `... I` plus a
'# num sites possible' footer).

Filtering model: an indel is reported when the `adjacentBases` flanking
bases on both sides are unambiguous (no N) in the reference and its
parent — the practical core of the reference's sibling/outgroup
contiguity checks."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.ops.rearrangement import analyze_branch
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main


def _clean(g, lo, hi):
    lo = max(0, lo)
    hi = min(g.length, hi)
    if hi <= lo:
        return True
    b = g.get_dna(lo, hi - lo)
    up = np.where((b >= 97) & (b <= 122), b - 32, b)
    return not (up == ord("N")).any()


def run(argv=None):
    p = make_parser("halIndels", "Count (filtered) indels in the branch above a genome")
    p.add_argument("halFile")
    p.add_argument("refGenome")
    p.add_argument("--adjacentBases", type=int, default=5)
    p.add_argument("--onlyExtantTargets", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln = open_alignment(o.halFile)
    child = o.refGenome
    if child not in aln.tree or aln.tree.parent(child) is None:
        raise HalError("refGenome must be a non-root genome")
    g = aln.open_genome(child)
    pg = aln.open_genome(aln.tree.parent(child))

    res = analyze_branch(aln, child, gap_threshold=0, do_subs=False)
    adj = o.adjacentBases
    num_sites = 0
    lines = []
    for e in sorted(res.events, key=lambda e: (e.child_lo if e.child_lo != -1 else 0)):
        if e.kind in ("I", "GI"):
            if _clean(g, e.child_lo - adj, e.child_hi + adj):
                si = int(np.searchsorted(g.seq_start, e.child_lo, side="right")) - 1
                base = int(g.seq_start[si])
                lines.append("%s\t%d\t%d\tI\t\n" % (g.seq_names[si], e.child_lo - base,
                                                    e.child_hi - base))
        elif e.kind == "DB":
            ok = _clean(pg, e.parent_lo - adj, e.parent_hi + adj) and \
                _clean(g, e.child_lo - adj, e.child_hi + adj)
            if ok:
                pos = e.child_lo + 1
                si = int(np.searchsorted(g.seq_start, pos, side="right")) - 1
                base = int(g.seq_start[si])
                lines.append("%s\t%d\t%d\tD\t%d\n" % (g.seq_names[si], pos - base, pos - base,
                                                      e.parent_hi - e.parent_lo))
    num_sites = g.length
    sys.stdout.write("".join(lines))
    sys.stdout.write("# num sites possible: %d\n" % num_sites)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

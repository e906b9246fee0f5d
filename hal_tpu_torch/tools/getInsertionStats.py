"""Port copy of hal_tpu/tools/getInsertionStats.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

getInsertionStats — insertion length statistics for a branch
(reference extra/getInsertionStats.py)."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops.rearrangement import analyze_branch
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main


def run(argv=None):
    p = make_parser("getInsertionStats", "Print insertion statistics for a genome's branch")
    p.add_argument("halFile")
    p.add_argument("genome")
    p.add_argument("--maxGap", type=int, default=10)
    add_storage_options(p)
    o = p.parse_args(argv)
    aln = open_alignment(o.halFile)
    if o.genome not in aln.tree or aln.tree.parent(o.genome) is None:
        raise HalError("genome must exist and have a parent")
    res = analyze_branch(aln, o.genome, gap_threshold=o.maxGap, do_subs=False)
    lens = np.array([e.child_hi - e.child_lo for e in res.events if e.kind == "I"])
    sys.stdout.write("genome\tcount\ttotalBases\tmeanLen\tmedianLen\tmaxLen\n")
    if len(lens):
        sys.stdout.write("%s\t%d\t%d\t%.1f\t%.1f\t%d\n"
                         % (o.genome, len(lens), int(lens.sum()),
                            float(lens.mean()), float(np.median(lens)), int(lens.max())))
    else:
        sys.stdout.write("%s\t0\t0\t0\t0\t0\n" % o.genome)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

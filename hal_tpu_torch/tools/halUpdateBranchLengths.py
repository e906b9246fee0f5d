"""Port copy of hal_tpu/tools/halUpdateBranchLengths.py (numpy only; the same
code, imports pointing at hal_tpu_torch).

halUpdateBranchLengths (reference modify/halUpdateBranchLengths.cpp)."""

from __future__ import annotations

import sys

from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._modify_common import open_for_update, save_back
from hal_tpu_torch.tree import Tree


def run(argv=None):
    p = make_parser("halUpdateBranchLengths",
                    "Update branch lengths from an identically-structured newick tree")
    p.add_argument("halFile")
    p.add_argument("newickTree", help="newick tree (identical topology, new branch lengths)")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln, fmt = open_for_update(o.halFile)
    t = Tree.from_newick(o.newickTree)
    if set(t.names()) != set(aln.tree.names()):
        raise HalError("tree topology/names do not match the alignment")
    for n in t.names():
        if t.parent(n) != aln.tree.parent(n):
            raise HalError("tree topology does not match at %s" % n)
        if t.parent(n) is not None:
            aln.tree.set_branch_length(n, t.branch_length(n))
    save_back(aln, o.halFile, fmt)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

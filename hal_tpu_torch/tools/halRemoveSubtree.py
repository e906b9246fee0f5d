"""Port copy of hal_tpu/tools/halRemoveSubtree.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halRemoveSubtree — delete everything below a node
(reference modify/halRemoveSubtree.cpp)."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.tools import add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._modify_common import mark_ancestors_for_update, open_for_update, save_back


def run(argv=None):
    p = make_parser("halRemoveSubtree", "Remove subtree below a node (but not the node)")
    p.add_argument("inFile")
    p.add_argument("root")
    p.add_argument("--noMarkAncestors", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln, fmt = open_for_update(o.inFile)
    if o.root not in aln.tree:
        raise KeyError(o.root)
    if not o.noMarkAncestors:
        mark_ancestors_for_update(aln, o.root)
    for child in list(aln.tree.children(o.root)):
        aln.remove_subtree(child)
    g = aln.open_genome(o.root)
    # the node keeps its bottoms but has no children any more
    g.bot_child = np.zeros((g.num_bottom_segments, 0), np.int64)
    g.bot_child_reversed = np.zeros((g.num_bottom_segments, 0), np.uint8)
    save_back(aln, o.inFile, fmt)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

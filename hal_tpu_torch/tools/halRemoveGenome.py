"""Port copy of hal_tpu/tools/halRemoveGenome.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halRemoveGenome — delete a leaf genome (reference modify/halRemoveGenome.cpp)."""

from __future__ import annotations

import sys

from hal_tpu_torch.tools import add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._modify_common import mark_ancestors_for_update, open_for_update, save_back


def run(argv=None):
    p = make_parser("halRemoveGenome", "Remove a leaf genome from a hal file")
    p.add_argument("inFile")
    p.add_argument("deleteNode", help="(leaf) genome to delete")
    p.add_argument("--noMarkAncestors", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln, fmt = open_for_update(o.inFile)
    if not o.noMarkAncestors:
        mark_ancestors_for_update(aln, o.deleteNode)
    aln.remove_genome(o.deleteNode)
    save_back(aln, o.inFile, fmt)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

"""Port copy of hal_tpu/tools/halAddToBranch.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halAddToBranch — insert a genome into a branch plus a new leaf child
(reference modify/halAddToBranch.cpp).

Composition of the replace primitives: the insert genome splices into the
branch parentName->childName; its bottom structure (with children
childName + leafName) comes from botAlignmentFile, its top structure (vs
parentName) from topAlignmentFile."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops.validate import validate_genome
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._modify_common import mark_ancestors_for_update, open_for_update, save_back
from hal_tpu_torch.tools.halReplaceGenome import _fix_parse, _transplant_bottoms, _transplant_tops


def run(argv=None):
    p = make_parser("halAddToBranch", "Add a new genome to a branch of the tree")
    p.add_argument("inFile")
    p.add_argument("botAlignmentFile")
    p.add_argument("topAlignmentFile")
    p.add_argument("parentName")
    p.add_argument("insertName")
    p.add_argument("childName")
    p.add_argument("leafName")
    p.add_argument("upperBranchLength", type=float)
    p.add_argument("leafBranchLength", type=float, nargs="?", default=1.0)
    p.add_argument("--noMarkAncestors", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln, fmt = open_for_update(o.inFile)
    bot = open_alignment(o.botAlignmentFile)
    top = open_alignment(o.topAlignmentFile)
    if o.insertName in aln.tree:
        raise HalError("genome %s already in tree" % o.insertName)

    # splice insert into the branch, then hang the new leaf under it
    aln.insert_genome(o.insertName, o.parentName, o.childName, o.upperBranchLength)
    aln._genomes[o.insertName] = bot.open_genome(o.insertName).copy()
    aln.tree.add_child(o.insertName, o.leafName, o.leafBranchLength)
    aln._genomes[o.leafName] = bot.open_genome(o.leafName).copy()

    # child order must match the bottom donor's slots
    if aln.tree.children(o.insertName) != bot.tree.children(o.insertName):
        order = bot.tree.children(o.insertName)
        aln.tree._children[o.insertName] = list(order)

    _transplant_bottoms(aln, bot, o.insertName)
    _transplant_tops(aln, top, o.insertName)
    for t in (o.insertName, o.childName, o.leafName, o.parentName):
        _fix_parse(aln.open_genome(t))
    if not o.noMarkAncestors:
        mark_ancestors_for_update(aln, o.insertName)
    for t in (o.insertName, o.childName, o.leafName):
        validate_genome(aln, t)
    save_back(aln, o.inFile, fmt)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

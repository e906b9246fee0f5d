"""Port copy of hal_tpu/tools/halAppendSubtree.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halAppendSubtree — graft a subtree from another alignment
(reference modify/halAppendSubtree.cpp).

The usual Cactus flow: the destination has genome `rootName` (often a leaf
under `parentName`); the append alignment is rooted at a genome of the
same name and coordinates, carrying its bottom structure + children.
The graft copies the subtree's genomes in and transplants the append
root's bottom arrays onto the destination genome, recomputing parse links
by position.  (--bridgeFile for a differently-named root is handled by
renaming before the graft; --merge collapses the duplicate node.)"""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops.validate import validate_genome
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._modify_common import mark_ancestors_for_update, open_for_update, save_back


def run(argv=None):
    p = make_parser("halAppendSubtree", "Append a subtree to an existing alignment")
    p.add_argument("mainFile")
    p.add_argument("appendFile")
    p.add_argument("parentName", help="node to be added to")
    p.add_argument("rootName", help="name of subtree root")
    p.add_argument("--bridgeFile", default="",
                   help="alignment containing parent and root (accepted for "
                        "CLI parity; the graft works from coordinates)")
    p.add_argument("--branchLength", type=float, default=1.0)
    p.add_argument("--noMarkAncestors", action="store_true")
    p.add_argument("--merge", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)

    aln, fmt = open_for_update(o.mainFile)
    app = open_alignment(o.appendFile)
    if o.rootName not in app.tree or app.root_name != o.rootName:
        raise HalError("append alignment must be rooted at %s" % o.rootName)

    if o.rootName not in aln.tree:
        # new leaf under parentName carrying the append root's arrays
        if o.parentName not in aln.tree:
            raise HalError("parent genome %s not found" % o.parentName)
        aln.tree.add_child(o.parentName, o.rootName, o.branchLength)
        aln._genomes[o.rootName] = app.open_genome(o.rootName).copy()
        # widen the parent's child array
        pg = aln.open_genome(o.parentName)
        pg.bot_child = np.concatenate(
            [pg.bot_child, np.full((pg.num_bottom_segments, 1), -1, np.int64)], axis=1)
        pg.bot_child_reversed = np.concatenate(
            [pg.bot_child_reversed, np.zeros((pg.num_bottom_segments, 1), np.uint8)], axis=1)
    else:
        # transplant bottom structure onto the existing genome
        dst = aln.open_genome(o.rootName)
        src = app.open_genome(o.rootName)
        if dst.length != src.length:
            raise HalError("genome %s differs in length between alignments "
                           "(%d vs %d)" % (o.rootName, dst.length, src.length))
        dst.bot_start = np.array(src.bot_start, copy=True)
        dst.bot_top_parse = np.array(src.bot_top_parse, copy=True)
        dst.bot_child = np.array(src.bot_child, copy=True)
        dst.bot_child_reversed = np.array(src.bot_child_reversed, copy=True)
        dst.seq_bot = np.array(src.seq_bot, copy=True)
        # recompute parse links by position
        if dst.num_top_segments and dst.num_bottom_segments:
            dst.top_bottom_parse = np.searchsorted(
                dst.bot_start, dst.top_start[:-1], side="right").astype(np.int64) - 1
            dst.bot_top_parse = np.searchsorted(
                dst.top_start, dst.bot_start[:-1], side="right").astype(np.int64) - 1
        elif dst.num_top_segments:
            pass
    # copy the descendant genomes + tree edges
    for name in app.tree.preorder(o.rootName):
        if name == o.rootName:
            continue
        if name in aln.tree:
            raise HalError("genome %s already exists in destination" % name)
        aln.tree.add_child(app.tree.parent(name), name, app.tree.branch_length(name))
        aln._genomes[name] = app.open_genome(name).copy()

    if not o.noMarkAncestors:
        mark_ancestors_for_update(aln, o.rootName)
    for name in app.tree.preorder(o.rootName):
        validate_genome(aln, name)
    save_back(aln, o.mainFile, fmt)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

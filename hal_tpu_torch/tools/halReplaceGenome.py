"""Port copy of hal_tpu/tools/halReplaceGenome.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halReplaceGenome — swap a genome's top and/or bottom structure from
donor alignments (reference modify/halReplaceGenome.cpp).

The donor alignments must contain the genome plus its neighbors with the
same coordinate systems (the Cactus progressive-alignment contract); both
sides of every edge are transplanted so reciprocity holds, then the
touched genomes are re-validated."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops.validate import validate_genome
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._modify_common import mark_ancestors_for_update, open_for_update, save_back


def _transplant_tops(aln, donor, name: str) -> None:
    """Replace `name`'s top arrays and its parent's bottom arrays from the
    donor (the parent side carries the reciprocal child links)."""
    dst = aln.open_genome(name)
    src = donor.open_genome(name)
    if dst.length != src.length:
        raise HalError("genome %s differs in length" % name)
    for f in ("top_start", "top_parent", "top_parent_reversed",
              "top_bottom_parse", "top_paralogy", "seq_top"):
        setattr(dst, f, np.array(getattr(src, f), copy=True))
    parent = aln.tree.parent(name)
    d_parent = donor.tree.parent(name)
    if parent is None or d_parent != parent:
        raise HalError("donor topAlignment must contain parent %s" % parent)
    pg = aln.open_genome(parent)
    spg = donor.open_genome(parent)
    if pg.num_bottom_segments != spg.num_bottom_segments or \
            not np.array_equal(pg.bot_start, spg.bot_start):
        raise HalError("parent %s segmentation differs between alignments" % parent)
    slot = aln.tree.child_index(parent, name)
    s_slot = donor.tree.child_index(parent, name)
    pg.bot_child[:, slot] = spg.bot_child[:, s_slot]
    pg.bot_child_reversed[:, slot] = spg.bot_child_reversed[:, s_slot]


def _transplant_bottoms(aln, donor, name: str) -> None:
    dst = aln.open_genome(name)
    src = donor.open_genome(name)
    if dst.length != src.length:
        raise HalError("genome %s differs in length" % name)
    children = aln.tree.children(name)
    d_children = donor.tree.children(name)
    if children != d_children:
        raise HalError("donor bottomAlignment children of %s differ" % name)
    for f in ("bot_start", "bot_top_parse", "bot_child", "bot_child_reversed", "seq_bot"):
        setattr(dst, f, np.array(getattr(src, f), copy=True))
    for child in children:
        cg = aln.open_genome(child)
        scg = donor.open_genome(child)
        if not np.array_equal(cg.top_start, scg.top_start):
            raise HalError("child %s segmentation differs between alignments" % child)
        cg.top_parent = np.array(scg.top_parent, copy=True)
        cg.top_parent_reversed = np.array(scg.top_parent_reversed, copy=True)
        cg.top_paralogy = np.array(scg.top_paralogy, copy=True)


def _fix_parse(g):
    if g.num_top_segments and g.num_bottom_segments:
        g.top_bottom_parse = np.searchsorted(
            g.bot_start, g.top_start[:-1], side="right").astype(np.int64) - 1
        g.bot_top_parse = np.searchsorted(
            g.top_start, g.bot_start[:-1], side="right").astype(np.int64) - 1
    elif g.num_top_segments:
        g.top_bottom_parse = np.full(g.num_top_segments, -1, np.int64)
    elif g.num_bottom_segments:
        g.bot_top_parse = np.full(g.num_bottom_segments, -1, np.int64)


def run(argv=None):
    p = make_parser("halReplaceGenome", "Replace a genome from donor alignments")
    p.add_argument("inFile")
    p.add_argument("genomeName")
    p.add_argument("--bottomAlignmentFile", default="")
    p.add_argument("--topAlignmentFile", default="")
    p.add_argument("--noMarkAncestors", action="store_true")
    p.add_argument("--noBottomAlignment", action="store_true")
    p.add_argument("--noTopAlignment", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln, fmt = open_for_update(o.inFile)
    name = o.genomeName
    if name not in aln.tree:
        raise HalError("Genome %s not found" % name)
    touched = {name}
    if o.topAlignmentFile and not o.noTopAlignment:
        donor = open_alignment(o.topAlignmentFile)
        _transplant_tops(aln, donor, name)
        touched.add(aln.tree.parent(name))
    if o.bottomAlignmentFile and not o.noBottomAlignment:
        donor = open_alignment(o.bottomAlignmentFile)
        _transplant_bottoms(aln, donor, name)
        touched.update(aln.tree.children(name))
    for t in touched:
        if t:
            _fix_parse(aln.open_genome(t))
    if not o.noMarkAncestors:
        mark_ancestors_for_update(aln, name)
    for t in sorted(t for t in touched if t):
        validate_genome(aln, t)
    save_back(aln, o.inFile, fmt)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

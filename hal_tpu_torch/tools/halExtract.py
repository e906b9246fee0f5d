"""Port copy of hal_tpu/tools/halExtract.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

halExtract — copy/convert an alignment, optionally a subtree
(reference extract/impl/halExtract.cpp — the official format converter,
README.md:11)."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.storage import save_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main


def extract_subtree(aln: Alignment, root: str) -> Alignment:
    """New alignment rooted at `root`: the new root keeps only its bottom
    structure (tops/parent links dropped), descendants copied whole."""
    if root not in aln.tree:
        raise HalError("Root genome %s not found" % root)
    out = Alignment()
    # rebuild tree containing only the subtree
    from hal_tpu_torch.tree import Tree

    t = Tree()
    t.add_root(root)
    for name in aln.tree.preorder(root):
        for child in aln.tree.children(name):
            t.add_child(name, child, aln.tree.branch_length(child))
    out.tree = t
    out.metadata = dict(aln.metadata)
    for name in t.names():
        g = aln.open_genome(name).copy()
        if name == root:
            n_top = g.num_top_segments
            # drop the top array: root of the new alignment has no parent
            g.top_start = np.array([g.length], np.int64)
            g.top_parent = np.zeros(0, np.int64)
            g.top_parent_reversed = np.zeros(0, np.uint8)
            g.top_bottom_parse = np.zeros(0, np.int64)
            g.top_paralogy = np.zeros(0, np.int64)
            g.seq_top = np.zeros(g.num_sequences + 1, np.int64)
            g.bot_top_parse = np.full(g.num_bottom_segments, NULL_INDEX, np.int64)
        out._genomes[name] = g
    return out


def run(argv=None):
    p = make_parser("halExtract", "Extract hal database (copy, convert format, or subtree)")
    p.add_argument("inHalPath")
    p.add_argument("outHalPath")
    p.add_argument("--outputFormat", default="",
                   help="hdf5 or halz (same as input by default)")
    p.add_argument("--root", default="", help="root of subtree to extract")
    add_storage_options(p, write=True)
    o = p.parse_args(argv)

    aln = open_alignment(o.inHalPath)
    if o.root:
        aln = extract_subtree(aln, o.root)
    else:
        # materialize everything (lazy loaders would hold the input open)
        for n in aln.genome_names():
            aln.open_genome(n)
    fmt = o.outputFormat or o.format
    kw = {}
    if fmt:
        kw["fmt"] = fmt
    else:
        from hal_tpu_torch.storage import detect_format

        kw["fmt"] = detect_format(o.inHalPath)
    save_alignment(aln, o.outHalPath, **kw)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

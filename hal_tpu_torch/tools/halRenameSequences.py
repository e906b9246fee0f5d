"""Port copy of hal_tpu/tools/halRenameSequences.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halRenameSequences (reference modify/halRenameSequences.cpp)."""

from __future__ import annotations

import sys

from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._modify_common import open_for_update, save_back
from hal_tpu_torch.tools.halRenameGenomes import read_rename_file


def run(argv=None):
    p = make_parser("halRenameSequences", "Rename sequences of a genome in place")
    p.add_argument("halFile")
    p.add_argument("genome")
    p.add_argument("renameFile", help="tsv: old-name <tab> new-name")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln, fmt = open_for_update(o.halFile)
    g = aln.open_genome(o.genome)
    pairs = read_rename_file(o.renameFile)
    names = set(g.seq_names)
    for old, new in pairs:
        if old not in names:
            raise HalError("Sequence %s not found in genome %s" % (old, o.genome))
        if new in names:
            raise HalError("Sequence %s already exists" % new)
    mapping = dict(pairs)
    g.seq_names = [mapping.get(s, s) for s in g.seq_names]
    save_back(aln, o.halFile, fmt)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

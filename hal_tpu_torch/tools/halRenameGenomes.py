"""Port copy of hal_tpu/tools/halRenameGenomes.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halRenameGenomes (reference modify/halRenameGenomes.cpp)."""

from __future__ import annotations

import sys

from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._modify_common import open_for_update, save_back


def read_rename_file(path):
    pairs = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) != 2:
                raise HalError("invalid rename file line: " + line)
            pairs.append((parts[0], parts[1]))
    return pairs


def run(argv=None):
    p = make_parser("halRenameGenomes", "Rename genomes in a hal file in place")
    p.add_argument("halFile")
    p.add_argument("renameFile", help="tsv: old-name <tab> new-name")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln, fmt = open_for_update(o.halFile)
    pairs = read_rename_file(o.renameFile)
    for old, new in pairs:
        if old not in aln.tree:
            raise HalError("Genome %s not found" % old)
        if new in aln.tree:
            raise HalError("Genome %s already exists" % new)
    for old, new in pairs:
        aln.rename_genome(old, new)
    save_back(aln, o.halFile, fmt)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

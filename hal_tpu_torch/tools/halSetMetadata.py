"""Port copy of hal_tpu/tools/halSetMetadata.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halSetMetadata (reference modify/halSetMetadata.cpp)."""

from __future__ import annotations

import sys

from hal_tpu_torch.tools import add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._modify_common import open_for_update, save_back


def run(argv=None):
    p = make_parser("halSetMetadata", "Set metadata for an alignment or genome")
    p.add_argument("halFile")
    p.add_argument("key")
    p.add_argument("value")
    p.add_argument("--genome", default=None,
                   help="genome to set metadata for instead of the alignment")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln, fmt = open_for_update(o.halFile)
    if o.genome:
        aln.open_genome(o.genome).metadata[o.key] = o.value
    else:
        aln.metadata[o.key] = o.value
    save_back(aln, o.halFile, fmt)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

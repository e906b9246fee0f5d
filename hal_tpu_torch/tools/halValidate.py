"""Port copy of hal_tpu/tools/halValidate.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halValidate — structural validation CLI
(reference validate/halValidateMain.cpp:16-46)."""

from __future__ import annotations

import sys

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops.validate import validate_alignment, validate_genome
from hal_tpu_torch.tools import add_storage_options, make_parser, tool_main


def run(argv=None):
    p = make_parser("halValidate", "Check if hal database is valid")
    p.add_argument("halFile")
    p.add_argument("--genome", default=None, help="validate just the specified genome")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln = open_alignment(o.halFile)
    if o.genome:
        validate_genome(aln, o.genome)
    else:
        validate_alignment(aln)
    sys.stdout.write("\nFile valid\n")


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

"""Port copy of hal_tpu/tools/halWriteNucleotides.py (numpy only; the same
code, imports pointing at hal_tpu_torch).

halWriteNucleotides — apply per-base edits from a tsv
(reference modify/halWriteNucleotides.cpp: lines of
`genome <tab> pos <tab> prevChar <tab> newChar`)."""

from __future__ import annotations

import sys

from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._modify_common import open_for_update, save_back


def run(argv=None):
    p = make_parser("halWriteNucleotides", "Write nucleotide changes from tsv into hal")
    p.add_argument("inFile")
    p.add_argument("tsvFile")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln, fmt = open_for_update(o.inFile)
    with open(o.tsvFile) as fh:
        for ln, line in enumerate(fh, 1):
            parts = line.split()
            if not parts:
                continue
            name, pos, prev, new = parts[0], int(parts[1]), parts[2], parts[3]
            g = aln.open_genome(name)
            cur = g.get_dna_string(pos, 1)
            if cur.upper() != prev.upper():
                # reference retries on the reverse strand before failing
                from hal_tpu_torch import dna as dnacodec

                rc = dnacodec.reverse_complement(cur.encode()).tobytes().decode()
                if rc.upper() != prev.upper():
                    raise HalError(
                        "previous nucleotide %s does not match expected %s! "
                        "Aborting early. Your hal file could be invalid now." % (cur, prev))
            g.set_dna(pos, new)
    save_back(aln, o.inFile, fmt)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

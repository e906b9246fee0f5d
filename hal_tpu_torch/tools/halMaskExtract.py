"""Port copy of hal_tpu/tools/halMaskExtract.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halMaskExtract — BED of soft-masked (lowercase) regions
(reference extract/impl/halMaskExtractor.cpp, halMaskExtractMain.cpp)."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch import dna as dnacodec
from hal_tpu_torch.tools import add_storage_options, make_parser, out_stream, tool_main


def masked_runs(bases: np.ndarray):
    """(start, end) runs of lowercase bases — bulk run-length detection."""
    masked = (bases >= 97) & (bases <= 122)
    if not masked.any():
        return np.zeros((0, 2), np.int64)
    d = np.diff(masked.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if masked[0]:
        starts = np.concatenate([[0], starts])
    if masked[-1]:
        ends = np.concatenate([ends, [len(masked)]])
    return np.stack([starts, ends], axis=1)


def run(argv=None):
    p = make_parser("halMaskExtract", "Write masked intervals of genome into bed file")
    p.add_argument("halFile")
    p.add_argument("genome")
    p.add_argument("--maskFile", default="stdout")
    p.add_argument("--extend", type=int, default=0)
    p.add_argument("--extendPct", type=float, default=0.0)
    add_storage_options(p)
    o = p.parse_args(argv)
    aln = open_alignment(o.halFile)
    g = aln.open_genome(o.genome)
    os_ = out_stream(o.maskFile)
    for si in range(g.num_sequences):
        ln = g.seq_length(si)
        if ln == 0:
            continue
        bases = g.get_dna(int(g.seq_start[si]), ln)
        runs = masked_runs(bases)
        for a, b in runs:
            if o.extend:
                a, b = a - o.extend, b + o.extend
            elif o.extendPct:
                e = int((b - a) * o.extendPct / 100.0 + 0.5)
                a, b = a - e, b + e
            a, b = max(0, int(a)), min(ln, int(b))
            os_.write("%s\t%d\t%d\n" % (g.seq_names[si], a, b))
    if os_ is not sys.stdout:
        os_.close()


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

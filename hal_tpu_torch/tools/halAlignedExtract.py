"""Port copy of hal_tpu/tools/halAlignedExtract.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

halAlignedExtract — BED of regions aligned to the parent genome
(reference extract/impl/halAlignedExtract.cpp)."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, out_stream, tool_main


def aligned_intervals(g) -> np.ndarray:
    """Merged genome-coordinate intervals of top segments with a parent."""
    has = g.top_parent != NULL_INDEX
    idx = np.flatnonzero(has)
    if len(idx) == 0:
        return np.zeros((0, 2), np.int64)
    lo = g.top_start[idx]
    hi = g.top_start[idx + 1]
    # merge adjacent/contiguous
    brk = np.concatenate([[True], lo[1:] != hi[:-1]])
    starts = lo[brk]
    run_id = np.cumsum(brk) - 1
    ends = np.zeros(int(run_id[-1]) + 1, np.int64)
    np.maximum.at(ends, run_id, hi)
    return np.stack([starts, ends], axis=1)


def complement_intervals(iv: np.ndarray, bounds) -> np.ndarray:
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        pos = lo
        for a, b in iv:
            if b <= lo or a >= hi:
                continue
            a, b = max(a, lo), min(b, hi)
            if a > pos:
                out.append((pos, a))
            pos = b
        if pos < hi:
            out.append((pos, hi))
    return np.array(out, np.int64).reshape(-1, 2)


def run(argv=None):
    p = make_parser("halAlignedExtract", "Extract aligned regions of genome (to parent) into bed file")
    p.add_argument("halPath")
    p.add_argument("genome")
    p.add_argument("--alignedFile", default="stdout")
    p.add_argument("--complement", action="store_true")
    p.add_argument("--viewParentCoords", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln = open_alignment(o.halPath)
    g = aln.open_genome(o.genome)
    parent = aln.tree.parent(o.genome)
    os_ = out_stream(o.alignedFile)
    iv = aligned_intervals(g)
    if o.complement:
        iv = complement_intervals(iv, g.seq_start.tolist())
    pg = aln.open_genome(parent) if parent else None
    for a, b in iv:
        si = int(np.searchsorted(g.seq_start, a, side="right")) - 1
        base = int(g.seq_start[si])
        if o.viewParentCoords and pg is not None and not o.complement:
            # one line per top segment with its parent interval
            for t in range(int(g.top_index_at(a)), int(g.top_index_at(b - 1)) + 1):
                pidx = g.top_parent[t]
                if pidx == NULL_INDEX:
                    continue
                ps = int(pg.bot_start[pidx])
                pe = int(pg.bot_start[pidx + 1])
                psi = int(np.searchsorted(pg.seq_start, ps, side="right")) - 1
                os_.write("%s\t%d\t%d\t%s:%d-%d:%s\n" % (
                    g.seq_names[si], int(g.top_start[t]) - base,
                    int(g.top_start[t + 1]) - base,
                    pg.seq_names[psi], ps - int(pg.seq_start[psi]),
                    pe - int(pg.seq_start[psi]),
                    "-" if g.top_parent_reversed[t] else "+"))
        else:
            os_.write("%s\t%d\t%d\n" % (g.seq_names[si], int(a) - base, int(b) - base))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

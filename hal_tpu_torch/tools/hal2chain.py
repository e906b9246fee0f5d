"""Port copy of hal_tpu/tools/hal2chain.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

hal2chain — UCSC chain output of a genome vs its parent
(reference blockViz/impl/hal2chain.cpp; the referenced halChain.h is absent
from the reference snapshot, so serialization follows the standard UCSC
chain spec: header `chain score tName tSize tStrand tStart tEnd qName qSize
qStrand qStart qEnd id` + `size dt dq` block lines).

Chains are gapped runs: matched top segments merged across indels
<= maxGap (the GappedTopSegmentIterator equivalence)."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, out_stream, tool_main


def run(argv=None):
    p = make_parser("hal2chain", "Retrieve chain (pairwise alignment) of genome vs its parent")
    p.add_argument("halFile")
    p.add_argument("genome", help="(query) genome to process")
    p.add_argument("--sequence", default="")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--length", type=int, default=0)
    p.add_argument("--chainFile", default="stdout")
    p.add_argument("--maxGap", type=int, default=20)
    add_storage_options(p)
    o = p.parse_args(argv)
    aln = open_alignment(o.halFile)
    child = o.genome
    if child not in aln.tree or aln.tree.parent(child) is None:
        raise HalError("genome must exist and have a parent")
    parent = aln.tree.parent(child)
    g = aln.open_genome(child)
    pg = aln.open_genome(parent)
    slot = aln.tree.child_index(parent, child)
    os_ = out_stream(o.chainFile)

    t_idx = np.flatnonzero(g.top_parent != NULL_INDEX)
    if len(t_idx) == 0:
        return
    p_idx = g.top_parent[t_idx]
    rev = g.top_parent_reversed[t_idx].astype(bool)
    t_seq = g.seq_index_at(g.top_start[t_idx])
    p_seq = pg.seq_index_at(pg.bot_start[p_idx])

    # window restriction in child genome coordinates
    if o.sequence:
        si = g.sequence_index(o.sequence)
        w_lo = int(g.seq_start[si]) + o.start
        w_hi = w_lo + (o.length or (g.seq_length(si) - o.start))
    else:
        w_lo, w_hi = o.start, o.start + (o.length or (g.length - o.start))
    keep = (g.top_start[t_idx] < w_hi) & (g.top_start[t_idx + 1] > w_lo)
    t_idx, p_idx, rev, t_seq, p_seq = (t_idx[keep], p_idx[keep], rev[keep],
                                       t_seq[keep], p_seq[keep])
    n = len(t_idx)
    if n == 0:
        return

    same = (t_seq[:-1] == t_seq[1:]) & (p_seq[:-1] == p_seq[1:]) & (rev[:-1] == rev[1:])
    child_gap = (g.top_start[t_idx[1:]] - g.top_start[t_idx[:-1] + 1]).astype(np.int64)
    plo = np.where(rev[:-1], p_idx[1:], p_idx[:-1]) + 1
    phi = np.where(rev[:-1], p_idx[:-1], p_idx[1:])
    par_gap = np.where(phi >= plo,
                       pg.bot_start[np.minimum(phi, pg.num_bottom_segments)] -
                       pg.bot_start[np.minimum(plo, pg.num_bottom_segments)], -1)
    ordered = np.where(rev[:-1], p_idx[1:] <= p_idx[:-1], p_idx[1:] >= p_idx[:-1])
    chain_ok = same & ordered & (child_gap >= 0) & (child_gap <= o.maxGap) & \
        (par_gap >= 0) & (par_gap <= o.maxGap)

    starts = np.concatenate([[True], ~chain_ok])
    first = np.flatnonzero(starts)
    last = np.append(first[1:] - 1, n - 1)
    chain_id = 0
    for a, b in zip(first, last):
        qsi = int(t_seq[a])
        qbase = int(g.seq_start[qsi])
        q_size = g.seq_length(qsi)
        psi = int(p_seq[a])
        pbase = int(pg.seq_start[psi])
        t_size = pg.seq_length(psi)
        r = bool(rev[a])
        q_lo = int(g.top_start[t_idx[a]]) - qbase
        q_hi = int(g.top_start[t_idx[b] + 1]) - qbase
        pmin = int(min(pg.bot_start[p_idx[a]], pg.bot_start[p_idx[b]])) - pbase
        pmax = int(max(pg.bot_start[p_idx[a] + 1], pg.bot_start[p_idx[b] + 1])) - pbase
        score = q_hi - q_lo
        # chain coords: query strand-relative when reversed
        if r:
            c_q_lo = q_size - q_hi
            c_q_hi = q_size - q_lo
        else:
            c_q_lo, c_q_hi = q_lo, q_hi
        os_.write("chain %d %s %d + %d %d %s %d %s %d %d %d\n"
                  % (score, pg.seq_names[psi], t_size, pmin, pmax,
                     g.seq_names[qsi], q_size, "-" if r else "+", c_q_lo, c_q_hi,
                     chain_id))
        ks = list(range(a, b + 1))
        if r:
            ks = ks[::-1]  # target ascending
        for j, k in enumerate(ks):
            size = int(g.top_start[t_idx[k] + 1] - g.top_start[t_idx[k]])
            if j == len(ks) - 1:
                os_.write("%d\n\n" % size)
            else:
                k2 = ks[j + 1]
                dt = int(pg.bot_start[p_idx[k2]] - pg.bot_start[p_idx[k] + 1])
                dq = int(abs(g.top_start[t_idx[k2]] - g.top_start[t_idx[k] + 1])) if not r \
                    else int(g.top_start[t_idx[k]] - g.top_start[t_idx[k2] + 1])
                os_.write("%d\t%d\t%d\n" % (size, dt, max(dq, 0)))
        chain_id += 1


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

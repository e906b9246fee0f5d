"""Port copy of hal_tpu/tools/hal2paf.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

hal2paf — child-vs-parent PAF with cigar for every branch
(reference paf/hal2paf.cpp:120-330).

Vectorized re-design: matched top segments and their block categories
('m' adjacent / 'i' insertion / 'd' deletion / 'o' break,
blockCat hal2paf.cpp:126-174) are computed as whole-array predicates with
prefix sums for the intervening-segment checks; only per-line cigar
assembly stays in a Python loop.
"""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main


def _upper(b):
    return np.where((b >= 97) & (b <= 122), b - 32, b)


def genome_to_paf(out, aln, name: str, full_names: bool) -> None:
    g = aln.open_genome(name)
    parent = aln.tree.parent(name)
    pg = aln.open_genome(parent)
    slot = aln.tree.child_index(parent, name)

    t_idx = np.flatnonzero(g.top_parent != NULL_INDEX)
    if len(t_idx) == 0:
        sys.stderr.write("Warning [hal2paf]: no alignment blocks found for genome %s\n" % name)
        return
    p_idx = g.top_parent[t_idx]
    rev = g.top_parent_reversed[t_idx].astype(bool)

    # canonical-dup parent set (hal2paf.cpp:199-205): parents of canonical
    # paralogs with a ring are never 'deleted'
    ring = g.top_paralogy != NULL_INDEX
    canon = np.zeros(g.num_top_segments, bool)
    m = g.top_parent != NULL_INDEX
    canon[m] = pg.bot_child[g.top_parent[m], slot] == np.flatnonzero(m)
    dup_parent = np.zeros(pg.num_bottom_segments + 1, np.int64)
    dp = g.top_parent[ring & canon & m]
    dup_parent[dp] = 1

    # per-bottom "unaligned for this child and not a dup parent" prefix sums
    unchilded = (pg.bot_child[:, slot] == NULL_INDEX) & (dup_parent[:-1] == 0)
    pre = np.concatenate([[0], np.cumsum(unchilded.astype(np.int64))])

    # sequence ids of tops and parent bottoms
    t_seq = g.seq_index_at(g.top_start[t_idx])
    p_seq = pg.seq_index_at(pg.bot_start[p_idx])

    # category of the junction between consecutive matches i -> i+1
    t1, t2 = t_idx[:-1], t_idx[1:]
    p1, p2 = p_idx[:-1], p_idx[1:]
    r1, r2 = rev[:-1], rev[1:]
    same = (t_seq[:-1] == t_seq[1:]) & (p_seq[:-1] == p_seq[1:]) & (r1 == r2)
    top_adj = t2 == t1 + 1
    bot_adj = np.where(r1, p1 == p2 + 1, p2 == p1 + 1)
    cat = np.full(len(t1), b"o"[0], np.uint8)
    cat[same & top_adj & bot_adj] = b"m"[0]
    cat[same & bot_adj & (t2 > t1 + 1)] = b"i"[0]
    # deletion: top adjacent, parent gap, all intervening bottoms unaligned
    lo = np.where(r1, p2, p1) + 1
    hi = np.where(r1, p1, p2)
    gap = hi - lo
    all_unaligned = (pre[np.maximum(hi, lo)] - pre[lo]) == np.maximum(gap, 0)
    del_ok = same & top_adj & (gap > 0) & all_unaligned
    cat[del_ok] = b"d"[0]

    # emit runs
    n = len(t_idx)
    i = 0
    while i < n:
        j = i
        cigar = []
        matches = 0
        snps = 0
        gaps = 0

        def add_match(k):
            nonlocal matches, snps
            ln = int(g.top_start[t_idx[k] + 1] - g.top_start[t_idx[k]])
            if cigar and cigar[-1][0] == "M":
                cigar[-1][1] += ln
            else:
                cigar.append(["M", ln])
            matches += ln
            tb = _upper(g.get_dna(int(g.top_start[t_idx[k]]), ln))
            bb = _upper(pg.get_dna(int(pg.bot_start[p_idx[k]]), ln, reversed_=bool(rev[k])))
            snps += int((tb != bb).sum())

        add_match(i)
        while j < n - 1 and cat[j] != b"o"[0]:
            if cat[j] == b"i"[0]:
                ln = int(g.top_start[t_idx[j + 1]] - g.top_start[t_idx[j] + 1])
                cigar.append(["I", ln])
                gaps += ln
            elif cat[j] == b"d"[0]:
                if rev[j]:
                    ln = int(pg.bot_start[p_idx[j]] - pg.bot_start[p_idx[j + 1] + 1])
                else:
                    ln = int(pg.bot_start[p_idx[j + 1]] - pg.bot_start[p_idx[j] + 1])
                cigar.append(["D", ln])
                gaps += ln
            j += 1
            add_match(j)
        # line spans matches i..j
        si = int(t_seq[i])
        q_name = ("%s.%s" % (name, g.seq_names[si])) if full_names else g.seq_names[si]
        q_len = g.seq_length(si)
        q_start = int(g.top_start[t_idx[i]] - g.seq_start[si])
        q_end = int(g.top_start[t_idx[j] + 1] - g.seq_start[si])
        pi = int(p_seq[i])
        t_name = ("%s.%s" % (parent, pg.seq_names[pi])) if full_names else pg.seq_names[pi]
        t_len = pg.seq_length(pi)
        pstarts = pg.bot_start[p_idx[i:j + 1]] - pg.seq_start[pi]
        pends = pg.bot_start[p_idx[i:j + 1] + 1] - pg.seq_start[pi]
        t_start = int(pstarts.min())
        t_end = int(pends.max())
        reversed_ = bool(rev[i])
        cig = list(reversed(cigar)) if reversed_ else cigar
        cigar_str = "".join("%d%s" % (ln, op) for op, ln in cig)
        out.write("%s\t%d\t%d\t%d\t%s\t%s\t%d\t%d\t%d\t%d\t%d\t255\tcg:Z:%s\n"
                  % (q_name, q_len, q_start, q_end, "-" if reversed_ else "+",
                     t_name, t_len, t_start, t_end, matches - snps,
                     matches + gaps, cigar_str))
        i = j + 1


def run(argv=None):
    p = make_parser("hal2paf", "Export pairwise alignment of each branch to PAF")
    p.add_argument("inHalPath")
    p.add_argument("--rootGenome", default="", help="clade root (HAL root if empty)")
    p.add_argument("--onlySequenceNames", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)

    aln = open_alignment(o.inHalPath)
    if aln.num_genomes == 0:
        raise HalError("input hal alignmenet is empty")
    root = o.rootGenome or aln.root_name
    if root not in aln.tree:
        raise HalError("Root genome, %s, not found in alignment" % o.rootGenome)

    queue = list(aln.tree.children(root))
    while queue:
        child = queue.pop(0)
        genome_to_paf(sys.stdout, aln, child, not o.onlySequenceNames)
        queue.extend(aln.tree.children(child))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

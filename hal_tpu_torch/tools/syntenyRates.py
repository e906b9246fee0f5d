"""Port copy of hal_tpu/tools/syntenyRates.py (numpy only; imports
pointing at hal_tpu_torch), with one declared divergence: --device
{cuda,cpu} (default cuda).  Every gene is lifted in one batched pass on
that device (Liftover.map_lines) before the pair loop, whose lift_gene
calls then read the mapped fragments; the original maps each gene on the
host as the loop reaches it.  Stdout and stderr are the original's.

syntenyRates — rate of preserved gene-pair synteny between two genomes.

Measures, for consecutive gene pairs on each query chromosome, whether the
pair lands on one target chromosome with the same relative order and
orientation.  Output lines (the per-pair diagnostics and the final summary)
match the reference tool `analysis/syntenyRates.py`; the computation is
re-designed around hal_tpu's in-process bulk liftover instead of the
reference's one-`halLiftover`-subprocess-per-gene flow, with numpy doing
the BED canonicalization.
"""

from __future__ import annotations

import io
import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._device import add_device_option, require_device

# pair verdicts, in evaluation order; each maps to the message the
# reference prints for that condition
_DIFF_QUERY_CHR = "INVALID: on different query chr"
_NO_SHARED_TARGET = "INVALID: on different target chr"
_MANY_TARGETS = "INVALID: multiple possible target chrs"
_FLIP = "BREAK: Relative orientations not equal in source v. target"
_OVERLAP = "BREAK: Overlap detected"
_REORDER = "BREAK: Order changed"


def load_genes(stream) -> list[list]:
    """BED6 rows sorted by (chrom, start) with mutually-overlapping
    neighbours dropped; numpy lexsort + vectorized overlap scan (the
    reference walks adjacent pairs in python and removes both members of
    any overlapping pair — same effect, same WARNING lines)."""
    rows = [ln.split() for ln in stream.read().splitlines() if ln]
    if not rows:
        return []
    if min(len(r) for r in rows) < 6:
        raise RuntimeError("BED file must have strand information")
    chrom = np.array([r[0] for r in rows])
    start = np.array([int(r[1]) for r in rows])
    end = np.array([int(r[2]) for r in rows])
    order = np.lexsort((start, chrom))
    rows = [rows[i] for i in order]
    chrom, start, end = chrom[order], start[order], end[order]

    drop = np.zeros(len(rows), bool)
    frontier = end[0]  # rightmost end of a KEPT row on the current chrom
    for k in range(len(rows) - 1):
        a, b = k, k + 1
        if chrom[a] != chrom[b]:
            frontier = start[b]
            continue
        if end[a] >= start[b] or frontier > start[b]:
            sys.stderr.write("WARNING: discarding overlapping lines %s,\n%s\n"
                             % ("\t".join(rows[a]), "\t".join(rows[b])))
            drop[a] = drop[b] = True
        else:
            frontier = end[a]
    return [r for k, r in enumerate(rows) if not drop[k]]


def lift_gene(lifter, row, merge: bool) -> dict:
    """Lift one gene; {target sequence: [chrom, lo, hi, name, score, strand]}.

    Multi-fragment results are either merged per target sequence (--
    mergeBedLines, consistent strand required) or rejected, with the
    reference's diagnostic prints."""
    sink = io.StringIO()
    lifter.convert(io.StringIO("\t".join(map(str, row)) + "\n"), sink)
    frags = [ln.split() for ln in sink.getvalue().splitlines() if ln]
    if not frags:
        print("INVALID: no map to target")
        return {}
    if len(frags) == 1:
        return {frags[0][0]: frags[0]}
    hits = {}
    for f in frags:
        hits.setdefault(f[0], []).append(f)
    out = {}
    for tseq, group in hits.items():
        if len({f[5] for f in group}) > 1:
            print("POSSIBLYBAD: maps to two different strands on chr")
        elif merge:
            lo = min(int(f[1]) for f in group)
            hi = max(int(f[2]) for f in group)
            print("MERGED on chr %s -- distance %d" % (tseq, hi - lo))
            f0 = group[0]
            out[tseq] = [f0[0], lo, hi, f0[3], f0[4], f0[5]]
    return out


def judge_pair(a, a_t, b, b_t) -> str | None:
    """None when the (a, b) gene pair is syntenic in the target, else the
    break verdict.  a/b are query rows (a upstream), a_t/b_t their lifted
    rows on one shared target sequence."""
    a_lo, a_hi = int(a_t[1]), int(a_t[2])
    b_lo, b_hi = int(b_t[1]), int(b_t[2])
    same_strand_src = a[5] == b[5]
    same_strand_tgt = a_t[5] == b_t[5]
    if same_strand_src != same_strand_tgt:
        return _FLIP
    # closed-interval intersection: shared endpoints count as overlap
    if a_lo <= b_hi and b_lo <= a_hi:
        return _OVERLAP
    # a gene whose own strand flipped between source and target mirrors the
    # expected order of the pair
    mirrored = a[5] != a_t[5]
    upstream_ok = (a_lo > b_lo) if mirrored else (a_lo < b_lo)
    return None if upstream_ok else _REORDER


def run(argv=None):
    from hal_tpu_torch.io.bed import read_bed
    from hal_tpu_torch.ops.liftover import Liftover

    p = make_parser("syntenyRates", "Gene-pair synteny rate between genomes")
    p.add_argument("halFile")
    p.add_argument("srcGenome")
    p.add_argument("bedFile")
    p.add_argument("destGenome")
    p.add_argument("--mergeBedLines", action="store_true", default=False)
    add_device_option(p)
    add_storage_options(p)
    o = p.parse_args(argv)
    require_device(o.device)

    aln = open_alignment(o.halFile)
    lifter = Liftover(aln, o.srcGenome, o.destGenome, device=o.device)
    with open(o.bedFile) as f:
        genes = load_genes(f)
    beds = []
    for row in genes:
        try:
            beds.extend(read_bed(io.StringIO("\t".join(row) + "\n")))
        except ValueError:
            pass  # raised again where the pair loop lifts it, as before
    lifter.map_lines(beds)

    pairs = syntenic = 0
    for k in range(len(genes) - 1):
        a, b = genes[k], genes[k + 1]
        if a[0] != b[0]:
            print(_DIFF_QUERY_CHR)
            continue
        a_hits = lift_gene(lifter, a, o.mergeBedLines)
        b_hits = lift_gene(lifter, b, o.mergeBedLines)
        shared = [t for t in a_hits if t in b_hits]
        if len(shared) > 1:
            print(_MANY_TARGETS)
            continue
        if not shared:
            print(_NO_SHARED_TARGET)
            continue
        pairs += 1
        a_t, b_t = a_hits[shared[0]], b_hits[shared[0]]
        for r in (a, a_t, b, b_t):  # diagnostics print int coords
            r[1], r[2] = int(r[1]), int(r[2])
        verdict = judge_pair(a, a_t, b, b_t)
        if verdict is None:
            syntenic += 1
        else:
            print(verdict)
            print("synteny break:")
            print(a)
            print(a_t)
            print(b)
            print(b_t)
    rate = syntenic / pairs if pairs else 0.0
    print("gene pair synteny rate: %f, num syntenies: %d, num pairs: %d"
          % (rate, syntenic, pairs))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

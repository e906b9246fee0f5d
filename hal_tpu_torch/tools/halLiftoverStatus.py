"""Port copy of hal_tpu/tools/halLiftoverStatus.py (numpy only; imports
pointing at hal_tpu_torch), with two declared divergences:

* --device {cuda,cpu} (default cuda): one Liftover maps every BED line's
  intervals on the batched mapper (Liftover.visit_lines_batched,
  BATCH_LINES lines a dispatch) on that device, where the original builds
  a new host Liftover for each line.  Each line's PSL hits, the out file
  and stderr equal the original's: a missing sequence is reported on
  every line that names it, as a fresh Liftover does.
* line_status takes a line's read_bed12 fields and its PSL text (the
  lifting moved to line_statuses).

halLiftoverStatus — per-BED-entry report of how a region maps to a
target genome: mapped bases, insertion/deletion lengths, out-of-order
(rearrangement) flag and frame preservation.

Output format matches the reference tool (`liftover/halLiftoverStatus.py`:
header + one TSV row per BED entry); the machinery is re-designed:

* the reference launches one `halLiftover --outPSL` subprocess per BED
  line under jobTree — here the liftover runs in-process (ops.liftover);
* PSL hits are normalized once into query-forward/target-forward numpy
  block arrays instead of repeated strand re-flips;
* the best mutually-disjoint subset of hits is found with an exact
  branch-and-bound over the (tiny) block-overlap conflict graph — the
  reference enumerates every maximal disjoint set (exponential without a
  bound) and picks the max-coverage one; both select the maximum-coverage
  conflict-free subset;
* per-block status is interval algebra over the normalized arrays, with
  pieces visited in GLOBAL query order.  (The reference visits them
  PSL-major: when two disjoint hits interleave in query space its
  adjacent-piece comparison can skip a target gap; in such out-of-order
  genes this tool may report one more Ins value — the OO flag and
  everything else agree.)
"""

from __future__ import annotations

import io
import sys
from dataclasses import dataclass, field

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._device import add_device_option, require_device


@dataclass
class Hit:
    """One PSL alignment, normalized: block arrays in query-forward and
    target-forward coordinates, rel = '-' when the strands differ."""

    qname: str
    qsize: int
    tname: str
    tsize: int
    rel: str
    qlo: np.ndarray   # (nblocks,) query-forward block starts, ascending
    qhi: np.ndarray
    tlo: np.ndarray   # (nblocks,) target-forward block starts
    thi: np.ndarray
    matched: int      # total aligned bases (the Map column's unit)

    @property
    def q_span(self):
        return int(self.qlo[0]), int(self.qhi[-1])


def parse_psl(line: str) -> Hit:
    """21-field PSL -> normalized Hit (PSL spec: qStarts/tStarts live in
    strand coordinates; flip by size for '-' strands)."""
    f = line.rstrip("\n").split("\t")
    if len(f) != 21:
        raise ValueError("Psl format requires 21 fields: %r" % line)
    strand = f[8]
    qstrand = strand[0]
    tstrand = strand[1] if len(strand) > 1 else "+"
    qsize, tsize = int(f[10]), int(f[14])
    sizes = np.array([int(x) for x in f[18].rstrip(",").split(",")], np.int64)
    qs = np.array([int(x) for x in f[19].rstrip(",").split(",")], np.int64)
    ts = np.array([int(x) for x in f[20].rstrip(",").split(",")], np.int64)
    qlo, qhi = qs, qs + sizes
    if qstrand == "-":
        qlo, qhi = qsize - qhi, qsize - qlo
    tlo, thi = ts, ts + sizes
    if tstrand == "-":
        tlo, thi = tsize - thi, tsize - tlo
    order = np.argsort(qlo, kind="stable")
    return Hit(qname=f[9], qsize=qsize, tname=f[13], tsize=tsize,
               rel="+" if qstrand == tstrand else "-",
               qlo=qlo[order], qhi=qhi[order], tlo=tlo[order], thi=thi[order],
               matched=int(sizes.sum()))


def _block_overlap(a: Hit, b: Hit) -> int:
    """Query bases shared by any block pair (vectorized outer clip)."""
    if a.qname != b.qname:
        return 0
    lo = np.maximum(a.qlo[:, None], b.qlo[None, :])
    hi = np.minimum(a.qhi[:, None], b.qhi[None, :])
    return int(np.maximum(hi - lo, 0).sum())


def best_disjoint(hits: list[Hit]) -> list[Hit]:
    """Maximum-total-matched subset with pairwise block-disjoint query
    coverage: exact branch-and-bound on the conflict graph (hits per BED
    line are few; the optimistic bound prunes hard)."""
    n = len(hits)
    if n == 1:
        return hits
    conflict = [0] * n
    for i in range(n):
        for j in range(i + 1, n):
            if _block_overlap(hits[i], hits[j]) > 0:
                conflict[i] |= 1 << j
                conflict[j] |= 1 << i
    w = [h.matched for h in hits]
    order = sorted(range(n), key=lambda i: -w[i])
    best = (0, [])

    def grow(k, chosen, banned, weight, rest):
        nonlocal best
        if weight + rest <= best[0]:
            return
        if k == n:
            if weight > best[0]:
                best = (weight, chosen)
            return
        i = order[k]
        if not (banned >> i) & 1:
            grow(k + 1, chosen + [i], banned | conflict[i], weight + w[i],
                 rest - w[i])
        grow(k + 1, chosen, banned, weight, rest - w[i])

    grow(0, [], 0, 0, sum(w))
    idx = sorted(best[1], key=lambda i: (hits[i].qname, hits[i].q_span))
    return [hits[i] for i in idx]


@dataclass
class Pieces:
    """The chosen hits clipped to one BED block [qs, qe): parallel arrays
    in ascending query order."""

    qlo: np.ndarray
    qhi: np.ndarray
    tlo: np.ndarray
    thi: np.ndarray
    rel: list
    tname: list
    tsize: list


def clip_to_block(chosen: list[Hit], qs: int, qe: int) -> Pieces:
    qlo, qhi, tlo, thi, rel, tname, tsize = [], [], [], [], [], [], []
    for h in chosen:
        a = np.maximum(h.qlo, qs)
        b = np.minimum(h.qhi, qe)
        keep = np.flatnonzero(b > a)
        for k in keep:
            qlo.append(int(a[k]))
            qhi.append(int(b[k]))
            if h.rel == "+":
                tlo.append(int(h.tlo[k] + (a[k] - h.qlo[k])))
                thi.append(int(h.tlo[k] + (b[k] - h.qlo[k])))
            else:
                tlo.append(int(h.tlo[k] + (h.qhi[k] - b[k])))
                thi.append(int(h.tlo[k] + (h.qhi[k] - a[k])))
            rel.append(h.rel)
            tname.append(h.tname)
            tsize.append(h.tsize)
    order = np.argsort(np.asarray(qlo, np.int64), kind="stable") if qlo else []
    pick = lambda xs: [xs[i] for i in order]
    return Pieces(qlo=np.asarray(pick(qlo), np.int64),
                  qhi=np.asarray(pick(qhi), np.int64),
                  tlo=np.asarray(pick(tlo), np.int64),
                  thi=np.asarray(pick(thi), np.int64),
                  rel=pick(rel), tname=pick(tname), tsize=pick(tsize))


def block_events(p: Pieces, qs: int, qe: int, edge: float):
    """(ins list, dels list, oo flag) for one BED block.

    dels: unmapped query stretches between mapped pieces (and at the block
    edges when they sit further than `edge` of the block width from the
    boundary).  ins: extra target bases between query-consecutive pieces
    on the same target sequence+strand.  oo: any target-order violation."""
    bs = qe - qs
    n = len(p.qlo)
    dels: list[int] = []
    ins: list[int] = []
    oo = False
    if n == 0:
        if bs > 0 and (1.0 if bs else 0.0) > edge:
            dels.append(bs)
        return ins, dels, oo
    # unmapped gaps (vectorized): before each piece, and after the last
    prev_end = np.concatenate([[qs], p.qhi[:-1]])
    gaps = p.qlo - prev_end
    inner_ok = (p.qlo - qs) / bs > edge
    for g in gaps[(gaps > 0) & inner_ok]:
        dels.append(int(g))
    tail = qe - int(p.qhi[-1])
    if tail > 0 and tail / bs > edge:
        dels.append(tail)
    # target-side adjacency between query-consecutive pieces
    for i in range(1, n):
        near_edge = ((p.qlo[i] - qs) / bs <= edge
                     or (qe - p.qhi[i]) / bs <= edge)
        if near_edge:
            continue
        if p.tname[i] != p.tname[i - 1] or p.rel[i] != p.rel[i - 1]:
            oo = True
        elif p.rel[i] == "+":
            d = int(p.tlo[i] - p.thi[i - 1])
            if d > 0:
                ins.append(d)
            elif d < 0:
                oo = True
        else:
            d = int(p.tlo[i - 1] - p.thi[i])
            if d > 0:
                ins.append(d)
            elif d < 0:
                oo = True
    return ins, dels, oo


def read_bed12(line: str):
    """(chrom, name, abs block ranges) with the reference's BED12 thickStart
    normalization (shift so blockStarts[0] == 0 and end matches)."""
    f = line.split()
    chrom, start, end = f[0], int(f[1]), int(f[2])
    name = f[3] if len(f) > 3 else ""
    if len(f) >= 12:
        sizes = [int(x) for x in f[10].rstrip(",").split(",")]
        starts = [int(x) for x in f[11].rstrip(",").split(",")]
        if starts and (starts[0] != 0 or end != start + starts[-1] + sizes[-1]):
            start += starts[0]
            starts = [s - starts[0] for s in starts]
            end = start + starts[-1] + sizes[-1]
        blocks = [(start + s, start + s + z) for s, z in zip(starts, sizes)]
    else:
        blocks = [(start, end)]
    return chrom, name, blocks


BATCH_LINES = 1 << 14


def line_statuses(aln, src: str, tgt: str, lines, edge: float, device):
    """line_status's fields for each BED line, in order.  The lines'
    intervals are mapped on device BATCH_LINES lines a dispatch; a line the
    original fails on (read_bed12, read_bed) raises after the rows of the
    lines before it, as the original's per-line loop does."""
    from hal_tpu_torch.io.bed import read_bed
    from hal_tpu_torch.ops.liftover import Liftover

    parsed, failure = [], None
    for line in lines:
        try:
            fields = read_bed12(line)
            beds = list(read_bed(io.StringIO(line + "\n")))
        except Exception as e:  # re-raised below, after the earlier rows
            failure = e
            break
        parsed.append((fields, beds))
    if parsed:
        lifter = Liftover(aln, src, tgt, out_psl=True, device=device)
        lifted = lifter.visit_lines_batched(
            [b for _, beds in parsed for b in beds], BATCH_LINES,
            fresh_missed=True)
        for fields, beds in parsed:
            psl = "".join(out.write_psl() for _ in beds
                          for out in next(lifted))
            yield line_status(fields, psl, edge)
    if failure is not None:
        raise failure


def line_status(fields, psl: str, edge: float):
    """One output row's fields for one BED line: its read_bed12 fields and
    the PSL text its liftover wrote."""
    chrom, name, blocks = fields
    length = sum(e - s for s, e in blocks)

    hits = [parse_psl(l) for l in psl.splitlines() if l.strip()]
    if not hits:
        return name, length, 0, [], [], None, None
    chosen = best_disjoint(hits)
    mapped = sum(h.matched for h in chosen)

    ins: list[int] = []
    dels: list[int] = []
    oo = False
    cur_rel = None          # orientation of the previous mapped block
    cur_t = None            # (tname, t0, t1) of the previous mapped block
    for qs, qe in blocks:
        p = clip_to_block(chosen, qs, qe)
        b_ins, b_dels, b_oo = block_events(p, qs, qe, edge)
        ins.extend(b_ins)
        dels.extend(b_dels)
        has = len(p.qlo) > 0
        if b_oo:
            oo = True
        elif has:
            rel, tn = p.rel[0], p.tname[0]
            t0, t1 = int(p.tlo.min()), int(p.thi.max())
            if cur_rel is not None and not oo:
                if cur_rel != rel:
                    oo = True
                elif cur_t and cur_t[0] and tn and tn != cur_t[0]:
                    oo = True
                elif cur_t and ((rel == "+" and cur_t[2] > t0)
                                or (rel == "-" and cur_t[1] < t1)):
                    oo = True
            cur_rel = rel
        if has:
            cur_t = (p.tname[0], int(p.tlo.min()), int(p.thi.max()))
    inframe = not oo and abs(sum(ins) - sum(dels)) % 3 == 0
    return name, length, mapped, ins, dels, oo, inframe


def run(argv=None):
    p = make_parser("halLiftoverStatus",
                    "Report mapping status of each BED entry in a target genome")
    p.add_argument("bedFile")
    p.add_argument("halFile")
    p.add_argument("queryGenome")
    p.add_argument("targetGenome")
    p.add_argument("outFile")
    p.add_argument("--edge", type=float, default=0.0,
                   help="proportion of block at each edge allowed to have errors")
    add_device_option(p)
    add_storage_options(p)
    o = p.parse_args(argv)
    require_device(o.device)

    aln = open_alignment(o.halFile)
    out = sys.stdout if o.outFile in ("stdout", "-") else open(o.outFile, "w")
    out.write("#Name\tLength\tMap\tIns\tDels\tOO\tInframe\n")
    with open(o.bedFile) as f:
        lines = [l for l in (line.strip() for line in f)
                 if l and l[0] != "#"]
        for name, length, mapped, ins, dels, oo, inframe in line_statuses(
                aln, o.queryGenome, o.targetGenome, lines, o.edge, o.device):
            ins_s = ",".join(str(x) for x in ins)
            dels_s = ",".join(str(x) for x in dels)
            if mapped > 0:
                out.write("%s\t%d\t%d\t%s\t%s\t%s\t%s\n" % (
                    name, length, mapped, ins_s, dels_s, oo, inframe))
            else:
                out.write("%s\t%d\t%d\t%s\t%s\tNA\tNA\n" % (
                    name, length, mapped, ins_s, dels_s))
    if out is not sys.stdout:
        out.close()


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

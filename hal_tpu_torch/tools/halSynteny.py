"""Port copy of hal_tpu/tools/halSynteny.py (numpy only; imports pointing
at hal_tpu_torch), with one declared divergence: --device {cuda,cpu}
(default cuda).  build_blocks lifts every query chromosome in one call of
the batched mapper on that device (Liftover.visit_lines_batched), where
the original lifts each on the host; the PSL bytes are the original's.
--alignmentIsPsl lifts nothing and runs on the host, as before.

halSynteny — PSL synteny blocks via weighted-DAG chaining
(reference synteny/impl/halSynteny.cpp, psl_merger.cpp:1-137,
psl_io.cpp construct_psl :52-84).

Anchor blocks come from the batched mapper (whole-genome liftover merged
into colinear runs, replacing Hal2Psl's per-segment walk); chaining is the
reference's algorithm: repeatedly extract the heaviest syntenic path from
the ordered-block DAG until all blocks are consumed."""

from __future__ import annotations

import sys
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops import segmap_host as sm
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._device import add_device_option, require_device


@dataclass
class PslBlock:
    q_start: int
    q_end: int
    t_start: int  # reverse-strand coords when strand == '+-'
    t_end: int
    size: int
    strand: str
    q_name: str
    t_name: str
    q_size: int
    t_size: int


def build_blocks(aln, query, target, query_chromosome=None, *, device):
    """Anchor PSL blocks: lift every query chromosome through the liftover
    PSL pipeline and decompose the merged intervals into per-block PSLs
    (reference Hal2Psl::convert2psl + makeUpPsl,
    synteny/impl/hal2psl.cpp:21-95)."""
    from hal_tpu_torch.io.bed import BedLine
    from hal_tpu_torch.ops.liftover import Liftover

    qg = aln.open_genome(query)
    lifter = Liftover(aln, query, target, traverse_dupes=True, out_psl=True,
                      device=device)
    beds = []
    for si in range(qg.num_sequences):
        chrom = qg.seq_names[si]
        if query_chromosome and chrom != query_chromosome:
            continue
        seq_len = qg.seq_length(si)
        if seq_len <= 0:
            continue
        beds.append(BedLine(chrom=chrom, start=0, end=seq_len, bed_type=3))
    blocks = []
    for lines in lifter.visit_lines_batched(beds, 0):
        for line in lines:
            psl = line.psl
            for (s, ln), q in zip(line.blocks, psl.q_block_starts):
                qs = q - psl.q_chrom_offset
                qe = qs + ln
                if psl.q_strand == "-":
                    qs, qe = psl.q_seq_size - qs - ln, psl.q_seq_size - qs
                ts = s + line.start
                te = ts + ln
                if line.strand == "-":
                    ts, te = psl.t_seq_size - ts - ln, psl.t_seq_size - ts
                blocks.append(PslBlock(qs, qe, ts, te, ln,
                                       psl.q_strand + line.strand,
                                       psl.q_seq_name, line.chrom,
                                       psl.q_seq_size, psl.t_seq_size))
    return blocks


def read_psl_blocks(path):
    """Parse a PSL file into per-block PslBlocks (reference psl.h Psl::parse /
    parseBlocks :81-99, psl_io.cpp get_blocks_set :19-27)."""
    blocks = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            row = line.split("\t")
            if len(row) < 21:
                continue
            strand = row[8]
            q_name, q_size = row[9], int(row[10])
            t_name, t_size = row[13], int(row[14])
            sizes = [int(s) for s in row[18].split(",") if s]
            q_starts = [int(s) for s in row[19].split(",") if s]
            t_starts = [int(s) for s in row[20].split(",") if s]
            for sz, qs, ts in zip(sizes, q_starts, t_starts):
                blocks.append(PslBlock(qs, qs + sz, ts, ts + sz, sz, strand,
                                       q_name, t_name, q_size, t_size))
    return blocks


def dag_merge(blocks, min_block_size, max_anchor_distance):
    """reference psl_merger.cpp dag_merge :109-137."""
    by_q = defaultdict(list)
    for b in blocks:
        by_q[b.q_name].append(b)
    paths = []
    for q_name in sorted(by_q):
        group = sorted(by_q[q_name], key=lambda b: (b.q_start, b.t_start))
        n = len(group)
        hidden = set()

        def syntenic(a, b):
            return (a.q_end <= b.q_start and a.t_end <= b.t_start and
                    a.t_name == b.t_name and a.strand == b.strand and
                    b.q_start - a.q_end < max_anchor_distance and
                    b.t_start - a.t_end < max_anchor_distance)

        dag_cache = {}

        def nexts(i):
            if i in dag_cache:
                return dag_cache[i]
            f = []
            for j in range(i + 1, n):
                if syntenic(group[i], group[j]):
                    if f and syntenic(group[f[0]], group[j]):
                        break
                    f.append(j)
            dag_cache[i] = f
            return f

        while len(hidden) != n:
            # weigh: longest-path DP in index order
            weight = {}
            prev = {}
            for i in range(n):
                if i in hidden:
                    continue
                if i not in weight:
                    weight[i] = group[i].size
                    prev[i] = -1
                for j in nexts(i):
                    if j in hidden:
                        continue
                    alt = weight[i] + group[j].size
                    if j not in weight or weight[j] < alt:
                        weight[j] = alt
                        prev[j] = i
            if not weight:
                break
            # heaviest endpoint (ties -> larger index, matching >= scan)
            best = max(weight, key=lambda i: (weight[i], i))
            path = []
            v = best
            while v != -1:
                path.append(v)
                v = prev[v]
            path.reverse()
            hidden.update(path)
            pb = [group[i] for i in path]
            q_len = pb[-1].q_end - pb[0].q_start
            t_len = pb[-1].t_end - pb[0].t_start
            if q_len >= min_block_size and t_len >= min_block_size:
                paths.append(pb)
    return paths


def write_psl(paths, out):
    """reference psl_io.cpp construct_psl / operator<<."""
    for pb in paths:
        match = sum(b.q_end - b.q_start for b in pb)
        q_ins = [pb[i + 1].q_start - pb[i].q_end for i in range(len(pb) - 1)
                 if pb[i + 1].q_start - pb[i].q_end > 0]
        t_ins = [pb[i + 1].t_start - pb[i].t_end for i in range(len(pb) - 1)
                 if pb[i + 1].t_start - pb[i].t_end > 0]
        strand = pb[0].strand
        t_size = pb[0].t_size
        if strand == "++":
            t_start, t_end = pb[0].t_start, pb[-1].t_end
        else:
            t_start, t_end = t_size - pb[-1].t_end, t_size - pb[0].t_start
        fields = [
            match, 0, 0, 0, len(q_ins), sum(q_ins), len(t_ins), sum(t_ins),
            strand, pb[0].q_name, pb[0].q_size, pb[0].q_start, pb[-1].q_end,
            pb[0].t_name, t_size, t_start, t_end, len(pb),
            ",".join(str(b.size) for b in pb) + ",",
            ",".join(str(b.q_start) for b in pb) + ",",
            ",".join(str(b.t_start) for b in pb) + ",",
        ]
        out.write("\t".join(str(f) for f in fields) + "\n")


def run(argv=None):
    p = make_parser("halSynteny", "Convert hal database to synteny blocks")
    p.add_argument("alignment")
    p.add_argument("outPslPath")
    p.add_argument("--queryGenome", default="")
    p.add_argument("--targetGenome", default="")
    p.add_argument("--minBlockSize", type=int, default=5000)
    p.add_argument("--maxAnchorDistance", type=int, default=5000)
    p.add_argument("--queryChromosome", default="")
    p.add_argument("--alignmentIsPsl", action="store_true")
    add_device_option(p)
    add_storage_options(p)
    o = p.parse_args(argv)
    require_device(o.device)
    if o.alignmentIsPsl:
        blocks = read_psl_blocks(o.alignment)
    else:
        if not o.queryGenome or not o.targetGenome:
            raise HalError("--queryGenome and --targetGenome must be specified")
        aln = open_alignment(o.alignment)
        blocks = build_blocks(aln, o.queryGenome, o.targetGenome,
                              o.queryChromosome or None, device=o.device)
    paths = dag_merge(blocks, o.minBlockSize, o.maxAnchorDistance)
    out = sys.stdout if o.outPslPath in ("stdout", "-") else open(o.outPslPath, "w")
    write_psl(paths, out)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

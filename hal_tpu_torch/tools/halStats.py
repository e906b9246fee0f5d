"""Port copy of hal_tpu/tools/halStats.py (numpy only; the same code,
imports pointing at hal_tpu_torch; --percentID, --coverage and
--allCoverage run the port's copies of halPctId and halCoverage).  The
port's parallel/mp.py runs it.

halStats — alignment statistics (reference stats/impl/halStatsMain.cpp).

Output formats match the reference byte-for-byte where the reference is
deterministic.  Where the reference iterates std::set<const Genome*>
(pointer order — nondeterministic across runs, printGenomes
halStatsMain.cpp:282-296) we use stable name-sorted order instead.
"""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main


def _fmt_g(x: float) -> str:
    return "%g" % x


def print_genomes(os, aln):
    os.write(" ".join(sorted(aln.genome_names())) + "\n")


def print_default(os, aln):
    os.write("\nhal v%s\n" % aln.version)
    os.write(aln.get_newick_tree() + "\n\n")
    os.write("GenomeName, NumChildren, Length, NumSequences, NumTopSegments, NumBottomSegments\n")
    # readGenomeRecursive order: root, then children depth-first (stats/impl/halStats.cpp:51)
    for name in aln.tree.preorder():
        g = aln.open_genome(name)
        os.write("%s, %d, %d, %d, %d, %d\n" % (
            name, g.num_children, g.length, g.num_sequences,
            g.num_top_segments, g.num_bottom_segments))
    os.write("\n")


def print_sequences(os, aln, genome):
    g = aln.open_genome(genome)
    os.write(",".join(g.seq_names) + "\n")


def print_sequence_stats(os, aln, genome):
    g = aln.open_genome(genome)
    if g.num_sequences > 0:
        os.write("SequenceName, Length, NumTopSegments, NumBottomSegments\n")
        for i, name in enumerate(g.seq_names):
            os.write("%s, %d, %d, %d\n" % (
                name, g.seq_length(i),
                int(g.seq_top[i + 1] - g.seq_top[i]),
                int(g.seq_bot[i + 1] - g.seq_bot[i])))
    os.write("\n")


def print_bed_sequences(os, aln, genome):
    g = aln.open_genome(genome)
    for i, name in enumerate(g.seq_names):
        os.write("%s\t0\t%d\n" % (name, g.seq_length(i)))


def print_chrom_sizes(os, aln, genome):
    g = aln.open_genome(genome)
    for i, name in enumerate(g.seq_names):
        os.write("%s\t%d\n" % (name, g.seq_length(i)))


def print_span(os, aln, genomes_csv, keep_root):
    names = genomes_csv.split(",")
    span = aln.tree.spanning_tree(names)
    if len(names) == 2:
        ordered = aln.tree.path(names[0], names[1])
    else:
        ordered = sorted(span)
    out = []
    for n in ordered:
        if keep_root or (aln.tree.parent(n) is not None and aln.tree.parent(n) in span):
            out.append(n)
    os.write(" ".join(out) + (" \n" if out else "\n"))


def print_branches(os, aln):
    out = [n for n in sorted(aln.genome_names()) if aln.tree.parent(n) is not None]
    os.write(" ".join(out) + "\n")


def print_num_segments(os, aln, genome):
    g = aln.open_genome(genome)
    os.write("%d %d\n" % (g.num_top_segments, g.num_bottom_segments))


def print_base_comp(os, aln, pair):
    tokens = pair.split(",")
    if len(tokens) != 2 or int(tokens[1]) == 0:
        raise HalError("Invalid value for --baseComp: %s.  Must be of format genomeName,step" % pair)
    genome, step = tokens[0], int(tokens[1])
    g = aln.open_genome(genome)
    length = g.length
    if step >= length:
        step = length - 1
    from hal_tpu_torch import dna as dnacodec

    positions = np.arange(0, length, step, dtype=np.int64)
    # vectorized sampled base composition (reference loops DnaIterator,
    # halStatsMain.cpp:447-502)
    byte = g.dna[positions >> 1]
    codes = np.where(positions & 1, byte & 0x0F, byte >> 4)
    base = dnacodec.UNPACK_MAP[codes]
    up = np.where((base >= 97) & (base <= 122), base - 32, base)
    counts = [int(np.count_nonzero(up == ord(c))) for c in "ACGT"]
    total = float(sum(counts))
    os.write("\t".join(_fmt_g(c / total) for c in counts) + "\n")


def print_segments(os, aln, genome, top: bool):
    g = aln.open_genome(genome)
    start = g.top_start if top else g.bot_start
    n = g.num_top_segments if top else g.num_bottom_segments
    seq_idx = g.seq_index_at(start[:n]) if n else np.zeros(0, np.int64)
    for i in range(n):
        si = int(seq_idx[i])
        s = int(start[i] - g.seq_start[si])
        os.write("%s\t%d\t%d\n" % (g.seq_names[si], s, s + int(start[i + 1] - start[i])))


def print_metadata(os, md):
    for k in sorted(md):
        os.write("%s\t%s\n" % (k, md[k]))


def print_coverage(os, aln, genome_and_seed, num_samples=1000000):
    """Sampling-based coverage histogram (reference stats/impl/halCoverage.cpp).

    Deferred to the column/mapping engine: implemented in
    hal_tpu_torch.tools.halCoverage; this mode delegates there.
    """
    from hal_tpu_torch.tools import halCoverage

    halCoverage.print_coverage(os, aln, genome_and_seed, num_samples)


def run(argv=None):
    p = make_parser("halStats", "Rertrieve basic statics from a hal database")
    p.add_argument("halFile")
    p.add_argument("--genomes", action="store_true")
    p.add_argument("--sequences", metavar="GENOME")
    p.add_argument("--tree", action="store_true")
    p.add_argument("--branches", action="store_true")
    p.add_argument("--sequenceStats", metavar="GENOME")
    p.add_argument("--bedSequences", metavar="GENOME")
    p.add_argument("--span", metavar="GENOMES")
    p.add_argument("--spanRoot", metavar="GENOMES")
    p.add_argument("--children", metavar="GENOME")
    p.add_argument("--parent", metavar="GENOME")
    p.add_argument("--root", action="store_true")
    p.add_argument("--branchLength", metavar="GENOME")
    p.add_argument("--numSegments", metavar="GENOME")
    p.add_argument("--baseComp", metavar="GENOME,STEP")
    p.add_argument("--genomeMetaData", metavar="GENOME")
    p.add_argument("--metaData", action="store_true")
    p.add_argument("--chromSizes", metavar="GENOME")
    p.add_argument("--topSegments", metavar="GENOME")
    p.add_argument("--bottomSegments", metavar="GENOME")
    p.add_argument("--percentID", metavar="GENOME")
    p.add_argument("--coverage", metavar="GENOME")
    p.add_argument("--allCoverage", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)

    aln = open_alignment(o.halFile)
    os = sys.stdout
    if o.genomes:
        print_genomes(os, aln)
    elif o.sequences:
        print_sequences(os, aln, o.sequences)
    elif o.tree:
        os.write(aln.get_newick_tree() + "\n")
    elif o.sequenceStats:
        print_sequence_stats(os, aln, o.sequenceStats)
    elif o.bedSequences:
        print_bed_sequences(os, aln, o.bedSequences)
    elif o.span:
        print_span(os, aln, o.span, False)
    elif o.spanRoot:
        print_span(os, aln, o.spanRoot, True)
    elif o.branches:
        print_branches(os, aln)
    elif o.children:
        os.write(" ".join(aln.get_child_names(o.children)) + "\n")
    elif o.parent:
        if o.parent != aln.root_name:
            os.write((aln.get_parent_name(o.parent) or "") + "\n")
    elif o.root:
        os.write(aln.root_name + "\n")
    elif o.branchLength:
        if o.branchLength != aln.root_name:
            os.write(_fmt_g(aln.get_branch_length(o.branchLength)) + "\n")
    elif o.numSegments:
        print_num_segments(os, aln, o.numSegments)
    elif o.baseComp:
        print_base_comp(os, aln, o.baseComp)
    elif o.genomeMetaData:
        print_metadata(os, aln.open_genome(o.genomeMetaData).metadata)
    elif o.metaData:
        print_metadata(os, aln.metadata)
    elif o.chromSizes:
        print_chrom_sizes(os, aln, o.chromSizes)
    elif o.topSegments:
        print_segments(os, aln, o.topSegments, True)
    elif o.bottomSegments:
        print_segments(os, aln, o.bottomSegments, False)
    elif o.percentID:
        from hal_tpu_torch.tools import halPctId

        halPctId.print_percent_id(os, aln, o.percentID)
    elif o.coverage:
        print_coverage(os, aln, o.coverage)
    elif o.allCoverage:
        from hal_tpu_torch.tools import halCoverage

        halCoverage.print_all_coverage(os, aln)
    else:
        print_default(os, aln)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

"""Port copy of hal_tpu/tools/halCoverage.py (numpy only; the same code,
imports pointing at hal_tpu_torch).  The port's halStats runs it.

halCoverage — sampling-based coverage histograms
(reference stats/impl/halCoverage.cpp).

Vectorized: one batched unit-interval map per leaf genome instead of a
per-sample halMapSegment call."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops import segmap_host as sm
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main


def _depth_histograms(aln, ref_name, positions, leaves):
    """Per-leaf histogram: hist[k] = #samples covered >= k+1 times."""
    hists = {}
    lo = positions
    hi = positions + 1
    for leaf in leaves:
        frags = sm.map_source(aln, ref_name, lo, hi, leaf, do_dupes=True)
        depth = np.zeros(len(positions), np.int64)
        if len(frags):
            # samples are unit intervals, so every fragment of a sample has
            # src interval exactly [p, p+1); samples sharing p share the
            # deduped fragment set — count fragments per position, gather
            upos, counts = np.unique(frags.src_lo, return_counts=True)
            j = np.searchsorted(upos, lo)
            j = np.clip(j, 0, len(upos) - 1)
            hit = upos[j] == lo
            depth[hit] = counts[j[hit]]
        hists[leaf] = depth
    return hists


def print_coverage(os, aln, ref_name, num_samples=1000000, seed=0, by_sequence=False):
    if ref_name not in aln.tree:
        raise HalError("Genome %s not found." % ref_name)
    if seed == 0:
        import time

        seed = int(time.time())
    rng = np.random.default_rng(seed)
    ref = aln.open_genome(ref_name)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    positions = rng.integers(0, ref.length, num_samples).astype(np.int64)
    depths = _depth_histograms(aln, ref_name, positions, leaves)

    max_depth = max((int(d.max()) if len(d) else 0) for d in depths.values()) if depths else 0
    os.write("Genome")
    for i in range(max_depth):
        os.write(", sitesCovered%dTimes" % (i + 1))
    os.write("\n")

    def emit(sel):
        for leaf in sorted(leaves):
            d = depths[leaf][sel]
            os.write(leaf)
            for k in range(1, max_depth + 1):
                os.write(", %d" % int((d >= k).sum()))
            os.write("\n")

    emit(slice(None))
    if by_sequence:
        seq_idx = ref.seq_index_at(positions)
        for si in range(ref.num_sequences):
            os.write("\nCoverage on %s\n" % ref.seq_names[si])
            emit(seq_idx == si)


def print_all_coverage(os, aln, num_samples=100000, seed=1):
    """halStats --allCoverage: every leaf as reference."""
    for ref in sorted(n for n in aln.genome_names() if aln.tree.is_leaf(n)):
        os.write("\nCoverage from %s\n" % ref)
        print_coverage(os, aln, ref, num_samples=num_samples, seed=seed)


def run(argv=None):
    p = make_parser("halCoverage", "Calculate coverage by sampling bases")
    p.add_argument("halFile")
    p.add_argument("refGenome")
    p.add_argument("--numSamples", type=int, default=1000000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bySequence", action="store_true")
    add_storage_options(p)
    o = p.parse_args(argv)
    aln = open_alignment(o.halFile)
    print_coverage(sys.stdout, aln, o.refGenome, o.numSamples, o.seed, o.bySequence)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

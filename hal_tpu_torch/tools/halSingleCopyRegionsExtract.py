"""Port copy of hal_tpu/tools/halSingleCopyRegionsExtract.py (numpy only;
imports pointing at hal_tpu_torch), with one declared divergence:
--device {cuda,cpu} (default cuda).  The reference's self-map up to the
root and its map to each target are one batched dispatch each over every
2^20-base window (tools/_regions.map_by_owner, owner = window) on that
device, where the original calls the host map_source for each window and
genome.  The self-map's paralogy branches bring paralogs down without
rings, as map_source does (map_by_owner's host_paralogies mapper).  A
base's copy count is the number of distinct base pairs that start at it,
which the atomized fragment sets of both mappers give alike, so the BED
bytes are the original's.

halSingleCopyRegionsExtract — BED of single-copy regions
(reference extract/impl/halSingleCopyRegionsExtract.cpp)."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._device import add_device_option, require_device
from hal_tpu_torch.tools._regions import (WINDOW, map_by_owner, window_counts,
                                         windows)


def run(argv=None):
    p = make_parser("halSingleCopyRegionsExtract",
                    "Extract single-copy regions of a genome into BED")
    p.add_argument("halFile")
    p.add_argument("referenceGenome")
    p.add_argument("--targetGenomes", default="",
                   help="genomes to check (default: all leaves)")
    p.add_argument("--refSequence", default="")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--length", type=int, default=0)
    p.add_argument("--requireAllTargets", action="store_true")
    add_device_option(p)
    add_storage_options(p)
    o = p.parse_args(argv)
    require_device(o.device)
    aln = open_alignment(o.halFile)
    ref = o.referenceGenome
    if ref not in aln.tree:
        raise HalError("Genome %s not found" % ref)
    g = aln.open_genome(ref)
    targets = [t for t in o.targetGenomes.split(",") if t] or \
        [n for n in aln.genome_names() if aln.tree.is_leaf(n) and n != ref]

    if o.refSequence:
        si = g.sequence_index(o.refSequence)
        gs = int(g.seq_start[si]) + o.start
        ge = gs + (o.length or (g.seq_length(si) - o.start))
    else:
        gs = o.start
        ge = gs + (o.length or (g.length - gs))

    lo, hi = windows(gs, ge, WINDOW)
    # reference itself must be single-copy
    self_map = map_by_owner(aln, ref, ref, lo, hi, device=o.device,
                            coalescence_limit=aln.root_name)
    mapped = {t: map_by_owner(aln, ref, t, lo, hi, device=o.device)
              for t in dict.fromkeys(targets)}

    for w, (pos, end) in enumerate(zip(lo.tolist(), hi.tolist())):
        n = end - pos
        ok = window_counts(self_map, w, pos, n) == 1
        for t in targets:
            c = window_counts(mapped[t], w, pos, n)
            if o.requireAllTargets:
                ok &= c == 1
            else:
                ok &= c <= 1
        # emit runs
        d = np.diff(np.concatenate([[0], ok.astype(np.int8), [0]]))
        starts = np.flatnonzero(d == 1)
        ends = np.flatnonzero(d == -1)
        for a, b in zip(starts, ends):
            ga, gb = pos + int(a), pos + int(b)
            si = int(np.searchsorted(g.seq_start, ga, side="right")) - 1
            base = int(g.seq_start[si])
            sys.stdout.write("%s\t%d\t%d\n" % (g.seq_names[si], ga - base, gb - base))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

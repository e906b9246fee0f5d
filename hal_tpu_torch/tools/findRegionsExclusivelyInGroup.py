"""Port copy of hal_tpu/tools/findRegionsExclusivelyInGroup.py (numpy only;
imports pointing at hal_tpu_torch), with one declared divergence: --device
{cuda,cpu} (default cuda).  Each ingroup and outgroup genome's mapping of
every 2^20-base window of the reference is one batched dispatch on that
device (tools/_regions.map_by_owner, owner = window), where the original
calls the host map_source for each window and genome.  A window's coverage
reads only the union of the fragments' source intervals, which is the
same set either way, so the BED bytes are the original's.

findRegionsExclusivelyInGroup — BED of reference regions aligned to the
ingroup but (mostly) not the outgroup
(reference modify/findRegionsExclusivelyInGroup.cpp)."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._device import add_device_option, require_device
from hal_tpu_torch.tools._regions import (WINDOW, map_by_owner, window_counts,
                                         windows)


def run(argv=None):
    p = make_parser("findRegionsExclusivelyInGroup",
                    "Output BED of regions aligned only within the ingroup")
    p.add_argument("halFile")
    p.add_argument("referenceGenome")
    p.add_argument("ingroupGenomes", help="comma-separated ingroup genomes")
    p.add_argument("--minIngroupGenomes", type=int, default=None,
                   help="minimum ingroup genomes aligned (default: all)")
    p.add_argument("--maxOutgroupGenomes", type=int, default=0)
    add_device_option(p)
    add_storage_options(p)
    o = p.parse_args(argv)
    require_device(o.device)
    aln = open_alignment(o.halFile)
    ref = o.referenceGenome
    g = aln.open_genome(ref)
    ingroup = [t for t in o.ingroupGenomes.split(",") if t]
    for t in ingroup:
        if t not in aln.tree:
            raise HalError("Genome %s not found" % t)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    outgroup = [n for n in leaves if n not in ingroup and n != ref]
    min_in = o.minIngroupGenomes if o.minIngroupGenomes is not None else len(ingroup)

    lo, hi = windows(0, g.length, WINDOW)
    mapped = {t: map_by_owner(aln, ref, t, lo, hi, device=o.device,
                              atomize=False)
              for t in dict.fromkeys(ingroup + outgroup)}

    for w, (pos, end) in enumerate(zip(lo.tolist(), hi.tolist())):
        n = end - pos

        def coverage(t):
            return window_counts(mapped[t], w, pos, n) > 0

        in_count = np.zeros(n, np.int64)
        for t in ingroup:
            in_count += coverage(t)
        out_count = np.zeros(n, np.int64)
        for t in outgroup:
            out_count += coverage(t)
        ok = (in_count >= min_in) & (out_count <= o.maxOutgroupGenomes)
        d = np.diff(np.concatenate([[0], ok.astype(np.int8), [0]]))
        for a, b in zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)):
            ga, gb = pos + int(a), pos + int(b)
            si = int(np.searchsorted(g.seq_start, ga, side="right")) - 1
            base = int(g.seq_start[si])
            sys.stdout.write("%s\t%d\t%d\n" % (g.seq_names[si], ga - base, gb - base))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

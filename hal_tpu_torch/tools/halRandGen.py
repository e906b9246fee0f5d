"""Port copy of hal_tpu/tools/halRandGen.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

halRandGen — synthetic alignment generator CLI
(reference randgen/halRandGen.cpp: presets small/medium/big/large, --seed,
--testRand portable RNG; here numpy PCG64 is always portable)."""

from __future__ import annotations

import sys

from hal_tpu_torch.randgen import PRESETS, create_random_alignment
from hal_tpu_torch.storage import save_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, save_kwargs, tool_main


def run(argv=None):
    p = make_parser("halRandGen", "Generate a random hal alignment")
    p.add_argument("halFile", help="output alignment path")
    p.add_argument("--preset", choices=list(PRESETS), default=None)
    p.add_argument("--meanDegree", type=float, default=1.25)
    p.add_argument("--maxBranchLength", type=float, default=0.75)
    p.add_argument("--maxGenomes", type=int, default=20)
    p.add_argument("--minSegmentLength", type=int, default=10)
    p.add_argument("--maxSegmentLength", type=int, default=1000)
    p.add_argument("--maxSegments", type=int, default=100)
    p.add_argument("--minSegments", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--testRand", action="store_true",
                   help="accepted for reference CLI compatibility (numpy PCG64 is always portable)")
    add_storage_options(p, write=True)
    o = p.parse_args(argv)

    kw = dict(mean_degree=o.meanDegree, max_branch_length=o.maxBranchLength,
              max_genomes=o.maxGenomes, min_segment_length=o.minSegmentLength,
              max_segment_length=o.maxSegmentLength, min_segments=o.minSegments,
              max_segments=o.maxSegments)
    if o.preset:
        pr = PRESETS[o.preset]
        kw.update(mean_degree=pr["mean_degree"], max_branch_length=pr["max_branch_length"],
                  max_genomes=pr["max_genomes"], min_segment_length=pr["min_segment_length"],
                  max_segment_length=pr["max_segment_length"], max_segments=pr["max_segments"])
    aln = create_random_alignment(seed=o.seed, min_genomes=2, **kw)
    save_alignment(aln, o.halFile, **save_kwargs(o))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

"""Port copy of hal_tpu/tools/blockVizBenchmark.py (numpy only; the same
code, imports pointing at hal_tpu_torch).

blockVizBenchmark — simulate browser snake-track queries and time them
(reference blockViz/tests/blockVizBenchmark.py:9-40, which shells to the
blockVizTime C driver).  Queries hal_tpu_torch.blockviz.get_blocks_in_target_range
directly: random windows of geometrically increasing length against every
other genome, with and without dupes, optionally through a LOD manifest."""

from __future__ import annotations

import random
import sys
import time

from hal_tpu_torch import blockviz as bv
from hal_tpu_torch.tools import make_parser, tool_main


def run(argv=None):
    p = make_parser("blockVizBenchmark",
                    "Time simulated snake-track queries against a hal or lod.txt")
    p.add_argument("halOrLod", help="hal file or lod.txt manifest")
    p.add_argument("refGenome")
    p.add_argument("--refSequence", default="", help="default: first sequence")
    p.add_argument("--minLength", type=int, default=100)
    p.add_argument("--maxLength", type=int, default=100000)
    p.add_argument("--queriesPerLevel", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--doDupes", action="store_true")
    o = p.parse_args(argv)

    handle = bv.hal_open(o.halOrLod)
    chroms = bv.get_chroms(handle, o.refGenome)
    name, size = (chroms[0] if not o.refSequence
                  else next(c for c in chroms if c[0] == o.refSequence))
    targets = [g for g in bv.get_genome_names(handle) if g != o.refGenome]
    rng = random.Random(o.seed)

    out = sys.stdout
    out.write("length, target, queries, mean_ms, blocks\n")
    length = o.minLength
    while length <= o.maxLength:
        ln = min(length, size)
        for tgt in targets:
            t_tot = 0.0
            n_blocks = 0
            for _ in range(o.queriesPerLevel):
                start = rng.randrange(max(size - ln, 1))
                t0 = time.time()
                blocks, _dupes = bv.get_blocks_in_target_range(
                    handle, tgt, o.refGenome, name, start, start + ln,
                    dup_mode=(bv.HAL_QUERY_DUPS if o.doDupes else bv.HAL_NO_DUPS))
                t_tot += time.time() - t0
                n_blocks += len(blocks)
            out.write("%d, %s, %d, %.2f, %d\n"
                      % (ln, tgt, o.queriesPerLevel,
                         1000.0 * t_tot / o.queriesPerLevel, n_blocks))
        length *= 10


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

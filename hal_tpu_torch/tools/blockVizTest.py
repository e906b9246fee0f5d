"""Port copy of hal_tpu/tools/blockVizTest.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

blockVizTest — CLI driver over the blockViz query API, output-compatible
with the reference test binary (blockViz/tests/blockVizTest.cpp:98-108,
186-221): one printBlock line per mapped block on stdout, dupe lists after,
counters on stderr.
"""

from __future__ import annotations

import sys

from hal_tpu_torch import blockviz as bv
from hal_tpu_torch.tools import add_storage_options, make_parser, tool_main


def run(argv=None):
    p = make_parser("blockVizTest", "Test blockViz code from command line")
    p.add_argument("halLodPath")
    p.add_argument("qSpecies")
    p.add_argument("tSpecies")
    p.add_argument("tChrom")
    p.add_argument("tStart", type=int)
    p.add_argument("tEnd", type=int)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--doSeq", action="store_true")
    p.add_argument("--doDupes", action="store_true")
    p.add_argument("--numThreads", type=int, default=10)
    p.add_argument("--coalescenceLimit", default="")
    add_storage_options(p)
    o = p.parse_args(argv)

    handle = bv.hal_open(o.halLodPath)
    seq_mode = bv.HAL_LOD0_SEQUENCE if o.doSeq else bv.HAL_NO_SEQUENCE
    blocks, dupes = bv.get_blocks_in_target_range(
        handle, o.qSpecies, o.tSpecies, o.tChrom, o.tStart, o.tEnd,
        seq_mode=seq_mode, dup_mode=bv.HAL_QUERY_AND_TARGET_DUPS,
        map_back_adjacencies=True,
        coalescence_limit=o.coalescenceLimit or None)

    block_cnt = 0
    base_cnt = 0
    for b in blocks:
        block_cnt += 1
        base_cnt += b.size
        if o.verbose:
            # printBlock (blockVizTest.cpp:98-101): %.10s truncation
            sys.stdout.write(
                "chr:%s, tSt:%d, qSt:%d, size:%d, strand:%c: tgt : %.10s query: %.10s\n"
                % (b.q_chrom, b.t_start, b.q_start, b.size, b.strand,
                   (b.t_sequence or "")[:10], (b.q_sequence or "")[:10]))
    if o.verbose:
        for i, d in enumerate(dupes):
            sys.stdout.write("tDupe id:%d qCrhom:%s\n" % (i, d.q_chrom))
            for (lo, hi) in d.t_ranges:
                sys.stdout.write(" tSt:%d size:%d\n" % (lo, hi - lo))
    sys.stderr.write("blockCnt: %d\n" % block_cnt)
    sys.stderr.write("baseCnt: %d\n" % base_cnt)
    sys.stderr.write("Tests successful!\n")


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

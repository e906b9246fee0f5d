"""Port copy of hal_tpu/tools/halContiguousRegions.py (numpy only; imports
pointing at hal_tpu_torch), with one declared divergence: --device
{cuda,cpu} (default cuda).  Every sequence of the source is mapped in one
batched dispatch on that device (tools/_regions.map_by_owner, owner =
sequence, at a starting capacity sized to the segments the sequences
cover), where the original calls the host map_source for each sequence.
The chaining reads map_source's fragment order, which the dispatch
reproduces (ordered=True), so the BED bytes are the original's.

halContiguousRegions — BED of reference regions whose alignment to a
target genome is contiguous (reference analysis/halContiguousRegions.py,
jobTree-era; re-implemented natively on the mapper)."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._device import add_device_option, require_device
from hal_tpu_torch.tools._regions import map_by_owner, owner_slice


def run(argv=None):
    p = make_parser("halContiguousRegions",
                    "BED of regions that map contiguously to the target genome")
    p.add_argument("hal")
    p.add_argument("srcGenome")
    p.add_argument("destGenome")
    p.add_argument("--maxGap", type=int, default=100,
                   help="maximum gap in the target within a contiguous region")
    p.add_argument("--noDupes", action="store_true")
    add_device_option(p)
    add_storage_options(p)
    o = p.parse_args(argv)
    require_device(o.device)
    aln = open_alignment(o.hal)
    for n in (o.srcGenome, o.destGenome):
        if n not in aln.tree:
            raise HalError("Genome %s not found" % n)
    sg = aln.open_genome(o.srcGenome)
    tg = aln.open_genome(o.destGenome)

    seqs = [si for si in range(sg.num_sequences)
            if int(sg.seq_start[si + 1]) > int(sg.seq_start[si])]
    mapped = map_by_owner(aln, o.srcGenome, o.destGenome,
                          [sg.seq_start[si] for si in seqs],
                          [sg.seq_start[si + 1] for si in seqs],
                          device=o.device, do_dupes=not o.noDupes,
                          ordered=True)

    for k, si in enumerate(seqs):
        lo = int(sg.seq_start[si])
        frags = owner_slice(*mapped, k)
        if len(frags) == 0:
            continue
        order = np.argsort(frags.src_lo, kind="stable")
        f = frags.select(order)
        # contiguous: source adjacent-ish and target gap <= maxGap with
        # consistent orientation and sequence
        t_seq = tg.seq_index_at(f.tgt_lo)
        same = (f.rev[1:] == f.rev[:-1]) & (t_seq[1:] == t_seq[:-1])
        src_ok = f.src_lo[1:] <= f.src_hi[:-1] + o.maxGap
        gap_f = np.abs(f.tgt_lo[1:] - f.tgt_hi[:-1])
        gap_r = np.abs(f.tgt_lo[:-1] - f.tgt_hi[1:])
        tgt_ok = np.where(f.rev[:-1].astype(bool), gap_r, gap_f) <= o.maxGap
        chain = same & src_ok & tgt_ok
        starts = np.concatenate([[True], ~chain])
        first = np.flatnonzero(starts)
        last = np.append(first[1:] - 1, len(f) - 1)
        for a, b in zip(first, last):
            sys.stdout.write("%s\t%d\t%d\n" % (
                sg.seq_names[si], int(f.src_lo[a]) - lo, int(f.src_hi[b]) - lo))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

"""halWiggleLiftover on the torch port — the arguments of
hal_tpu.tools.halWiggleLiftover plus --device.  The runs of consecutive
positions of each wiggle block are mapped by the torch segment mapper
(segmap_torch.map_batch) on --device, --batchSize runs per call (0: all of
a block's runs in one call), as the original's device path does, and
brought into the canonical form the host mapper ends with (atomize of the
deduplicated fragments), so the bytes equal the original's.  A missing or
failing device raises: nothing falls back to the host.

    python -m hal_tpu_torch.tools.halWiggleLiftover --device cuda \\
        --batchSize 16384 aln.hal srcGenome in.wig tgtGenome out.wig
"""

from __future__ import annotations

import sys
from collections import defaultdict

import numpy as np
import torch

from hal_tpu_torch.io.wiggle import read_wiggle, write_wiggle_runs
from hal_tpu_torch.ops import segmap_host as sm
from hal_tpu_torch.ops import segmap_torch as st
from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import (HalError, add_storage_options, make_parser,
                                 tool_main)


def run(argv=None):
    p = make_parser("halWiggleLiftover", "Map wiggle genome interval coordinates between two genomes")
    p.add_argument("halFile")
    p.add_argument("srcGenome")
    p.add_argument("srcWig", help="input .wig (or stdin)")
    p.add_argument("tgtGenome")
    p.add_argument("tgtWig", help="output .wig (or stdout)")
    p.add_argument("--noDupes", action="store_true")
    p.add_argument("--append", action="store_true")
    p.add_argument("--unique", action="store_true")
    p.add_argument("--batchSize", type=int, default=16384,
                   help="wiggle runs per call of the segment mapper on "
                        "--device (0: a whole block per call); output is "
                        "identical for every size")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device of the batched mapper (cpu runs the "
                        "kernels' plain versions)")
    add_storage_options(p)
    o = p.parse_args(argv)

    if o.device == "cuda" and not torch.cuda.is_available():
        raise HalError("--device cuda: no CUDA device is available "
                       "(--device cpu runs the port on the CPU)")
    aln = open_alignment(o.halFile)
    if o.srcGenome not in aln.tree or o.tgtGenome not in aln.tree:
        raise HalError("source or target genome not found")
    sg = aln.open_genome(o.srcGenome)
    tg = aln.open_genome(o.tgtGenome)

    if o.batchSize < 0:
        raise HalError("--batchSize must be >= 0")
    path = st.PathData.build(aln, o.srcGenome, o.tgtGenome,
                             do_dupes=not o.noDupes, device=o.device)

    def map_intervals(lo, hi):
        """Map [lo, hi) on the device, --batchSize runs a call, into the
        host mapper's fragment form."""
        step = o.batchSize or max(len(lo), 1)
        parts = [st.map_batch(path, lo[i:i + step], hi[i:i + step])
                 for i in range(0, len(lo), step)]
        s_lo, s_hi, t_lo, t_hi, rev = (
            np.concatenate([p[k] for p in parts]) for k in range(5))
        return sm.atomize(sm.Fragments(
            s_lo.astype(np.int64), s_hi.astype(np.int64),
            t_lo.astype(np.int64), t_hi.astype(np.int64),
            rev.astype(np.uint8)).dedup())

    in_stream = sys.stdin if o.srcWig in ("stdin", "-") else open(o.srcWig)
    out = sys.stdout if o.tgtWig in ("stdout", "-") else open(
        o.tgtWig, "a" if o.append else "w")

    # per-target-sequence accumulated (pos, val) pairs
    acc_pos = defaultdict(list)
    acc_val = defaultdict(list)

    for seq_name, positions, values in read_wiggle(in_stream):
        try:
            si = sg.sequence_index(seq_name)
        except KeyError:
            sys.stderr.write("Unable to find sequence %s in genome %s\n"
                             % (seq_name, o.srcGenome))
            continue
        base = int(sg.seq_start[si])
        gpos = positions + base
        # map runs of consecutive positions as intervals
        brk = np.concatenate([[True], gpos[1:] != gpos[:-1] + 1])
        starts = np.flatnonzero(brk)
        ends = np.append(starts[1:], len(gpos))
        lo = gpos[starts]
        hi = gpos[ends - 1] + 1
        frags = map_intervals(lo, hi)
        # value lookup per source position
        order = np.argsort(gpos, kind="stable")
        sp = gpos[order]
        sv = values[order]
        for i in range(len(frags)):
            sl, sh = int(frags.src_lo[i]), int(frags.src_hi[i])
            n = sh - sl
            j0 = int(np.searchsorted(sp, sl))
            vals = sv[j0:j0 + n]
            if bool(frags.rev[i]):
                tpos = np.arange(int(frags.tgt_hi[i]) - 1, int(frags.tgt_lo[i]) - 1, -1)
            else:
                tpos = np.arange(int(frags.tgt_lo[i]), int(frags.tgt_hi[i]))
            tsi = int(np.searchsorted(tg.seq_start, tpos[0], side="right")) - 1
            tbase = int(tg.seq_start[tsi])
            acc_pos[tsi].append(tpos - tbase)
            acc_val[tsi].append(vals)

    for tsi in sorted(acc_pos):
        write_wiggle_runs(out, tg.seq_names[tsi],
                          np.concatenate(acc_pos[tsi]),
                          np.concatenate(acc_val[tsi]))
    if out is not sys.stdout:
        out.close()


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

"""Port copy of hal_tpu/tools/halSnps.py (numpy only; imports pointing at
hal_tpu_torch), with one declared divergence: --device {cuda,cpu}
(default cuda).  Each target's mapping of every 2^20-base window is one
batched dispatch on that device (tools/_regions.map_by_owner, owner =
window), where the original calls the host map_source for each window and
target.  The per-base first copy (the --tsv rows) reads map_source's
fragment order, which the dispatch reproduces (ordered=True); the counts,
the TSV and stdout are the original's.

halSnps — SNP counting between a reference and target genomes
(reference mutations/impl/halSnps.cpp).

Vectorized: per-target window mapping + bulk base comparison instead of the
per-column DnaIterator walk (halSnps.cpp:284-420).

Deviation note: with duplications enabled the reference resolves ortholog
sets from per-column gene trees (getOrthologs).  Here every aligned copy is
compared (a superset of ortholog pairs); the noDupes mode is exact.
"""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._device import add_device_option, require_device
from hal_tpu_torch.tools._regions import WINDOW, map_by_owner, owner_slice, windows


def _upper(b):
    return np.where((b >= 97) & (b <= 122), b - 32, b)


def run(argv=None):
    p = make_parser("halSnps", "Count snps between genomes in alignment")
    p.add_argument("halFile")
    p.add_argument("refGenome")
    p.add_argument("targetGenomes", help="comma-separated query genomes")
    p.add_argument("--tsv", default="", help="write per-site snps in reference coordinates")
    p.add_argument("--noDupes", action="store_true")
    p.add_argument("--refSequence", default="")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--length", type=int, default=0)
    p.add_argument("--minSpeciesForSnp", type=int, default=1)
    p.add_argument("--unique", action="store_true")
    add_device_option(p)
    add_storage_options(p)
    o = p.parse_args(argv)
    require_device(o.device)

    aln = open_alignment(o.halFile)
    ref = o.refGenome
    if ref not in aln.tree:
        raise HalError("Reference genome %s not found" % ref)
    targets = [t for t in o.targetGenomes.split(",") if t]
    for t in targets:
        if t not in aln.tree:
            raise HalError("Target genome %s not found" % t)
    g = aln.open_genome(ref)

    if o.refSequence:
        si = g.sequence_index(o.refSequence)
        base = int(g.seq_start[si])
        gs = base + o.start
        ge = gs + (o.length or (g.seq_length(si) - o.start))
    else:
        gs = o.start
        ge = gs + (o.length or (g.length - gs))

    tsv = open(o.tsv, "w") if o.tsv else None
    if tsv:
        tsv.write("refSequence\trefPosition\t" + ref + "\t" + "\t".join(targets) + "\n")

    num_snps = {t: 0 for t in targets}
    num_pairs = {t: 0 for t in targets}

    lo, hi = windows(gs, ge, WINDOW)
    mapped = {t: map_by_owner(aln, ref, t, lo, hi, device=o.device,
                              do_dupes=not o.noDupes, ordered=True)
              for t in dict.fromkeys(targets)}

    for w, (pos, end) in enumerate(zip(lo.tolist(), hi.tolist())):
        n = end - pos
        ref_bases = _upper(g.get_dna(pos, n))
        # per-target per-position base (0 = unaligned); first copy wins
        tbase = {}
        tdiff = np.zeros(n, np.int64)
        for t in targets:
            tg = aln.open_genome(t)
            frags = owner_slice(*mapped[t], w)
            arr = np.zeros(n, np.uint8)
            snp_extra = 0
            pair_extra = 0
            for i in range(len(frags)):
                sl, sh = int(frags.src_lo[i]), int(frags.src_hi[i])
                bases = _upper(tg.get_dna(int(frags.tgt_lo[i]),
                                          int(frags.tgt_hi[i]) - int(frags.tgt_lo[i]),
                                          reversed_=bool(frags.rev[i])))
                seg = slice(sl - pos, sh - pos)
                first = arr[seg] == 0
                # count every aligned copy as a pair (see deviation note)
                valid = np.isin(bases, np.frombuffer(b"ACGT", np.uint8)) & \
                        np.isin(ref_bases[seg], np.frombuffer(b"ACGT", np.uint8))
                pair_extra += int(valid.sum())
                snp_extra += int((valid & (bases != ref_bases[seg])).sum())
                arr[seg] = np.where(first, bases, arr[seg])
            num_pairs[t] += pair_extra
            num_snps[t] += snp_extra
            tbase[t] = arr
            tdiff += ((arr != 0) & (arr != ref_bases) &
                      np.isin(arr, np.frombuffer(b"ACGT", np.uint8)) &
                      np.isin(ref_bases, np.frombuffer(b"ACGT", np.uint8))).astype(np.int64)
        if tsv:
            hits = np.flatnonzero(tdiff >= o.minSpeciesForSnp)
            for h in hits:
                gpos = pos + int(h)
                si = int(np.searchsorted(g.seq_start, gpos, side="right")) - 1
                row = [g.seq_names[si], str(gpos - int(g.seq_start[si])),
                       chr(ref_bases[h])]
                for t in targets:
                    b = tbase[t][h]
                    row.append(chr(b) if b else "")
                tsv.write("\t".join(row) + "\n")

    for t in sorted(targets):
        sys.stdout.write("%s %d %d\n" % (t, num_snps[t], num_pairs[t]))
    if tsv:
        tsv.close()


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

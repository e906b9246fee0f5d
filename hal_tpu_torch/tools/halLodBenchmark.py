"""Port copy of hal_tpu/tools/halLodBenchmark.py (numpy only; the same
code, imports pointing at hal_tpu_torch), whose commands run the port's
halLodExtract and hal2maf, with two declared divergences:

  * --device {cuda,cpu} (default cuda) is passed on to the --doMaf hal2maf
    runs, whose column engine runs on that torch device;
  * --format {hdf5,halz} (default hdf5, the original's lod<step>.hal) may
    write each level as lod<step>.halz instead, which needs no h5py.  The
    fileSize column is os.path.getsize of the level as in the original,
    which for a halz directory is the size of the directory entry.

halLodBenchmark — sweep LOD extraction step sizes and report size /
segment-count reduction and extraction time (reference
lod/halLodBenchmark.py; the reference's optional mafComparator accuracy
step needed external mafTools — here the accuracy proxy is column counts
from hal2maf when --doMaf is given)."""

from __future__ import annotations

import os
import subprocess
import sys
import time

from hal_tpu_torch.parallel.mp import get_hal_genomes, get_hal_num_segments
from hal_tpu_torch.tools import make_parser, tool_main


def total_segments(hal: str) -> tuple:
    tot_top = tot_bot = 0
    for g in get_hal_genomes(hal):
        t, b = get_hal_num_segments(hal, g)
        tot_top += t
        tot_bot += b
    return tot_top, tot_bot


def aligned_bases(hal: str) -> tuple:
    """(total, canonical) child bases aligned to a parent, summed over all
    branches.  total - canonical = the paralogous share; extract_lod
    retains it through coarse paralogy rings (like the reference
    LodExtract's column-sampled graph, lod/impl/halLodExtract.cpp) unless
    --onlyOrthologs — coverage here quantifies what each mode keeps."""
    import numpy as np

    from hal_tpu_torch.constants import NULL_INDEX
    from hal_tpu_torch.storage import open_alignment

    aln = open_alignment(hal)
    total = canon = 0
    for name in aln.genome_names():
        parent = aln.tree.parent(name)
        if parent is None:
            continue
        g = aln.open_genome(name)
        if g.num_top_segments == 0:
            continue
        pg = aln.open_genome(parent)
        slot = aln.tree.child_index(parent, name)
        lens = np.diff(g.top_start)
        idx = np.flatnonzero(g.top_parent != NULL_INDEX)
        total += int(lens[idx].sum())
        canonical = pg.bot_child[g.top_parent[idx], slot] == idx
        canon += int(lens[idx[canonical]].sum())
    return total, canon


def blockviz_fidelity(base_hal: str, lod_hal: str, step: int,
                      n_queries: int = 16, seed: int = 0):
    """Simulated browser queries at the lengths this level serves (the
    reference's own quality check, blockViz/tests/blockVizBenchmark.py):
    query windows of ~4*step bases, get_blocks_in_target_range against
    LOD0 and the level, fidelity = covered target bases recovered.

    Returns (mean fidelity, mean LOD0 blocks/query, mean level blocks/query).
    """
    import numpy as np

    from hal_tpu_torch import blockviz as bv

    h0 = bv.hal_open(base_hal)
    hl = bv.hal_open(lod_hal)
    aln = h0.alignment()
    leaves = [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)
              and aln.open_genome(n).length > 0]
    if len(leaves) < 2:
        return float("nan"), 0.0, 0.0
    t_species, q_species = leaves[0], leaves[-1]
    tg = aln.open_genome(t_species)
    chrom = tg.seq_names[0]
    clen = int(tg.seq_start[1] - tg.seq_start[0])
    rng = np.random.default_rng(seed)
    qlen = min(max(4 * step, 64), clen)
    fid = []
    n0 = nl = 0

    def covered(handle):
        blocks, _ = bv.get_blocks_in_target_range(
            handle, q_species, t_species, chrom, start, start + qlen)
        iv = sorted((b.t_start, b.t_start + b.size) for b in blocks)
        tot = 0
        hi = -1
        for a, b in iv:
            a = max(a, hi)
            if b > a:
                tot += b - a
                hi = b
            hi = max(hi, b)
        return tot, len(blocks)

    for _ in range(n_queries):
        start = int(rng.integers(0, max(clen - qlen, 1)))
        c0, k0 = covered(h0)
        cl, kl = covered(hl)
        n0 += k0
        nl += kl
        if c0 > 0:
            fid.append(min(cl / c0, 1.0))
    mean_fid = sum(fid) / len(fid) if fid else float("nan")
    return mean_fid, n0 / n_queries, nl / n_queries


def run(argv=None):
    p = make_parser("halLodBenchmark",
                    "Benchmark halLodExtract across step sizes")
    p.add_argument("hal")
    p.add_argument("outDir")
    p.add_argument("--steps", default="2,4,8,16",
                   help="comma list of scale steps")
    p.add_argument("--doMaf", action="store_true",
                   help="also export MAF per level and count columns")
    p.add_argument("--doBlockViz", action="store_true",
                   help="browser-query fidelity vs LOD0 per level "
                        "(reference blockVizBenchmark.py)")
    p.add_argument("--keepSequences", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="--device of the --doMaf hal2maf runs")
    p.add_argument("--format", choices=["hdf5", "halz"], default="hdf5",
                   help="storage format of the LOD levels (halz needs no "
                        "h5py)")
    o = p.parse_args(argv)
    if o.doMaf:
        o.keepSequences = True  # MAF export needs DNA in the LOD file

    os.makedirs(o.outDir, exist_ok=True)
    base_top, base_bot = total_segments(o.hal)
    base_size = os.path.getsize(o.hal)
    base_total, base_canon = aligned_bases(o.hal)
    out = sys.stdout
    out.write("# baseline alignedBases=%d canonical=%d paralogShare=%.4f\n"
              % (base_total, base_canon,
                 1.0 - base_canon / max(base_total, 1)))
    out.write("step, time(s), fileSize, sizeRatio, topSegs, botSegs, "
              "segRatio, alignedBases, coverage")
    if o.doMaf:
        out.write(", mafLines")
    if o.doBlockViz:
        out.write(", queryFidelity, blocks0/q, blocksL/q")
    out.write("\n")
    for step in [int(s) for s in o.steps.split(",") if s]:
        lod = os.path.join(o.outDir, "lod%d.%s"
                           % (step, "hal" if o.format == "hdf5" else "halz"))
        t0 = time.time()
        cmd = [sys.executable, "-m", "hal_tpu_torch.tools.halLodExtract",
               o.hal, lod, str(step)]
        if o.keepSequences:
            cmd.append("--keepSequences")
        subprocess.run(cmd, check=True)
        dt = time.time() - t0
        top, bot = total_segments(lod)
        size = os.path.getsize(lod)
        lod_total, _ = aligned_bases(lod)
        row = "%d, %.2f, %d, %.3f, %d, %d, %.3f, %d, %.4f" % (
            step, dt, size, size / max(base_size, 1), top, bot,
            (top + bot) / max(base_top + base_bot, 1),
            lod_total, lod_total / max(base_total, 1))
        if o.doMaf:
            maf = os.path.join(o.outDir, "lod%d.maf" % step)
            with open(maf, "w") as f:
                subprocess.run([sys.executable, "-m", "hal_tpu_torch.tools.hal2maf",
                                lod, "/dev/stdout", "--device", o.device],
                               stdout=f, check=True)
            with open(maf) as f:
                row += ", %d" % sum(1 for _ in f)
        if o.doBlockViz:
            fid, b0, bl = blockviz_fidelity(o.hal, lod, step)
            row += ", %.4f, %.1f, %.1f" % (fid, b0, bl)
        out.write(row + "\n")


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

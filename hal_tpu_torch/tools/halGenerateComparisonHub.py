"""Port copy of hal_tpu/tools/halGenerateComparisonHub.py (numpy only; the
same code, imports pointing at hal_tpu_torch).

halGenerateComparisonHub — assembly hub comparing several HALs of the
same genome set (reference assemblyHub/halGenerateComparisonHub.py).

Produces a hub directory with: hub.txt named after the labels, genomes.txt
with defaultPos at the middle 10 kb of each genome's longest sequence,
per-genome sequence data (FASTA; 2bit when kent faToTwoBit exists), links
to every input HAL, and composite snake trackDbs — one snake subtrack per
(target genome, input hal) pair grouped by view/organism dimensions, so
differing alignments of the same assemblies can be compared side by side.
Runs sequentially (the reference's Toil fan-out maps to one loop here)."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from hal_tpu_torch.parallel.mp import get_hal_genomes
from hal_tpu_torch.tools import HalError, make_parser, tool_main


def _chrom_sizes(aln, genome):
    g = aln.open_genome(genome)
    return {g.seq_names[i]: int(g.seq_start[i + 1] - g.seq_start[i])
            for i in range(g.num_sequences)}


def _write_genomes_file(path, aln, genomes, have_2bit):
    with open(path, "w") as fh:
        for genome in genomes:
            sizes = _chrom_sizes(aln, genome)
            if not sizes:
                continue
            max_chrom = max(sizes, key=sizes.get)
            mid = sizes[max_chrom] // 2
            lo = max(mid - 5000, 0)
            hi = min(mid + 5000, sizes[max_chrom])
            seq_path = ("%s/%s.2bit" % (genome, genome) if have_2bit
                        else "%s/%s.fa" % (genome, genome))
            fh.write("\ngenome %s\ntwoBitPath %s\ntrackDb %s/trackDb.txt\n"
                     "organism %s\nscientificName %s\ndescription %s\n"
                     "defaultPos %s:%d-%d\n"
                     % (genome, seq_path, genome, genome, genome, genome,
                        max_chrom, lo, hi))


def _write_trackdb(hub_dir, genome, genomes, hal_paths, labels):
    with open(os.path.join(hub_dir, genome, "trackDb.txt"), "w") as f:
        f.write("track alignments\nshortLabel Alignments\nlongLabel Alignments\n"
                "view Alignments\nvisibility full\ncompositeTrack on\n"
                "type bigBed 3\nsubGroup1 view Track_Type Snake=Alignments\n"
                "subGroup2 orgs Organisms %s\n"
                "dimensions dimensionX=view dimensionY=orgs\n\n"
                % " ".join("%s=%s" % (g, g) for g in genomes))
        for i, target in enumerate(genomes):
            for label, path in zip(labels, hal_paths):
                f.write("\ttrack snake%s_%s\n\tlongLabel %s_%s\n"
                        "\tshortLabel %s_%s\n\totherSpecies %s\n"
                        "\tvisibility full\n\tparent alignments\n"
                        "\tpriority %d\n\tsubGroups view=Snake orgs=%s\n"
                        "\tbigDataUrl %s\n\ttype halSnake\n\n"
                        % (target, label, target, label, target, label,
                           target, i, target, path))


def run(argv=None):
    p = make_parser("halGenerateComparisonHub",
                    "Assembly hub comparing multiple hal files of the same genomes")
    p.add_argument("hubDir")
    p.add_argument("hals", nargs="+")
    p.add_argument("--labels", default="",
                   help="comma list of labels (default: hal basenames)")
    o = p.parse_args(argv)

    hals = [os.path.abspath(h) for h in o.hals]
    labels = (o.labels.split(",") if o.labels
              else [os.path.splitext(os.path.basename(h))[0] for h in hals])
    if len(labels) != len(hals):
        raise HalError("need one label per hal")

    os.makedirs(o.hubDir, exist_ok=True)
    genomes = get_hal_genomes(hals[0])

    from hal_tpu_torch.storage import open_alignment

    aln = open_alignment(hals[0])

    with open(os.path.join(o.hubDir, "hub.txt"), "w") as fh:
        name = "_vs_".join(labels)
        fh.write("\nhub %s\nshortLabel %s\nlongLabel %s\n"
                 "genomesFile genomes.txt\nemail NoEmail\n" % (name, name, name))

    # sequence data per genome
    have_2bit = bool(shutil.which("faToTwoBit"))
    for g in genomes:
        gdir = os.path.join(o.hubDir, g)
        os.makedirs(gdir, exist_ok=True)
        fa = os.path.join(gdir, g + ".fa")
        with open(fa, "w") as fh:
            subprocess.run([sys.executable, "-m", "hal_tpu_torch.tools.hal2fasta",
                            hals[0], g], stdout=fh, check=True)
        with open(os.path.join(gdir, "chrom.sizes"), "w") as fh:
            for name, size in _chrom_sizes(aln, g).items():
                fh.write("%s\t%d\n" % (name, size))
        if have_2bit:
            subprocess.run(["faToTwoBit", fa, os.path.join(gdir, g + ".2bit")],
                           check=True)

    _write_genomes_file(os.path.join(o.hubDir, "genomes.txt"), aln, genomes,
                        have_2bit)

    # link hals + trackDbs
    rel_paths = []
    for i, h in enumerate(hals):
        link = os.path.join(o.hubDir, "input_%d.hal" % i)
        if os.path.lexists(link):
            os.unlink(link)
        os.symlink(h, link)
        rel_paths.append("../input_%d.hal" % i)
    for g in genomes:
        _write_trackdb(o.hubDir, g, genomes, rel_paths, labels)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

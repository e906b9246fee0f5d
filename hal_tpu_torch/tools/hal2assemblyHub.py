"""Port copy of hal_tpu/tools/hal2assemblyHub.py (numpy only; the same
code, imports pointing at hal_tpu_torch), whose jobs run the port's
tools, with two declared divergences:

  * --device {cuda,cpu} (default cuda) is passed on to the halAlignmentDepth
    (--alignability) and halPhyloP (--conservation) jobs, which run their
    engines on that torch device; every other job and every byte the hub
    writes stay as the original's;
  * the halPhyloP job names its wigFile, "stdout": the original omits that
    required argument, so its --conservation job exits with a usage error
    and the hub fails.

    python -m hal_tpu_torch.tools.hal2assemblyHub --device cuda aln.halz hub \\
        --lod --gcContent --rmsk --alignability --conservation neutral.mod

hal2assemblyHub — build a UCSC comparative assembly hub
(reference assemblyHub/hal2assemblyHub.py:12-36, a 3k-LoC Toil pipeline
with per-track job modules assemblyHub/*Track.py).

hal_tpu's version replaces Toil with an explicit two-stage job DAG over
parallel/mp.run_parallel_shell_commands:

  stage A (parallel):  LOD series generation, per-genome chrom.sizes,
                       FASTA export, alignability (halAlignmentDepth) and
                       conservation (halPhyloP) signal wigs — every job an
                       independent CLI invocation, fanned out --numProc
                       wide exactly like the reference's jobTree children;
  stage B (serial):    in-process tracks (GC, rmsk), kent-binary
                       conversions, trackDb/genomes/groups/hub assembly —
                       cheap collation over stage A's artifacts.

Hub layout matches the reference's: the .hal copied into the hub, the LOD
series under lod/ with a RELATIVE-path lod.txt manifest (the browser
contract, blockViz/inc/halBlockViz.h:108-125; reference
prepareLodFiles.fixLodFilePath), snake tracks pointing at ../lod.txt,
groups.txt (prepareHubFiles.writeGroupFile), per-genome description.html
(writeDescriptionFile) and a documentation/ page, genomes.txt in
phylogenetic order (treeCommon inorder).  BigWig/bigBed conversion is
attempted only when the kent binaries exist — the reference's posture."""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess
import sys

from hal_tpu_torch import assemblyhub as ah
from hal_tpu_torch.parallel.mp import (get_hal_sequences,
                                 run_parallel_shell_commands)
from hal_tpu_torch.tools import make_parser, tool_main


def _py(mod: str, *args: str) -> str:
    return " ".join([shlex.quote(sys.executable), "-m", mod]
                    + [shlex.quote(a) for a in args])


def _tree_ordered_leaves(aln, restrict=None):
    """Leaves in phylogenetic traversal order (reference treeCommon
    inorder: neighbouring genomes end up adjacent in genomes.txt)."""
    order = [n for n in aln.tree.postorder(aln.root_name)
             if aln.tree.is_leaf(n)]
    if restrict:
        keep = set(restrict)
        order = [n for n in order if n in keep]
    return order


def _fix_lod_paths(lodtxt: str, outdir: str, hal_base: str) -> None:
    """Rewrite lod.txt to hub-relative paths (reference
    prepareLodFiles.fixLodFilePath): '0 <hal>' then 'N lod/...'."""
    out = []
    for line in open(lodtxt):
        parts = line.split()
        if len(parts) != 2:
            continue
        step, path = parts
        if step == "0":
            out.append("0 %s" % hal_base)
        else:
            out.append("%s lod/%s" % (step, os.path.basename(path)))
    with open(lodtxt, "w") as f:
        f.write("\n".join(out) + "\n")


def _sig_tracks(o, aln, g, gdir, chromsizes, trackdb, n_genomes):
    """Collate stage-A signal artifacts + in-process tracks into trackDb
    (reference gcPercentTrack/alignabilityTrack/conservationTrack/
    rmskTrack.py)."""
    genome = aln.open_genome(g)
    if o.gcContent:
        wig = os.path.join(gdir, g + ".gc.wig")
        with open(wig, "w") as f:
            ah.gc_percent_wig(genome, f)
        big = ah.try_wig_to_bigwig(wig, chromsizes, os.path.join(gdir, g + ".gc.bw"))
        ah.trackdb_gc(trackdb, g, big)
    if o.alignability:
        wig = os.path.join(gdir, g + ".alignability.wig")
        big = ah.try_wig_to_bigwig(wig, chromsizes,
                                   os.path.join(gdir, g + ".alignability.bw"))
        ah.trackdb_alignability(trackdb, g, n_genomes, big)
    if o.conservation:
        wig = os.path.join(gdir, g + ".conservation.wig")
        big = ah.try_wig_to_bigwig(wig, chromsizes,
                                   os.path.join(gdir, g + ".conservation.bw"))
        ah.trackdb_conservation(trackdb, g, big)
    if o.rmsk:
        bed = os.path.join(gdir, g + ".rmsk.bed")
        with open(bed, "w") as f:
            ah.masked_bed(genome, f)
        big = ah.try_bed_to_bigbed(bed, chromsizes, os.path.join(gdir, g + ".rmsk.bb"))
        ah.trackdb_rmsk(trackdb, g, big)


def _dir_tracks(o, g, gdir, chromsizes, trackdb):
    """--bedDirs/--wigDirs: each directory holds per-genome subdirs of
    annotation files (reference bedTrack.py/wigTrack.py layout)."""
    for spec, is_bed in ((o.bedDirs, True), (o.wigDirs, False)):
        for d in (spec.split(",") if spec else []):
            src = os.path.join(d, g)
            if not os.path.isdir(src):
                continue
            track = os.path.basename(os.path.normpath(d))
            for fn in sorted(os.listdir(src)):
                dst = os.path.join(gdir, fn)
                shutil.copyfile(os.path.join(src, fn), dst)
                if is_bed:
                    big = ah.try_bed_to_bigbed(dst, chromsizes, dst + ".bb")
                    ah.trackdb_bed(trackdb, "%s_%s" % (track, os.path.splitext(fn)[0]),
                                   fn + ".bb" if big else fn, big)
                else:
                    big = ah.try_wig_to_bigwig(dst, chromsizes, dst + ".bw")
                    ah.trackdb_wig(trackdb, "%s_%s" % (track, os.path.splitext(fn)[0]),
                                   fn + ".bw" if big else fn, big)


def run(argv=None):
    p = make_parser("hal2assemblyHub", "Build a comparative assembly hub from a hal file")
    p.add_argument("halFile")
    p.add_argument("outDir")
    p.add_argument("--hub", default="halHub")
    p.add_argument("--shortLabel", default="hal Assembly Hub")
    p.add_argument("--longLabel", default="hal Assembly Hub")
    p.add_argument("--email", default="noreply@example.org")
    p.add_argument("--lod", action="store_true", help="generate LOD series")
    p.add_argument("--maxBlock", type=int, default=223)
    p.add_argument("--numProc", type=int, default=4,
                   help="stage-A job-DAG width (reference --maxThreads)")
    p.add_argument("--genomes", default="", help="restrict to these genomes")
    p.add_argument("--noSnakes", action="store_true")
    p.add_argument("--gcContent", action="store_true",
                   help="GC-percent signal track (native; ref gcPercentTrack.py)")
    p.add_argument("--alignability", action="store_true",
                   help="alignment-depth signal track (ref alignabilityTrack.py)")
    p.add_argument("--conservation", default="",
                   help="phyloP model file -> conservation track (ref conservationTrack.py)")
    p.add_argument("--rmsk", action="store_true",
                   help="soft-mask BED track (ref rmskTrack.py)")
    p.add_argument("--bedDirs", default="",
                   help="comma list of dirs with per-genome BED subdirs (ref bedTrack.py)")
    p.add_argument("--wigDirs", default="",
                   help="comma list of dirs with per-genome wig subdirs (ref wigTrack.py)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="--device of the halAlignmentDepth and halPhyloP jobs")
    o = p.parse_args(argv)

    os.makedirs(o.outDir, exist_ok=True)

    from hal_tpu_torch.storage import open_alignment

    aln = open_alignment(o.halFile)
    genomes = (o.genomes.split(",") if o.genomes
               else list(aln.genome_names()))
    leaves = _tree_ordered_leaves(aln, restrict=genomes if o.genomes else None)

    # the hub carries its own copy of the alignment (reference getHalFiles)
    hal_base = os.path.basename(o.halFile.rstrip("/"))
    hal_local = os.path.join(o.outDir, hal_base)
    if os.path.abspath(o.halFile) != os.path.abspath(hal_local):
        if os.path.isdir(o.halFile):  # halz directory format
            if not os.path.isdir(hal_local):
                shutil.copytree(o.halFile, hal_local)
        else:
            shutil.copyfile(o.halFile, hal_local)

    # ------------------------------------------------- stage A: job DAG
    jobs = []
    if o.lod:
        jobs.append(_py("hal_tpu_torch.tools.halLodInterpolate", o.halFile,
                        os.path.join(o.outDir, "lod.txt"),
                        "--outHalDir", os.path.join(o.outDir, "lod"),
                        "--maxBlock", str(o.maxBlock)))
    for g in leaves:
        gdir = os.path.join(o.outDir, g)
        os.makedirs(gdir, exist_ok=True)
        jobs.append("%s > %s" % (
            _py("hal_tpu_torch.tools.halStats", o.halFile, "--chromSizes", g),
            shlex.quote(os.path.join(gdir, "chrom.sizes"))))
        jobs.append("%s > %s" % (
            _py("hal_tpu_torch.tools.hal2fasta", o.halFile, g),
            shlex.quote(os.path.join(gdir, g + ".fa"))))
        if o.alignability:
            jobs.append("%s > %s" % (
                _py("hal_tpu_torch.tools.halAlignmentDepth", o.halFile, g,
                    "--device", o.device),
                shlex.quote(os.path.join(gdir, g + ".alignability.wig"))))
        if o.conservation:
            jobs.append("%s > %s" % (
                _py("hal_tpu_torch.tools.halPhyloP", o.halFile, g,
                    o.conservation, "stdout", "--device", o.device),
                shlex.quote(os.path.join(gdir, g + ".conservation.wig"))))
    run_parallel_shell_commands(jobs, num_proc=max(o.numProc, 1))

    snake_data = "lod.txt" if o.lod else hal_base
    if o.lod:
        _fix_lod_paths(os.path.join(o.outDir, "lod.txt"), o.outDir, hal_base)

    # ------------------------------------------- stage B: hub assembly
    with open(os.path.join(o.outDir, "hub.txt"), "w") as fh:
        fh.write("hub %s\nshortLabel %s\nlongLabel %s\ngenomesFile genomes.txt\n"
                 "email %s\n" % (o.hub, o.shortLabel, o.longLabel, o.email))
    # groups.txt (reference prepareHubFiles.writeGroupFile)
    with open(os.path.join(o.outDir, "groups.txt"), "w") as fh:
        for name, label, prio, default in (
                ("user", "Custom", 1, "on"), ("map", "Mapping", 2, "on"),
                ("snake", "Alignment Snakes", 3, "on"),
                ("genes", "Genes", 4, "on"), ("compGeno", "Signals", 5, "on")):
            fh.write("name %s\nlabel %s\npriority %d\ndefaultIsClosed 0\n\n"
                     % (name, label, prio))
    docdir = os.path.join(o.outDir, "documentation")
    os.makedirs(docdir, exist_ok=True)
    with open(os.path.join(docdir, "hub.html"), "w") as fh:
        fh.write("<html><body><h1>%s</h1><p>Comparative assembly hub built "
                 "by hal_tpu hal2assemblyHub from %s (%d genomes).</p>"
                 "</body></html>\n" % (o.longLabel, hal_base, len(genomes)))

    glines = []
    for g in leaves:
        gdir = os.path.join(o.outDir, g)
        chromsizes = os.path.join(gdir, "chrom.sizes")
        fa = os.path.join(gdir, g + ".fa")
        twobit = ""
        if shutil.which("faToTwoBit"):
            twobit = g + ".2bit"
            subprocess.run(["faToTwoBit", fa, os.path.join(gdir, twobit)], check=True)
        else:
            ah.note("faToTwoBit not found; leaving FASTA for %s" % g)
        # description.html (reference prepareHubFiles.writeDescriptionFile)
        with open(os.path.join(gdir, "description.html"), "w") as fh:
            fh.write("<h3>%s</h3>\n" % g)
        first_chrom = (get_hal_sequences(o.halFile, g) or ["chr"])[0]
        glines.append("genome %s\ntrackDb %s/trackDb.txt\ntwoBitPath %s/%s\n"
                      "organism %s\ndescription %s\ndefaultPos %s:1-1000\n"
                      "htmlPath %s/description.html\ngroups groups.txt\n\n"
                      % (g, g, g, twobit or (g + ".fa"), g, g, first_chrom, g))
        with open(os.path.join(gdir, "trackDb.txt"), "w") as fh:
            if not o.noSnakes:
                for other in genomes:
                    if other != g:
                        ah.trackdb_snake(fh, other, "../" + snake_data)
            _sig_tracks(o, aln, g, gdir, chromsizes, fh, len(genomes))
            _dir_tracks(o, g, gdir, chromsizes, fh)
    with open(os.path.join(o.outDir, "genomes.txt"), "w") as fh:
        fh.writelines(glines)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

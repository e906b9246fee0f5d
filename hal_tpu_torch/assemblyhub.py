"""Port copy of hal_tpu/assemblyhub.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

Assembly-hub track generators.

TPU-native re-design of the reference's per-track Toil jobs
(assemblyHub/gcPercentTrack.py, alignabilityTrack.py, conservationTrack.py,
rmskTrack.py, bedTrack.py, wigTrack.py, snakeTrack.py): each reference job
shells out to kent binaries (hgGcPercent, wigToBigWig, bedToBigBed); here
the signal tracks are computed natively from the columnar genome arrays
(vectorized numpy / the device column engine) and written as wiggle/BED
text, then converted to bigWig/bigBed via kent's binaries when present
or the native BBI writers (hal_tpu_torch.io.bbi) otherwise — the hub always
gets browser-consumable big* files, which the reference cannot do
without the kent userApps installed.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np

from hal_tpu_torch.dna import unpack_dna


# ---------------------------------------------------------------------------
# native signal computations
# ---------------------------------------------------------------------------

def gc_percent_wig(genome, out, win: int = 5) -> None:
    """Windowed GC%% as fixedStep wiggle (reference gcPercentTrack.py:23
    shells to `hgGcPercent -win=5 -doGaps`; this computes the same signal
    from the nibble-packed DNA arrays, vectorized)."""
    for si in range(genome.num_sequences):
        name = genome.seq_names[si]
        s = int(genome.seq_start[si])
        ln = int(genome.seq_start[si + 1] - s)
        if ln <= 0:
            continue
        bases = unpack_dna(genome.dna, s, ln)
        up = np.char.upper(bases.view("S1")).view(np.uint8)
        is_gc = (up == ord("G")) | (up == ord("C"))
        is_n = (up == ord("N"))
        nwin = ln // win
        if nwin == 0:
            continue
        gc = is_gc[: nwin * win].reshape(nwin, win).sum(axis=1)
        nn = is_n[: nwin * win].reshape(nwin, win).sum(axis=1)
        pct = np.where(nn == win, 0, (100 * gc) // np.maximum(win - nn, 1))
        out.write("fixedStep chrom=%s start=1 step=%d span=%d\n" % (name, win, win))
        out.write("\n".join(str(int(v)) for v in pct))
        out.write("\n")


def masked_bed(genome, out) -> int:
    """Soft-masked (lowercase) runs as BED — the rmsk-track stand-in when
    no RepeatMasker .out is available (reference rmskTrack.py converts
    .out/.bed inputs; HAL itself stores masking as case,
    extract/impl/halMaskExtractor.cpp)."""
    n = 0
    for si in range(genome.num_sequences):
        name = genome.seq_names[si]
        s = int(genome.seq_start[si])
        ln = int(genome.seq_start[si + 1] - s)
        if ln <= 0:
            continue
        bases = unpack_dna(genome.dna, s, ln)
        low = (bases >= ord("a")) & (bases <= ord("z"))
        d = np.diff(low.astype(np.int8))
        starts = np.flatnonzero(d == 1) + 1
        ends = np.flatnonzero(d == -1) + 1
        if low[0]:
            starts = np.concatenate([[0], starts])
        if low[-1]:
            ends = np.concatenate([ends, [ln]])
        for a, b in zip(starts, ends):
            out.write("%s\t%d\t%d\n" % (name, a, b))
            n += 1
    return n


# ---------------------------------------------------------------------------
# trackDb writers (one per reference assemblyHub/*Track.py writeTrackDb_*)
# ---------------------------------------------------------------------------

def trackdb_gc(f, genome: str, big: bool) -> None:
    f.write("track gcPercent\n"
            "longLabel GC Percent in 5-base Window\n"
            "shortLabel GC Percent\n"
            "type %s\ngroup map\nvisibility dense\nwindowingFunction Mean\n"
            "bigDataUrl %s\n\n"
            % ("bigWig 0 100" if big else "wig 0 100",
               genome + (".gc.bw" if big else ".gc.wig")))


def trackdb_alignability(f, genome: str, genome_count: int, big: bool) -> None:
    f.write("track alignability\n"
            "longLabel Alignability\nshortLabel Alignability\n"
            "type %s 0 %d\ngroup map\nvisibility dense\n"
            "windowingFunction Mean\nbigDataUrl %s\n\n"
            % ("bigWig" if big else "wig", genome_count,
               genome + (".alignability.bw" if big else ".alignability.wig")))


def trackdb_conservation(f, genome: str, big: bool) -> None:
    f.write("track conservation\n"
            "longLabel Conservation\nshortLabel Conservation\n"
            "type %s -1 1\ngroup map\nvisibility dense\n"
            "windowingFunction Mean\nbigDataUrl %s\n\n"
            % ("bigWig" if big else "wig",
               genome + (".conservation.bw" if big else ".conservation.wig")))


def trackdb_rmsk(f, genome: str, big: bool) -> None:
    f.write("track repeatMasker\n"
            "longLabel Repeat Masked Regions\nshortLabel RepeatMasker\n"
            "type %s\ngroup map\nvisibility dense\nbigDataUrl %s\n\n"
            % ("bigBed 3" if big else "bed 3",
               genome + (".rmsk.bb" if big else ".rmsk.bed")))


def trackdb_bed(f, track: str, path: str, big: bool) -> None:
    f.write("track %s\nlongLabel %s\nshortLabel %s\n"
            "type %s\ngroup annotation\nvisibility dense\nbigDataUrl %s\n\n"
            % (track, track, track, "bigBed" if big else "bed", path))


def trackdb_wig(f, track: str, path: str, big: bool) -> None:
    f.write("track %s\nlongLabel %s\nshortLabel %s\n"
            "type %s\ngroup annotation\nvisibility dense\nbigDataUrl %s\n\n"
            % (track, track, track, "bigWig" if big else "wig", path))


def trackdb_snake(f, other: str, hal_path: str) -> None:
    f.write("track snake%s\nlongLabel %s\nshortLabel %s\n"
            "otherSpecies %s\nvisibility full\nbigDataUrl %s\n"
            "type halSnake\ngroup snake\n\n"
            % (other, other, other, other, hal_path))


# ---------------------------------------------------------------------------
# kent-binary conversions (optional, like the reference)
# ---------------------------------------------------------------------------

def _read_chrom_sizes(chromsizes: str) -> dict:
    sizes = {}
    with open(chromsizes) as f:
        for line in f:
            p = line.split()
            if len(p) >= 2:
                sizes[p[0]] = int(p[1])
    return sizes


def try_wig_to_bigwig(wig: str, chromsizes: str, bw: str) -> bool:
    """kent's wigToBigWig when present (compressed output); else the
    native writer (hal_tpu_torch.io.bbi) — the hub gets real bigWigs either
    way, unlike the reference which requires the kent userApps."""
    if not os.path.exists(wig):
        return False
    if shutil.which("wigToBigWig"):
        subprocess.run(["wigToBigWig", wig, chromsizes, bw], check=True)
        return True
    from hal_tpu_torch.io.bbi import wig_to_bigwig

    try:
        wig_to_bigwig(wig, _read_chrom_sizes(chromsizes), bw)
        return True
    except Exception as e:  # bad user annotation: keep the plain-wig track
        note("native wigToBigWig failed for %s (%s); keeping wig" % (wig, e))
        if os.path.exists(bw):
            os.unlink(bw)  # no partial container in the hub
        return False


def try_bed_to_bigbed(bed: str, chromsizes: str, bb: str) -> bool:
    if not os.path.exists(bed):
        return False
    if shutil.which("bedToBigBed"):
        srt = bed + ".sorted"
        with open(srt, "w") as f:
            subprocess.run(["sort", "-k1,1", "-k2,2n", bed], stdout=f, check=True)
        subprocess.run(["bedToBigBed", srt, chromsizes, bb], check=True)
        os.unlink(srt)
        return True
    from hal_tpu_torch.io.bbi import bed_to_bigbed

    try:
        bed_to_bigbed(bed, _read_chrom_sizes(chromsizes), bb)
        return True
    except Exception as e:  # bad user annotation: keep the plain-bed track
        note("native bedToBigBed failed for %s (%s); keeping bed" % (bed, e))
        if os.path.exists(bb):
            os.unlink(bb)  # no partial container in the hub
        return False


def note(msg: str) -> None:
    sys.stderr.write("hal2assemblyHub: %s\n" % msg)

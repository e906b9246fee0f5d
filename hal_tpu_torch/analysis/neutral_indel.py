"""Port copy of hal_tpu/analysis/neutral_indel.py (numpy only; imports
pointing at hal_tpu_torch), with one declared divergence: lift_bed_set and
compare_conservation_over_branch take a torch `device`, and lift_bed_set
maps its intervals there on the batched mapper
(Liftover.convert_batched), where the original maps each line on the
host.  The lifted BED, so every interval set, is the original's.

Neutral-indel conservation analysis (reference analysis/neutralIndel/*).

Ports the *model* of:
- BedMutations event scan       (analysis/neutralIndel/bedMutations.py:14-87)
- background mutation rate      (analysis/neutralIndel/backgroundRate.py:83-86)
- BedConservation NI test       (analysis/neutralIndel/bedConservation.py:24-74)
- branch turnover comparison    (analysis/neutralIndel/turnoverRate.py:114-150)

but with the BedTools shell-outs replaced by `hal_tpu_torch.analysis.intervals`
vectorized set algebra and in-process liftover.
"""

from __future__ import annotations

import io
import math

import numpy as np

from hal_tpu_torch.analysis.intervals import IntervalSet

# Mutation BED tags (mutations/impl/halBranchMutations.cpp:14-30)
INVERSION_TAG = "V"
INSERTION_TAG = "I"
DELETION_TAG = "D"
DELETION_BREAK_TAG = "DB"
TRANSPOSITION_TAG = "P"
DUPLICATION_TAG = "U"
GAP_INSERTION_TAG = "GI"
GAP_DELETION_TAG = "GD"
GAP_DELETION_BREAK_TAG = "GDB"
SUBSTITUTION_TAG = "S"

# everything but dupes and transpositions (bedMutations.py:30-32)
DEFAULT_EVENTS = [INSERTION_TAG, GAP_INSERTION_TAG, DELETION_TAG,
                  DELETION_BREAK_TAG, GAP_DELETION_TAG, GAP_DELETION_BREAK_TAG]


def _event_match(tag: str, events) -> bool:
    """Substitution tags are S_<pc>; they match when 'S' is selected
    (bedMutations.py:84-87, backgroundRate.py:76-78)."""
    if tag.startswith(SUBSTITUTION_TAG):
        return SUBSTITUTION_TAG in events
    return tag in events


def read_mutations(path, events=None):
    """Parse a (sorted) branch-mutations BED; returns arrays
    (seq names list, starts, ends, tags list, anc_genome, genome)."""
    events = set(events if events is not None else DEFAULT_EVENTS)
    names, starts, ends, tags = [], [], [], []
    anc = genome = None
    f = open(path) if isinstance(path, str) else path
    try:
        for line in f:
            t = line.split()
            if not t or t[0][0] == "#":
                continue
            if len(t) < 6:
                raise ValueError("mutations BED needs 6 columns: %r" % line)
            if not _event_match(t[3], events):
                continue
            genome = t[5]
            anc = t[4]
            names.append(t[0])
            starts.append(int(t[1]))
            ends.append(int(t[2]))
            tags.append(t[3])
    finally:
        if isinstance(path, str):
            f.close()
    return (names, np.asarray(starts, dtype=np.int64),
            np.asarray(ends, dtype=np.int64), tags, anc, genome)


def background_rate(mutations_bed, background_bed, events=None):
    """(count, size): mutation events overlapping the background regions /
    total background length (backgroundRate.py:83-86; each overlapping
    (mutation, region) pair counts once, matching intersectBed -wa output)."""
    bg = IntervalSet.from_bed(background_bed)
    names, s, e, _tags, _a, _g = read_mutations(mutations_bed, events)
    count = int(bg.overlap_counts(names, s, e).sum()) if names else 0
    return count, bg.total_length()


class BedConservation:
    """Neutral-indel conservation test (bedConservation.py:24-74): intervals
    between consecutive mutation events whose inter-event distance is
    improbably long under a geometric null are called conserved."""

    def __init__(self):
        self.rate = None

    def compute_background_rate(self, mutations_bed, background_bed, events=None):
        self.count, self.size = background_rate(mutations_bed, background_bed, events)
        self.rate = float(self.count) / float(self.size)
        self.events = list(events if events is not None else DEFAULT_EVENTS)

    def bf_prob(self, distance: float) -> float:
        assert self.count > 0 and distance >= 0
        return math.pow(1.0 - self.rate, distance)

    def identify_conserved_intervals(self, bed_path, out_stream,
                                     max_pval=0.05, cutoff=0.5) -> None:
        assert self.rate is not None
        self.written_count = 0
        self.written_bases = 0
        names, s, e, _tags, anc, genome = read_mutations(bed_path, self.events)
        border = int((1.0 / self.rate) * cutoff)
        # vectorized inter-event gap over each sequence run
        # (reference resets prev on sequence change, bedMutations.py:67-70)
        for i in range(1, len(names)):
            if names[i] != names[i - 1]:
                continue
            d = int(s[i]) - int(e[i - 1])
            if d < 0:
                raise RuntimeError(
                    "Distance between (%d,%d) and (%d,%d) is negative which "
                    "probably means the mutations bed file is not sorted."
                    % (s[i - 1], e[i - 1], s[i], e[i]))
            if d > 2 * border:
                pval = self.bf_prob(d)
                if pval <= max_pval:
                    out_stream.write("%s\t%d\t%d\t%f\t%s\t%s\n" % (
                        names[i], int(e[i - 1]) + border, int(s[i]) - border,
                        pval, anc, genome))
                    self.written_bases += d - 2 * border
                    self.written_count += 1

    def min_distance(self, max_pval: float):
        """Smallest d with P(gap >= d) <= max_pval (bedConservation.py:68-74,
        closed form of the reference's linear scan)."""
        if self.rate <= 0:
            return None
        d = int(math.ceil(math.log(max_pval) / math.log(1.0 - self.rate)))
        return d if 1 <= d < self.size else (1 if self.bf_prob(1) <= max_pval else None)


def lift_bed_set(aln, src_genome: str, tgt_genome: str,
                 ivs: IntervalSet, *, device) -> IntervalSet:
    """Project an interval set to another genome and merge the result
    (turnoverRate.py getLiftUpBedFile: halLiftover | sortBed | mergeBed),
    mapping on `device`."""
    from hal_tpu_torch.ops.liftover import Liftover

    src = io.StringIO()
    ivs.write_bed(src)
    src.seek(0)
    out = io.StringIO()
    Liftover(aln, src_genome, tgt_genome, device=device).convert_batched(
        src, out)
    out.seek(0)
    return IntervalSet.from_bed(out)


def aligned_set(aln, genome_name: str) -> IntervalSet:
    """Aligned (to-parent) regions of a genome as a merged IntervalSet
    (turnoverRate.py getAlignedBed: halAlignedExtract | sortBed | mergeBed)."""
    from hal_tpu_torch.tools.halAlignedExtract import aligned_intervals

    g = aln.open_genome(genome_name)
    iv = aligned_intervals(g)
    if len(iv) == 0:
        return IntervalSet()
    si = np.searchsorted(g.seq_start, iv[:, 0], side="right") - 1
    base = g.seq_start[si]
    names = [g.seq_names[int(i)] for i in si]
    return IntervalSet.from_rows(names, iv[:, 0] - base, iv[:, 1] - base)


def compare_conservation_over_branch(aln, genome_name: str,
                                     genome_bed, parent_bed,
                                     out_paths: dict | None = None, *,
                                     device):
    """Conservation / gain / loss breakdown along one branch
    (turnoverRate.py:114-150), lifting on `device`.  Returns (conLen,
    gainLen, lossLen, unconLen).

    out_paths may supply BED output paths for the intermediates with keys:
    aligned, mapped_aligned, parent_sliced, mapped_genome, conservation,
    gain, loss.
    """
    genome_ivs = genome_bed if isinstance(genome_bed, IntervalSet) \
        else IntervalSet.from_bed(genome_bed)
    parent_ivs = parent_bed if isinstance(parent_bed, IntervalSet) \
        else IntervalSet.from_bed(parent_bed)
    if genome_ivs.is_empty():
        return (0, 0, 0, 0)
    parent_name = aln.tree.parent(genome_name)
    if parent_name is None:
        raise ValueError("%s has no parent" % genome_name)

    aligned = aligned_set(aln, genome_name)
    mapped_aligned = lift_bed_set(aln, genome_name, parent_name, aligned,
                                  device=device)
    parent_sliced = mapped_aligned.intersect(parent_ivs)
    mapped_genome = lift_bed_set(aln, genome_name, parent_name, genome_ivs,
                                 device=device)
    conservation = parent_sliced.intersect(mapped_genome)
    gain = mapped_genome.subtract(parent_sliced)
    loss = parent_sliced.subtract(mapped_genome)

    if out_paths:
        for key, ivs in (("aligned", aligned), ("mapped_aligned", mapped_aligned),
                         ("parent_sliced", parent_sliced),
                         ("mapped_genome", mapped_genome),
                         ("conservation", conservation),
                         ("gain", gain), ("loss", loss)):
            if key in out_paths:
                ivs.write_bed(out_paths[key])

    con_len = conservation.total_length()
    gain_len = gain.total_length()
    loss_len = loss.total_length()
    uncon_len = mapped_aligned.total_length() - con_len - gain_len - loss_len
    return (con_len, gain_len, loss_len, uncon_len)

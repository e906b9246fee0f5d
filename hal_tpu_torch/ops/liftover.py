"""Port copy of hal_tpu/ops/liftover.py (numpy only; the same code, imports
pointing at hal_tpu_torch), merged with the port's batched entries:
Liftover.convert_batched, visit_lines_batched and map_lines map line
batches on the torch segment mapper
(hal_tpu_torch.ops.segmap_torch.BatchMapper) on `device`, and run the
per-line pipeline against the mapped fragments.

Liftover engine: BED/PSL coordinate projection between genomes.

Capability-parity with the reference's Liftover/BlockLiftover
(reference liftover/impl/halLiftover.cpp, halBlockLiftover.cpp):
the per-interval mapping is hal_tpu's batched segment mapper
(ops/segmap_host.map_source) instead of per-segment halMapSegment calls,
and run extraction reproduces BlockMapper::extractSegment's
equivalence-class merge semantics (liftover/impl/halBlockMapper.cpp:331-391,
canMergeRightWith api/impl/halMappedSegment.cpp:109-161) exactly:

  * fragments sorted by (target pos, source pos) — the MappedSegmentSet
    order (fastComp, halMappedSegment.cpp:167-206),
  * dupe classes (equal target interval) merge class-to-class only when
    sizes match and every rank pair is adjacent in both coordinates,
  * a closing dupe run adds its right target coordinate to the query cut
    set, stopping later merges across it.
"""

from __future__ import annotations

import copy
import sys
from dataclasses import dataclass

import numpy as np
import torch

from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.genome import GenomeArrays
from hal_tpu_torch.io.bed import BedLine, PSLInfo, read_bed
from hal_tpu_torch.ops import segmap_host as sm
from hal_tpu_torch.ops.segmap_torch import BatchMapper, start_cap_mult


@dataclass
class _Frag:
    tgt_lo: int
    tgt_hi: int
    src_lo: int
    src_hi: int
    rev: bool


def _can_merge_right(a: _Frag, b: _Frag, query_cut: set[int]) -> bool:
    if a.rev != b.rev:
        return False
    if b.tgt_lo != a.tgt_hi:
        return False
    if a.rev:
        if a.src_lo != b.src_hi:
            return False
    else:
        if b.src_lo != a.src_hi:
            return False
    if (a.tgt_hi - 1) in query_cut:
        return False
    return True


def extract_runs(frags: sm.Fragments, seq_index_of) -> list[list[_Frag]]:
    """BlockMapper::extractSegment over an atomized fragment set.

    `seq_index_of(pos)` maps a target position to its sequence index (runs
    never span target sequences).  Returns runs in set-iteration (target)
    order; each run is the rank-0 chain of its dupe classes."""
    n = len(frags)
    if n == 0:
        return []
    order = np.lexsort((frags.rev, frags.src_hi, frags.src_lo, frags.tgt_hi, frags.tgt_lo))
    fl = [_Frag(int(frags.tgt_lo[i]), int(frags.tgt_hi[i]), int(frags.src_lo[i]),
                int(frags.src_hi[i]), bool(frags.rev[i])) for i in order]
    consumed = [False] * n
    query_cut: set[int] = set()
    runs: list[list[_Frag]] = []

    def cls_at(k: int) -> list[int]:
        """indices (into fl) of the unconsumed class starting at k."""
        out = [k]
        t0 = fl[k].tgt_lo
        j = k + 1
        while j < n:
            if consumed[j]:
                j += 1
                continue
            if fl[j].tgt_lo != t0:
                break
            out.append(j)
            j += 1
        return out

    def next_unconsumed(k: int) -> int:
        while k < n and consumed[k]:
            k += 1
        return k

    for h in range(n):
        if consumed[h]:
            continue
        head_seq = seq_index_of(fl[h].tgt_lo)
        run = [fl[h]]
        v1 = cls_at(h)
        nxt = next_unconsumed(v1[-1] + 1)
        while nxt < n:
            # collect v2: consecutive unconsumed, same target start, <= |v1|
            v2 = []
            j = nxt
            while j < n and len(v2) < len(v1):
                if consumed[j]:
                    j += 1
                    continue
                if v2 and fl[j].tgt_lo != fl[v2[-1]].tgt_lo:
                    break
                v2.append(j)
                j += 1
            if not v2:
                break
            ok = len(v1) == len(v2)
            for a, b in zip(v1, v2) if ok else ():
                if seq_index_of(fl[b].tgt_lo) != head_seq or not _can_merge_right(fl[a], fl[b], query_cut):
                    ok = False
                    break
            if not ok:
                break
            run.append(fl[v2[0]])
            consumed[v2[0]] = True
            v1 = v2
            nxt = next_unconsumed(v2[-1] + 1)
        if len(v1) > 1:
            query_cut.add(run[-1].tgt_hi - 1)
        runs.append(run)
    return runs


class Liftover:
    """BED/PSL liftover between two genomes of one alignment
    (reference Liftover::convert, liftover/impl/halLiftover.cpp:23-44), with
    the batched mapper on `device` (a torch device)."""

    def __init__(self, aln: Alignment, src_genome: str, tgt_genome: str,
                 traverse_dupes: bool = True, out_psl: bool = False,
                 psl_with_name: bool = False, coalescence_limit: str | None = None,
                 *, device):
        self.aln = aln
        self.src_name = src_genome
        self.tgt_name = tgt_genome
        self.src: GenomeArrays = aln.open_genome(src_genome)
        self.tgt: GenomeArrays = aln.open_genome(tgt_genome)
        self.traverse_dupes = traverse_dupes
        self.out_psl = out_psl
        self.psl_with_name = psl_with_name
        self.coalescence_limit = coalescence_limit
        self._missed: set[str] = set()
        # batched mode: {(gs, ge): Fragments} filled by the batched entries
        # so lift_interval skips the per-line map_source call (the device
        # bulk mapper produced the fragments; a miss raises) — output bytes
        # stay identical because extract_runs canonicalizes fragment order
        # itself
        self._frag_cache: dict | None = None
        self.device = torch.device(device)

    # ------------------------------------------------------------- mapping
    def lift_interval(self, bed: BedLine, seq_index: int) -> list[BedLine]:
        """Map one source interval; returns mapped blocks (one BedLine per
        extracted run, reference BlockLiftover::liftInterval)."""
        gs = int(self.src.seq_start[seq_index]) + bed.start
        ge = int(self.src.seq_start[seq_index]) + bed.end
        flip = bed.strand == "-"
        if self._frag_cache is not None:
            # batched mode maps nothing on the host: a line the batch did
            # not enumerate (_intervals) is a fault of the caller
            frags = self._frag_cache.get((gs, ge))
            if frags is None:
                raise RuntimeError(
                    "interval %s:%d-%d of %s was not mapped by the batched "
                    "mapper" % (bed.chrom, bed.start, bed.end, self.src_name))
        else:
            frags = sm.map_source(self.aln, self.src_name, np.array([gs]), np.array([ge]),
                                  self.tgt_name, do_dupes=self.traverse_dupes,
                                  coalescence_limit=self.coalescence_limit)
        runs = extract_runs(frags, lambda p: int(np.searchsorted(self.tgt.seq_start, p, side="right")) - 1)
        out = []
        for run in runs:
            first, last = run[0], run[-1]
            rev = first.rev
            tgt_lo = first.tgt_lo
            tgt_hi = last.tgt_hi
            si = int(np.searchsorted(self.tgt.seq_start, tgt_lo, side="right")) - 1
            seq_start = int(self.tgt.seq_start[si])
            b = BedLine(chrom=self.tgt.seq_names[si],
                        start=tgt_lo - seq_start, end=tgt_hi - seq_start,
                        bed_type=bed.bed_type, name=bed.name, score=bed.score,
                        thick_start=bed.thick_start, thick_end=bed.thick_end,
                        item_rgb=bed.item_rgb, extra=list(bed.extra))
            b.strand = "-" if (rev ^ flip) else "+"
            b.src_start = min(first.src_lo, last.src_lo)
            b.src_strand = "-" if flip else "+"
            if bed.strand == ".":
                b.strand = "."
                b.src_strand = "."
            if self.out_psl:
                self._read_psl_info(run, b, flip)
            out.append(b)
        return out

    def _read_psl_info(self, run: list[_Frag], b: BedLine, flip: bool) -> None:
        """Per-run PSL stats (reference BlockLiftover::readPSLInfo,
        halBlockLiftover.cpp:119-162)."""
        si = self.src.seq_index_at(run[0].src_lo)
        psl = PSLInfo()
        psl.q_seq_name = self.src.seq_names[int(si)]
        psl.q_seq_size = self.src.seq_length(int(si))
        psl.q_strand = "-" if flip else "+"
        psl.q_chrom_offset = int(self.src.seq_start[int(si)])
        psl.q_end = b.src_start + (b.end - b.start)
        ti = self.tgt.seq_index_at(run[0].tgt_lo)
        psl.t_seq_size = self.tgt.seq_length(int(ti))
        for f in run:
            s = self.src.get_dna(f.src_lo, f.src_hi - f.src_lo)
            t = self.tgt.get_dna(f.tgt_lo, f.tgt_hi - f.tgt_lo, reversed_=f.rev)
            eq = s == t
            s_mask = (s >= 97) & (s <= 122)
            t_mask = (t >= 97) & (t <= 122)
            masked = s_mask | t_mask
            t_missing = (t == ord("n")) | (t == ord("N"))
            psl.matches += int(np.count_nonzero(eq & ~masked))
            psl.rep_matches += int(np.count_nonzero(eq & masked))
            psl.n_count += int(np.count_nonzero(~eq & t_missing))
            psl.mis_matches += int(np.count_nonzero(~eq & ~t_missing))
        b.psl = psl

    # ------------------------------------------------------------ pipeline
    def visit_line(self, bed: BedLine) -> list[BedLine]:
        """Process one input line (reference Liftover::visitLine,
        halLiftover.cpp:45-92)."""
        if self.out_psl and bed.bed_type < 12:
            bed.expand_to_bed12()
        try:
            seq_index = self.src.sequence_index(bed.chrom)
        except KeyError:
            if bed.chrom not in self._missed:
                self._missed.add(bed.chrom)
                sys.stderr.write("Unable to find sequence %s in genome %s\n"
                                 % (bed.chrom, self.src_name))
            return []
        if bed.end > self.src.seq_length(seq_index):
            sys.stderr.write("Skipping interval with endpoint %dbecause sequence %s has length %d\n"
                             % (bed.end, bed.chrom, self.src.seq_length(seq_index)))
            return []
        if bed.bed_type > 9 and not bed.blocks:
            sys.stderr.write("Skipping input line with 0 blocks\n")
            return []

        mapped: list[BedLine] = []
        if bed.bed_type <= 9:
            mapped = self.lift_interval(bed, seq_index)
            out = list(mapped)
        else:
            # lift each block separately (liftBlockIntervals, :296-309)
            for bs, bl in sorted(bed.blocks):
                sub = BedLine(**{**bed.__dict__})
                sub.blocks = []
                sub.start = bed.start + bs
                sub.end = sub.start + bl
                if sub.end > sub.start:
                    mapped.extend(self.lift_interval(sub, seq_index))
            out = self._assign_blocks_to_intervals(bed, mapped)

        self._clean_results(bed, out)
        out.sort(key=lambda l: l.src_start)  # BedLineSrcLess, stable
        return out

    def _assign_blocks_to_intervals(self, bed: BedLine, blocks: list[BedLine]) -> list[BedLine]:
        """Merge mapped blocks into BED12 lines (reference
        assignBlocksToIntervals, halLiftover.cpp:108-168)."""
        blocks = sorted(blocks, key=lambda b: b.src_start)  # stable
        out: list[BedLine] = []
        prev_src_end = None
        for i, blk in enumerate(blocks):
            src_end = blk.src_start + (blk.end - blk.start)
            nxt = blocks[i + 1] if i + 1 < len(blocks) else None
            dupe = (prev_src_end is not None and blk.src_start < prev_src_end) or \
                   (nxt is not None and nxt.src_start < src_end)
            if not out or (self.out_psl and dupe) or not self._compatible(bed, out[-1], blk):
                line = BedLine(**{**blk.__dict__})
                line.blocks = []
                if self.out_psl:
                    line.psl = blk.psl
                    line.psl.q_block_starts = []
                out.append(line)
            prev_src_end = src_end
            tgt = out[-1]
            tgt.start = min(tgt.start, blk.start)
            tgt.end = max(tgt.end, blk.end)
            tgt.blocks.append((blk.start, blk.end - blk.start))  # absolute for now
            if self.out_psl:
                tgt.psl.q_block_starts.append(blk.src_start)
                if len(tgt.blocks) > 1:
                    tgt.psl.matches += blk.psl.matches
                    tgt.psl.mis_matches += blk.psl.mis_matches
                    tgt.psl.rep_matches += blk.psl.rep_matches
                    tgt.psl.n_count += blk.psl.n_count
        # relativize block starts
        for line in out:
            line.blocks = [(s - line.start, l) for s, l in line.blocks]
        self._flip_blocks(bed, out)
        if self.out_psl:
            self._compute_psl_inserts(out)
        return out

    def _compatible(self, bed: BedLine, tgt: BedLine, blk: BedLine) -> bool:
        """reference Liftover::compatible (halLiftover.cpp:170-196)."""
        if tgt.strand != blk.strand:
            return False
        if tgt.src_start == blk.src_start:
            return False
        lb_start, lb_len = tgt.blocks[-1]
        if tgt.strand != bed.strand:
            delta = lb_start - blk.end
        else:
            delta = blk.start - (lb_start + lb_len)
        if delta < 0:
            return False
        if tgt.chrom != blk.chrom:
            return False
        return True

    def _flip_blocks(self, bed: BedLine, lines: list[BedLine]) -> None:
        """reference Liftover::flipBlocks (halLiftover.cpp:198-235)."""
        for line in lines:
            if len(line.blocks) > 1:
                delta = line.blocks[1][0] - (line.blocks[0][0] + line.blocks[0][1])
                if not self.out_psl:
                    must = delta < 0
                else:
                    must = ((line.strand == "-") == (delta >= 0))
                if must:
                    line.blocks.reverse()
                    if self.out_psl:
                        line.psl.q_block_starts.reverse()

    def _compute_psl_inserts(self, lines: list[BedLine]) -> None:
        """reference Liftover::computePSLInserts (halLiftover.cpp:236-291):
        gaps between consecutive blocks in ascending target / query order."""
        for line in lines:
            psl = line.psl
            psl.q_num_insert = psl.q_base_insert = 0
            psl.t_num_insert = psl.t_base_insert = 0
            blocks = line.blocks if line.strand != "-" else list(reversed(line.blocks))
            for (ps, pl), (cs, cl) in zip(blocks, blocks[1:]):
                gap = cs - (ps + pl)
                if gap > 0:
                    psl.t_num_insert += 1
                    psl.t_base_insert += gap
            qb = list(zip(psl.q_block_starts, [l for _, l in line.blocks]))
            if psl.q_strand == "-":
                qb = list(reversed(qb))
            for (pq, pl), (cq, cl) in zip(qb, qb[1:]):
                gap = cq - (pq + pl) if cq >= pq + pl else 0
                if gap > 0:
                    psl.q_num_insert += 1
                    psl.q_base_insert += gap
        return

    def _clean_results(self, bed: BedLine, lines: list[BedLine]) -> None:
        """reference Liftover::cleanResults (halLiftover.cpp:313-345)."""
        if bed.bed_type > 6:
            for line in lines:
                if bed.thick_start != 0 or bed.thick_end != 0:
                    line.thick_start = line.start
                    line.thick_end = line.end
                if bed.bed_type > 9 and line.blocks and self.out_psl:
                    line.src_start = min(line.psl.q_block_starts)
                    line.psl.q_end = max(q + l for q, (s, l) in
                                         zip(line.psl.q_block_starts, line.blocks))

    def convert(self, in_stream, out_stream, bed_type: int = 0) -> None:
        for bed in read_bed(in_stream, bed_type):
            self._emit(bed, out_stream)

    def _emit(self, bed: BedLine, out_stream) -> None:
        for line in self.visit_line(bed):
            if self.out_psl:
                out_stream.write(line.write_psl(self.psl_with_name))
            else:
                out_stream.write(line.write())

    def _enumerate_intervals(self, bed: BedLine) -> list[tuple[int, int]]:
        """The (gs, ge) intervals visit_line would map for this line —
        mirrors its skip/branch logic (halLiftover.cpp:45-92) without
        emitting warnings.  Mutates `bed` (expand_to_bed12) like visit_line;
        callers pass a copy."""
        if self.out_psl and bed.bed_type < 12:
            bed.expand_to_bed12()
        try:
            seq_index = self.src.sequence_index(bed.chrom)
        except KeyError:
            return []
        if bed.end > self.src.seq_length(seq_index):
            return []
        if bed.bed_type > 9 and not bed.blocks:
            return []
        base = int(self.src.seq_start[seq_index])
        if bed.bed_type <= 9:
            return [(base + bed.start, base + bed.end)]
        return [(base + bed.start + bs, base + bed.start + bs + bl)
                for bs, bl in sorted(bed.blocks) if bl > 0]

    def _intervals(self, chunk) -> list[tuple[int, int]]:
        """Distinct (gs, ge) intervals that visit_line maps for a chunk."""
        intervals: list[tuple[int, int]] = []
        seen = set()
        for bed in chunk:
            for iv in self._enumerate_intervals(copy.deepcopy(bed)):
                if iv not in seen:
                    seen.add(iv)
                    intervals.append(iv)
        return intervals

    def _chunk_cache(self, intervals, f6) -> dict:
        """{(gs, ge): Fragments} of a chunk's distinct intervals from the
        batched mapper's fragments (owner k is intervals[k])."""
        from hal_tpu_torch.ops.liftover_bulk import atomize_by_owner

        cache: dict = {}
        if intervals:
            scale = int(max(self.src.length, self.tgt.length) + 2)
            s_lo, s_hi, t_lo, t_hi, rev, owner = atomize_by_owner(
                *[np.asarray(a, np.int64) for a in f6[:4]],
                np.asarray(f6[4], np.uint8), np.asarray(f6[5], np.int64),
                scale)
            order = np.argsort(owner, kind="stable")
            s_lo, s_hi, t_lo, t_hi, rev, owner = (
                a[order] for a in (s_lo, s_hi, t_lo, t_hi, rev, owner))
            ks = np.arange(len(intervals))
            starts = np.searchsorted(owner, ks, side="left")
            ends = np.searchsorted(owner, ks, side="right")
            for k, iv in enumerate(intervals):
                a, b = int(starts[k]), int(ends[k])
                cache[iv] = sm.Fragments(s_lo[a:b], s_hi[a:b], t_lo[a:b],
                                         t_hi[a:b], rev[a:b])
        return cache

    def _mapped_chunks(self, beds: list, batch_size: int):
        """Yield (chunk, cache) for each batch_size lines of beds (0: all in
        one chunk), cache holding every interval visit_line maps for the
        chunk, from one BatchMapper dispatch on self.device (paralogy
        branches as map_source's, host_paralogies).  Chunk k+1 is
        dispatched before chunk k is decoded, so the caller's host work on
        chunk k overlaps the device's work on chunk k+1."""
        if batch_size <= 0:
            batch_size = max(len(beds), 1)
        mapper = BatchMapper(self.aln, self.src_name, self.tgt_name,
                             do_dupes=self.traverse_dupes,
                             coalescence_limit=self.coalescence_limit,
                             host_paralogies=True, device=self.device)
        pend = None  # (chunk, intervals, handle)
        for pos in range(0, len(beds), batch_size):
            chunk = beds[pos:pos + batch_size]
            intervals = self._intervals(chunk)
            handle = None
            if intervals:
                lo = np.array([a for a, _ in intervals], np.int64)
                hi = np.array([b for _, b in intervals], np.int64)
                handle = mapper.dispatch(
                    lo, hi, cap_mult=start_cap_mult(self.src, lo, hi))
            if pend is not None:
                yield self._decoded(mapper, pend)
            pend = (chunk, intervals, handle)
        if pend is not None:
            yield self._decoded(mapper, pend)

    def _decoded(self, mapper, pend):
        chunk, intervals, handle = pend
        f6 = mapper.decode(handle) if handle is not None else None
        return chunk, self._chunk_cache(intervals, f6)

    def convert_batched(self, in_stream, out_stream, bed_type: int = 0,
                        batch_size: int = 1 << 16) -> None:
        """Batched convert on the torch mapper (_mapped_chunks): host
        formatting of chunk k overlaps the device's mapping of chunk k+1.
        batch_size 0 maps the whole input in one chunk.  Output bytes
        equal convert()'s."""
        beds = list(read_bed(in_stream, bed_type))
        for chunk, cache in self._mapped_chunks(beds, batch_size):
            self._frag_cache = cache
            try:
                for bed in chunk:
                    self._emit(bed, out_stream)
            finally:
                self._frag_cache = None

    def visit_lines_batched(self, beds, batch_size: int = 1 << 16,
                            fresh_missed: bool = False):
        """Yield visit_line(bed) for each of beds in order, the chunk's
        intervals mapped by one BatchMapper dispatch (_mapped_chunks).
        The results and stderr warnings equal per-line visit_line's;
        fresh_missed warns of a missing sequence on every line that names
        it, as a new Liftover for each line would."""
        for chunk, cache in self._mapped_chunks(list(beds), batch_size):
            self._frag_cache = cache
            try:
                for bed in chunk:
                    if fresh_missed:
                        self._missed = set()
                    yield self.visit_line(bed)
            finally:
                self._frag_cache = None

    def map_lines(self, beds, batch_size: int = 1 << 16) -> None:
        """Map every interval visit_line maps for beds on the batched
        mapper (_mapped_chunks) into the fragment cache, and leave it
        filled: later visit_line and convert calls on these lines read
        their fragments from it and map nothing."""
        cache: dict = {}
        for _chunk, part in self._mapped_chunks(list(beds), batch_size):
            cache.update(part)
        self._frag_cache = cache

"""Port copy of hal_tpu/blockviz.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

Browser snake-track query API — capability parity with libHalBlockViz
(reference blockViz/inc/halBlockViz.h, blockViz/impl/halBlockViz.cpp).

The reference exposes a C API consumed by the UCSC browser
(halGetBlocksInTargetRange :243, halOpenLodOrHal :99, dupe modes :86-97,
seq modes :99-107, global mutex :29-40).  Here the same operations are a
thread-safe Python API over the batched mapper; all coordinates are
forward-strand relative like the C structs (halBlockViz.h:48-60).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np

from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.ops import segmap_host as sm

# dupe modes (halBlockViz.h:86-97)
HAL_NO_DUPS = 0
HAL_QUERY_DUPS = 1
HAL_QUERY_AND_TARGET_DUPS = 2

# seq modes (halBlockViz.h:99-107)
HAL_NO_SEQUENCE = 0
HAL_LOD0_SEQUENCE = 1
HAL_FORCE_LOD0_SEQUENCE = 2

_lock = threading.Lock()  # the reference serializes all API calls


@dataclass
class Block:
    """hal_block_t (halBlockViz.h:51-60); forward-strand coordinates."""

    q_chrom: str
    t_start: int
    q_start: int
    size: int
    strand: str
    q_sequence: str | None = None
    t_sequence: str | None = None


@dataclass
class TargetDupe:
    """hal_target_dupe_list_t: target ranges mapping to one query location."""

    t_ranges: list
    q_chrom: str


class LodManager:
    """Pick the right alignment for a query length from a lod.txt manifest
    (reference lod/impl/halLodManager.cpp; format halBlockViz.h:108-118)."""

    def __init__(self, path: str):
        self.levels = []  # (min_query_len, path) ascending
        base_dir = os.path.dirname(os.path.abspath(path))
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) != 2:
                    continue
                p = parts[1]
                if not os.path.isabs(p):
                    p = os.path.join(base_dir, p)
                self.levels.append((int(parts[0]), p))
        self.levels.sort()
        self._cache = {}

    def path_for(self, query_length: int, force_lod0: bool = False) -> str:
        if force_lod0 or not self.levels:
            return self.levels[0][1]
        best = self.levels[0][1]
        for min_len, p in self.levels:
            if query_length >= min_len:
                best = p
        return best

    def alignment_for(self, query_length: int, force_lod0: bool = False):
        p = self.path_for(query_length, force_lod0)
        if p not in self._cache:
            self._cache[p] = open_alignment(p)
        return self._cache[p]


class Handle:
    """halOpenLodOrHal equivalent: holds either a single alignment or a
    LOD manifest."""

    def __init__(self, path: str):
        from hal_tpu_torch.storage.remote import is_url

        self.path = path
        self.lod = None
        if is_url(path):
            # remote browser serving — the reference's UDC headline use
            # case (README.md:126-131); halz URLs page 8 KiB blocks via
            # RemoteArray, hdf5 URLs via the BlockFile h5py file object
            self.aln = open_alignment(path)
            return
        if not os.path.isdir(path):
            with open(path, "rb") as fh:
                head = fh.read(64)
            if not head.startswith(b"\x89HDF") and head[:1].isdigit():
                self.lod = LodManager(path)
        if self.lod is None:
            self.aln = open_alignment(path)

    def alignment(self, query_length: int = 0, force_lod0: bool = False):
        if self.lod is not None:
            return self.lod.alignment_for(query_length, force_lod0)
        return self.aln


def hal_open(path: str) -> Handle:
    with _lock:
        return Handle(path)


def get_genome_names(handle: Handle) -> list[str]:
    """halGetSpecies equivalent."""
    with _lock:
        return handle.alignment().genome_names()


def get_chroms(handle: Handle, species: str):
    """halGetChroms: (name, length) list."""
    with _lock:
        g = handle.alignment().open_genome(species)
        return [(n, g.seq_length(i)) for i, n in enumerate(g.seq_names)]


def get_dna(handle: Handle, species: str, chrom: str, start: int, end: int) -> str:
    """halGetDna."""
    with _lock:
        g = handle.alignment(0, force_lod0=True).open_genome(species)
        si = g.sequence_index(chrom)
        return g.get_dna_string(int(g.seq_start[si]) + start, end - start)


def _cut_at(frags: sm.Fragments, cuts) -> sm.Fragments:
    """Split fragments at source-coordinate cut positions (the reference's
    targetCutSet = {absRefFirst, absRefLast} passed to extractSegment,
    halBlockViz.cpp:799-801), so adjacency extensions stay separate blocks."""
    src_lo, src_hi, tgt_lo, tgt_hi, rev = [], [], [], [], []
    for i in range(len(frags.src_lo)):
        lo, hi = int(frags.src_lo[i]), int(frags.src_hi[i])
        points = [lo] + [c for c in sorted(cuts) if lo < c < hi] + [hi]
        for a, b in zip(points, points[1:]):
            src_lo.append(a)
            src_hi.append(b)
            if frags.rev[i]:
                tgt_hi.append(int(frags.tgt_hi[i]) - (a - lo))
                tgt_lo.append(int(frags.tgt_hi[i]) - (b - lo))
            else:
                tgt_lo.append(int(frags.tgt_lo[i]) + (a - lo))
                tgt_hi.append(int(frags.tgt_lo[i]) + (b - lo))
            rev.append(int(frags.rev[i]))
    return sm.Fragments(np.array(src_lo, np.int64), np.array(src_hi, np.int64),
                        np.array(tgt_lo, np.int64), np.array(tgt_hi, np.int64),
                        np.array(rev, np.uint8))


def _map_adjacencies(aln, frags: sm.Fragments, t_species: str, q_species: str,
                     do_dupes: bool) -> sm.Fragments:
    """BlockMapper::mapAdjacencies (liftover/impl/halBlockMapper.cpp:121-245):
    for each mapped query interval, probe one query segment beyond each end
    (maxAdjScan=1), cut the probe against the neighboring mapped interval,
    map it back to the target genome, and add non-overlapping back-mappings
    (nearest copy on ties) to the fragment set."""
    qg = aln.open_genome(q_species)
    n = len(frags.src_lo)
    if n == 0:
        return frags
    order = np.argsort(frags.tgt_lo, kind="stable")
    q_iv = [(int(frags.tgt_lo[i]), int(frags.tgt_hi[i]), bool(frags.rev[i]),
             int(frags.src_lo[i])) for i in order]
    out = [frags]
    covered = [(lo, hi) for lo, hi, _, _ in q_iv]

    seg_starts = qg.top_start if qg.num_top_segments else qg.bot_start

    def seg_of(pos):
        return int(np.searchsorted(seg_starts, pos, side="right")) - 1

    added = []
    for k, (qlo, qhi, qrev, ref_anchor) in enumerate(q_iv):
        for right in (True, False):
            # direction in forward query coords: a reversed iterator's
            # "right" walks left (makeIterator + toRight semantics)
            fwd = right != qrev
            if fwd:
                s = seg_of(qhi - 1)
                if qhi < int(seg_starts[s + 1]):
                    plo, phi = qhi, int(seg_starts[s + 1])
                elif s + 1 < len(seg_starts) - 1:
                    plo, phi = int(seg_starts[s + 1]), int(seg_starts[s + 2])
                else:
                    continue
                nb = q_iv[k + 1] if k + 1 < len(q_iv) else None
            else:
                s = seg_of(qlo)
                if qlo > int(seg_starts[s]):
                    plo, phi = int(seg_starts[s]), qlo
                elif s > 0:
                    plo, phi = int(seg_starts[s - 1]), int(seg_starts[s])
                else:
                    continue
                nb = q_iv[k - 1] if k > 0 else None
            # cutByNext (halBlockMapper.cpp:273-330), same-segment only
            if nb is not None and seg_of(nb[0]) == seg_of(plo):
                if fwd:
                    if plo >= nb[0]:
                        continue
                    if phi > nb[0]:
                        phi = nb[0]
                else:
                    if phi <= nb[1]:
                        continue
                    if plo < nb[1]:
                        plo = nb[1]
            if phi <= plo:
                continue
            back = sm.map_source(aln, q_species, np.array([plo]),
                                 np.array([phi]), t_species, do_dupes=do_dupes)
            if len(back.src_lo) == 0:
                continue
            # flip to (src=target genome, tgt=query) and drop overlaps with
            # already-mapped query intervals
            cands = []
            for i in range(len(back.src_lo)):
                c_qlo, c_qhi = int(back.src_lo[i]), int(back.src_hi[i])
                c_tlo, c_thi = int(back.tgt_lo[i]), int(back.tgt_hi[i])
                if any(c_qlo < hi and lo < c_qhi for lo, hi in covered):
                    continue
                cands.append((c_qlo, c_qhi, c_tlo, c_thi, int(back.rev[i])))
            # nearest-copy dedupe over identical query intervals
            by_iv: dict = {}
            for c in cands:
                by_iv.setdefault((c[0], c[1]), []).append(c)
            for iv, group in by_iv.items():
                best = min(group, key=lambda c: min(abs(c[2] - ref_anchor),
                                                    abs(c[3] - 1 - ref_anchor)))
                added.append(best)
                covered.append((best[0], best[1]))

    if added:
        out.append(sm.Fragments(
            np.array([c[2] for c in added], np.int64),
            np.array([c[3] for c in added], np.int64),
            np.array([c[0] for c in added], np.int64),
            np.array([c[1] for c in added], np.int64),
            np.array([c[4] for c in added], np.uint8)))
        return sm.Fragments(
            np.concatenate([f.src_lo for f in out]),
            np.concatenate([f.src_hi for f in out]),
            np.concatenate([f.tgt_lo for f in out]),
            np.concatenate([f.tgt_hi for f in out]),
            np.concatenate([f.rev for f in out]))
    return frags


def get_blocks_in_target_range(handle: Handle, q_species: str, t_species: str,
                               t_chrom: str, t_start: int, t_end: int,
                               seq_mode: int = HAL_NO_SEQUENCE,
                               dup_mode: int = HAL_QUERY_DUPS,
                               map_back_adjacencies: bool = False,
                               coalescence_limit: str | None = None,
                               t_reversed: bool = False):
    """halGetBlocksInTargetRange (halBlockViz.cpp:243, readBlocks :759-813).

    Returns (blocks, target_dupes): query-genome alignment blocks of the
    target range, forward-strand coordinates.

    t_reversed queries against the reverse strand of the target range: the
    reference maps each reference segment reversed-in-place
    (halBlockMapper.cpp:100-106), which leaves every coordinate
    forward-normalized and flips each block's strand (readBlock's
    firstQuerySeg->getReversed(), halBlockViz.cpp:868).  Same validation
    combos as the reference (halBlockViz.cpp:259-267).
    """
    if t_reversed and map_back_adjacencies:
        raise ValueError(
            "tReversed can only be set when mapBackAdjacencies is 0")
    if t_reversed and dup_mode == HAL_QUERY_AND_TARGET_DUPS:
        raise ValueError(
            "tReversed cannot be set in conjunction with "
            "dupMode=HAL_QUERY_AND_TARGET_DUPS")
    with _lock:
        qlen = t_end - t_start
        force = seq_mode == HAL_FORCE_LOD0_SEQUENCE
        aln = handle.alignment(qlen, force_lod0=force)
        tg = aln.open_genome(t_species)
        qg = aln.open_genome(q_species)
        si = tg.sequence_index(t_chrom)
        base = int(tg.seq_start[si])
        gs, ge = base + t_start, base + t_end
        frags = sm.map_source(aln, t_species, np.array([gs]), np.array([ge]),
                              q_species, do_dupes=dup_mode != HAL_NO_DUPS,
                              coalescence_limit=coalescence_limit)
        if map_back_adjacencies:
            frags = _map_adjacencies(aln, frags, t_species, q_species,
                                     do_dupes=dup_mode != HAL_NO_DUPS)
        merged = sm.merge_colinear(frags, seq_bounds=qg.seq_start)
        merged = _cut_at(merged, (gs, ge))
        want_seq = seq_mode != HAL_NO_SEQUENCE and qg.has_dna and tg.has_dna
        blocks = []
        # hal_block_t list follows MappedSegmentSet order: sorted by the
        # query-genome (mapping target) coordinates (halMappedSegment.h:69-77)
        order = np.argsort(merged.tgt_lo, kind="stable")
        for i in order:
            qsi = int(np.searchsorted(qg.seq_start, int(merged.tgt_lo[i]), side="right")) - 1
            qbase = int(qg.seq_start[qsi])
            rev = bool(merged.rev[i]) ^ t_reversed
            b = Block(
                q_chrom=qg.seq_names[qsi],
                t_start=int(merged.src_lo[i]) - base,
                q_start=int(merged.tgt_lo[i]) - qbase,
                size=int(merged.src_hi[i] - merged.src_lo[i]),
                strand="-" if rev else "+",
            )
            if want_seq:
                b.t_sequence = tg.get_dna_string(int(merged.src_lo[i]), b.size)
                b.q_sequence = qg.get_dna_string(int(merged.tgt_lo[i]), b.size,
                                                 reversed_=rev)
            blocks.append(b)

        target_dupes = []
        if dup_mode == HAL_QUERY_AND_TARGET_DUPS:
            # target ranges that share a query location ("blue line" dupes,
            # processTargetDupes halBlockViz.cpp:939)
            back = sm.map_source(aln, t_species, np.array([gs]), np.array([ge]),
                                 t_species, do_dupes=True,
                                 coalescence_limit=aln.root_name)
            groups = {}
            for i in range(len(back)):
                key = (int(back.tgt_lo[i]), int(back.tgt_hi[i]))
                groups.setdefault(key, []).append(
                    (int(back.src_lo[i]) - base, int(back.src_hi[i]) - base))
            for key, ranges in groups.items():
                if len(ranges) > 1:
                    target_dupes.append(TargetDupe(sorted(ranges), t_chrom))
        return blocks, target_dupes


def get_species_info(handle: Handle):
    """(name, length, numChroms, parentName|None, branchLength) per genome —
    the halGetSpecies payload (halBlockViz.h:300-310)."""
    with _lock:
        aln = handle.alignment()
        out = []
        for n in aln.genome_names():
            g = aln.open_genome(n)
            parent = aln.tree.parent(n)
            bl = aln.tree.branch_length(n) if parent else 0.0
            out.append((n, g.length, g.num_sequences, parent, float(bl)))
        return out


def get_max_lod_query_length(handle: Handle) -> int:
    """halGetMaxLODQueryLength."""
    with _lock:
        if handle.lod is None or not handle.lod.levels:
            return 2 ** 62
        return 2 ** 62

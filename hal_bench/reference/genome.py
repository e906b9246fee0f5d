"""Frozen copy of hal_tpu_torch/genome.py for the benchmark's plain reference (numpy
only; the same code, imports pointing at hal_bench.reference).  It is the
yardstick: the port may change, this copy does not.

Columnar (structure-of-arrays) genome model — the heart of hal_tpu.

The reference models a genome as an object graph over HDF5/mmap storage
(Genome / Sequence / TopSegment / BottomSegment, see
reference api/inc/halGenome.h:33, halTopSegment.h:19,
halBottomSegment.h:19).  Here a genome is a handful of flat numpy arrays that
can be pushed to TPU HBM wholesale and traversed with batched gathers:

  tops (n_top segments, edges to the parent genome):
    top_start[n_top+1]      int64  genome coordinate of segment start; the
                                   sentinel row makes length = next-start
                                   (same trick as the reference's +1 rows,
                                   api/hdf5_impl/hdf5Genome.cpp:292)
    top_parent[n_top]       int64  index into parent's bottoms, NULL_INDEX if
                                   inserted (no homolog in parent)
    top_parent_reversed[n_top] uint8  orientation vs parent
    top_bottom_parse[n_top] int64  bottom segment containing this start
                                   (parse link down, halTopSegment.h:76-96)
    top_paralogy[n_top]     int64  next top segment in the paralogy ring
                                   (halTopSegment.h:55-75), NULL_INDEX if none

  bottoms (n_bot segments, edges to child genomes):
    bot_start[n_bot+1]      int64  (sentinel as above)
    bot_top_parse[n_bot]    int64  top segment containing this start
    bot_child[n_bot, n_children]          int64  per-child top index
    bot_child_reversed[n_bot, n_children] uint8

  sequences (chromosomes/scaffolds, concatenated into genome coordinates):
    seq_start[n_seq+1]      int64  genome coordinate of sequence start
    seq_top[n_seq+1]        int64  first top segment of the sequence
    seq_bot[n_seq+1]        int64  first bottom segment
    (sentinel rows mirror SEQIDX_ARRAY's n+1 rows,
     api/hdf5_impl/hdf5Sequence.cpp:25-45)

  dna: uint8 nibble-packed, 2 bases/byte (hal_tpu.dna; byte-compatible with
    the reference, api/inc/halCommon.h:183-196).  May be empty when DNA is
    not stored (LOD alignments, halGenome.h:53-57).

Segment *length* is never stored: segments tile the genome coordinate space
contiguously, so length = start[i+1] - start[i] (the reference derives it the
same way for tops, api/mmap_impl/mmapGenome.h:206).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from hal_bench.reference.constants import NULL_INDEX
from hal_bench.reference import dna as dnacodec


@dataclass
class SequenceInfo:
    """Dimension record for creating a sequence (reference Sequence::Info,
    api/inc/halSequence.h:40-60)."""

    name: str
    length: int
    num_top_segments: int = 0
    num_bottom_segments: int = 0


@dataclass
class GenomeArrays:
    name: str

    # sequences
    seq_names: list[str] = field(default_factory=list)
    seq_start: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    seq_top: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    seq_bot: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))

    # top segments
    top_start: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    top_parent: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    top_parent_reversed: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    top_bottom_parse: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    top_paralogy: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    # bottom segments
    bot_start: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    bot_top_parse: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    bot_child: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.int64))
    bot_child_reversed: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.uint8))

    # packed DNA (may be size 0 when DNA is not stored)
    dna: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))

    metadata: dict[str, str] = field(default_factory=dict)

    # ------------------------------------------------------------ dimensions
    @property
    def length(self) -> int:
        """Total genome length (sum of sequence lengths)."""
        return int(self.seq_start[-1])

    @property
    def num_sequences(self) -> int:
        return len(self.seq_names)

    @property
    def num_top_segments(self) -> int:
        return len(self.top_parent)

    @property
    def num_bottom_segments(self) -> int:
        return len(self.bot_top_parse)

    @property
    def num_children(self) -> int:
        return self.bot_child.shape[1]

    @property
    def has_dna(self) -> bool:
        return self.dna.size > 0 or self.length == 0

    # -------------------------------------------------------------- factory
    @classmethod
    def create(
        cls,
        name: str,
        sequences: list[SequenceInfo],
        num_children: int = 0,
        store_dna: bool = True,
    ) -> "GenomeArrays":
        """Allocate a genome from dimension records (reference
        Genome::setDimensions, api/inc/halGenome.h:47-57).

        Segment starts are initialized so the validator will reject the genome
        until the importer fills them in (all zeros except the sentinel).
        """
        g = cls(name=name)
        n_seq = len(sequences)
        g.seq_names = [s.name for s in sequences]
        g.seq_start = np.zeros(n_seq + 1, np.int64)
        g.seq_top = np.zeros(n_seq + 1, np.int64)
        g.seq_bot = np.zeros(n_seq + 1, np.int64)
        np.cumsum([s.length for s in sequences], out=g.seq_start[1:])
        np.cumsum([s.num_top_segments for s in sequences], out=g.seq_top[1:])
        np.cumsum([s.num_bottom_segments for s in sequences], out=g.seq_bot[1:])
        n_top = int(g.seq_top[-1])
        n_bot = int(g.seq_bot[-1])
        total = int(g.seq_start[-1])

        g.top_start = np.zeros(n_top + 1, np.int64)
        g.top_start[-1] = total
        g.top_parent = np.full(n_top, NULL_INDEX, np.int64)
        g.top_parent_reversed = np.zeros(n_top, np.uint8)
        g.top_bottom_parse = np.full(n_top, NULL_INDEX, np.int64)
        g.top_paralogy = np.full(n_top, NULL_INDEX, np.int64)

        g.bot_start = np.zeros(n_bot + 1, np.int64)
        g.bot_start[-1] = total
        g.bot_top_parse = np.full(n_bot, NULL_INDEX, np.int64)
        g.bot_child = np.full((n_bot, num_children), NULL_INDEX, np.int64)
        g.bot_child_reversed = np.zeros((n_bot, num_children), np.uint8)

        if store_dna:
            g.dna = np.zeros((total + 1) // 2, np.uint8)
        else:
            g.dna = np.zeros(0, np.uint8)
        return g

    # ------------------------------------------------------------- segments
    def top_length(self, i) -> np.ndarray:
        return self.top_start[np.asarray(i) + 1] - self.top_start[i]

    def bot_length(self, i) -> np.ndarray:
        return self.bot_start[np.asarray(i) + 1] - self.bot_start[i]

    def top_index_at(self, pos) -> np.ndarray:
        """Top segment covering genome position(s) `pos` — vectorized toSite
        (reference SegmentIterator::toSite binary search,
        api/impl/halSegmentIterator.cpp)."""
        return np.searchsorted(self.top_start, np.asarray(pos), side="right") - 1

    def bot_index_at(self, pos) -> np.ndarray:
        return np.searchsorted(self.bot_start, np.asarray(pos), side="right") - 1

    def seq_index_at(self, pos) -> np.ndarray:
        """Sequence covering genome position(s) — replaces the mmap driver's
        site BST (api/mmap_impl/mmapGenomeSiteMap.h) with searchsorted."""
        return np.searchsorted(self.seq_start, np.asarray(pos), side="right") - 1

    def sequence_index(self, name: str) -> int:
        try:
            return self.seq_names.index(name)
        except ValueError:
            raise KeyError("sequence %s not found in genome %s" % (name, self.name))

    def seq_length(self, i: int) -> int:
        return int(self.seq_start[i + 1] - self.seq_start[i])

    # ------------------------------------------------------------------ DNA
    def get_dna(self, start: int, length: int, reversed_: bool = False) -> np.ndarray:
        """ASCII uint8 bases for [start, start+length); reverse-complemented
        if reversed_ (reference DnaIterator, api/inc/halDnaIterator.h)."""
        if not self.has_dna:
            raise ValueError("genome %s does not store DNA" % self.name)
        s = dnacodec.unpack_dna(self.dna, int(start), int(length))
        if reversed_:
            s = dnacodec.reverse_complement(s)
        return s

    def get_dna_string(self, start: int, length: int, reversed_: bool = False) -> str:
        return self.get_dna(start, length, reversed_).tobytes().decode()

    def set_dna(self, start: int, seq) -> None:
        dnacodec.write_dna(self.dna, int(start), seq)

    # ------------------------------------------------------------ utilities
    def validate_shapes(self) -> None:
        n_top, n_bot, n_seq = self.num_top_segments, self.num_bottom_segments, self.num_sequences
        assert self.top_start.shape == (n_top + 1,)
        assert self.top_parent_reversed.shape == (n_top,)
        assert self.top_bottom_parse.shape == (n_top,)
        assert self.top_paralogy.shape == (n_top,)
        assert self.bot_start.shape == (n_bot + 1,)
        assert self.bot_child.shape[0] == n_bot
        assert self.bot_child_reversed.shape == self.bot_child.shape
        assert self.seq_start.shape == (n_seq + 1,)
        assert self.seq_top.shape == (n_seq + 1,)
        assert self.seq_bot.shape == (n_seq + 1,)
        if self.dna.size:
            assert self.dna.shape == ((self.length + 1) // 2,)

    def base_composition(self) -> dict[str, float]:
        """Fraction of a/c/g/t (case-insensitive) — reference halStats
        --baseComp (stats/impl/halStats.cpp)."""
        if self.length == 0:
            return {b: 0.0 for b in "acgt"}
        s = dnacodec.unpack_dna(self.dna, 0, self.length)
        up = np.where((s >= 97) & (s <= 122), s - 32, s)
        total = max(self.length, 1)
        return {b: float(np.count_nonzero(up == ord(b.upper())) / total) for b in "acgt"}

    def copy(self) -> "GenomeArrays":
        g = GenomeArrays(name=self.name)
        g.seq_names = list(self.seq_names)
        for f in (
            "seq_start", "seq_top", "seq_bot", "top_start", "top_parent",
            "top_parent_reversed", "top_bottom_parse", "top_paralogy",
            "bot_start", "bot_top_parse", "bot_child", "bot_child_reversed", "dna",
        ):
            setattr(g, f, np.array(getattr(self, f), copy=True))
        g.metadata = dict(self.metadata)
        return g

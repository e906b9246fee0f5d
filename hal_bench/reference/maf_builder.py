"""Frozen copy of hal_tpu_torch/io/maf_io.py for the benchmark's plain reference (numpy
only; the same code, imports pointing at hal_bench.reference).  It is the
yardstick: the port may change, this copy does not.

MAF writing: block builder reproducing the reference's MafBlock rules
(maf/impl/halMafBlock.cpp; entry format :452-456, block print :499-519,
append/break logic :294-450) over the column engine's atomic slices, plus a
MAF reader for maf2hal (maf/inc/halMafScanner.h model).

The builder is a faithful port of the reference's entry state machine:

* entries live in a multimap ordered by SequenceLess (genome name, then
  sequence array index — halColumnIterator.h:45-50) and PERSIST across
  blocks; an entry unused for >10 consecutive block resets is dropped
  (resetEntries, halMafBlock.cpp:36-79);
* the d-th duplicate row of a sequence in a column maps onto the d-th
  entry of that sequence (cursor walk in initBlock/appendColumn/
  canAppendColumn, halMafBlock.cpp:294-450);
* a column can be appended iff every row lands on an existing entry
  contiguously on the same strand and under the max block length; rows
  that disappear mid-block are padded with '-' (updateEntry NULL branch,
  halMafBlock.cpp:129-131);
* printing emits the reference entry first (printBlock :499-519), with
  the _refIndex fallback when the reference sequence had no base in the
  block's first column.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field

import numpy as np

from hal_bench.reference import dna as dnacodec
from hal_bench.reference.alignment import Alignment
from hal_bench.reference.column_exact import Row, Slice

# reference MafBlock::defaultMaxLength (maf/impl/halMafBlock.cpp:16)
DEFAULT_MAX_BLOCK_LEN = 1000


@dataclass
class _Entry:
    key: tuple          # (genome name, seq array index) — SequenceLess
    name: str
    genome: str
    seq_idx: int
    src_length: int
    start: int = -1     # strand coords; -1 == NULL (no DNA yet in block)
    length: int = 0
    strand: str = "+"
    text: list = field(default_factory=list)
    last_used: int = 0


class MafBlockBuilder:
    """Streams slices; emits MAF block strings."""

    def __init__(self, aln: Alignment, ref: str, max_block_len: int = DEFAULT_MAX_BLOCK_LEN,
                 ucsc_names: bool = False, print_tree: bool = False,
                 keep_empty_ref_blocks: bool = True):
        self.aln = aln
        self.ref = ref
        self.max_len = max_block_len or DEFAULT_MAX_BLOCK_LEN
        self.ucsc_names = ucsc_names
        self.print_tree = print_tree
        self.keep_empty_ref_blocks = keep_empty_ref_blocks
        self.entries: list[_Entry] = []
        self.reference: _Entry | None = None
        self.ref_index: int | None = None
        self.tree = None            # block gene tree (--printTree)
        self._row_entries: list[_Entry] = []
        self._genomes = {}
        self._ascii_cache = {}
        self._seq_cache = {}

    # whole-genome ASCII DNA caches are built lazily up to this size; the
    # per-call unpack path (10us of numpy overhead per tiny row) dominates
    # block building otherwise
    _ASCII_CACHE_LIMIT = 1 << 28

    def _g(self, name):
        if name not in self._genomes:
            self._genomes[name] = self.aln.open_genome(name)
        return self._genomes[name]

    def _ascii(self, name):
        """Lazily cached whole-genome ASCII bases (None if too large)."""
        if name not in self._ascii_cache:
            g = self._g(name)
            self._ascii_cache[name] = (
                dnacodec.unpack_dna(g.dna, 0, g.length)
                if g.has_dna and g.length <= self._ASCII_CACHE_LIMIT else None)
        return self._ascii_cache[name]

    def _seqs(self, name):
        """(seq_start list, seq_length list) for fast scalar lookups."""
        t = self._seq_cache.get(name)
        if t is None:
            g = self._g(name)
            ss = g.seq_start.tolist()
            t = (ss, [ss[i + 1] - ss[i] for i in range(len(ss) - 1)])
            self._seq_cache[name] = t
        return t

    def _name(self, genome, seq_idx):
        g = self._g(genome)
        if self.ucsc_names:
            return "%s.%s" % (genome, g.seq_names[seq_idx])
        return g.seq_names[seq_idx]

    def _row_start_strand(self, row: Row) -> tuple[int, int]:
        """(strand-coords start, srcLength) of the row's first column."""
        starts, lengths = self._seqs(row.genome)
        seq_start = starts[row.seq_idx]
        src_len = lengths[row.seq_idx]
        if row.rev:
            start = src_len - 1 - (row.tgt_hi - 1 - seq_start)
        else:
            start = row.tgt_lo - seq_start
        return start, src_len

    def _row_text(self, row: Row) -> str:
        a = self._ascii(row.genome)
        if a is None:
            return self._g(row.genome).get_dna_string(
                row.tgt_lo, row.tgt_hi - row.tgt_lo, reversed_=row.rev)
        chunk = a[row.tgt_lo:row.tgt_hi]
        if row.rev:
            chunk = dnacodec.reverse_complement(chunk)
        return chunk.tobytes().decode()

    @staticmethod
    def _sorted_rows(sl: Slice) -> list[Row]:
        """SequenceLess order; stable, so duplicate rows keep their column
        insertion (DFS) order — this is the multimap iteration order."""
        if sl.sorted_rows:
            return sl.rows
        return sorted(sl.rows, key=lambda r: (r.genome, r.seq_idx))

    # ---------------------------------------------------------- printTree
    def _slice_tree(self, sl: Slice):
        """Gene tree of the slice's first column with labels/entry matches
        (reference buildTree + getTreeNode, halMafBlock.cpp:160-293)."""
        from hal_bench.reference.column_exact import build_gene_tree

        r0 = sl.rows[0]
        pos0 = (r0.tgt_hi - 1) if r0.rev else r0.tgt_lo
        tree = build_gene_tree(self.aln, r0.genome, pos0)
        keys = {}
        for i, r in enumerate(self._sorted_rows(sl)):
            p = (r.tgt_hi - 1) if r.rev else r.tgt_lo
            keys[(r.genome, r.seq_idx, p)] = i
        def label(node):
            g, si, p, _rev = node.row_key
            i = keys.get((g, si, p))
            if i is None:
                node.label = g
                node.row_key = None
            else:
                node.label = self._name(g, si)
                node.row_key = ("entry", i)
            for c in node.children:
                label(c)
        label(tree)
        return tree

    # ------------------------------------------------------ entry machine
    def _reset_entries(self) -> None:
        """resetEntries (halMafBlock.cpp:36-79)."""
        kept = []
        for e in self.entries:
            if e.start == -1:
                if e.last_used > 10:
                    continue
                e.last_used += 1
            else:
                e.last_used = 0
            e.start = -1
            e.strand = "+"
            e.length = 0
            e.text = []
            kept.append(e)
        self.entries = kept
        self.reference = None
        self.ref_index = None

    def _init_block(self, sl: Slice) -> None:
        """initBlock (halMafBlock.cpp:294-368)."""
        self._reset_entries()
        rows = self._sorted_rows(sl)
        self._row_entries = []
        keys = [e.key for e in self.entries]
        used: dict[tuple, int] = {}
        from bisect import bisect_left

        for row in rows:
            key = (row.genome, row.seq_idx)
            d = used.get(key, 0)
            used[key] = d + 1
            base = bisect_left(keys, key)
            idx = base + d
            if idx >= len(keys) or keys[idx] != key:
                idx = None
            start, src_len = self._row_start_strand(row)
            if idx is None:
                entry = _Entry(key=key, name=self._name(row.genome, row.seq_idx),
                               genome=row.genome, seq_idx=row.seq_idx,
                               src_length=src_len)
                ins = bisect_right(keys, key)
                self.entries.insert(ins, entry)
                keys.insert(ins, key)
            else:
                entry = self.entries[idx]
            entry.start = start
            entry.strand = "-" if row.rev else "+"
            entry.length = 0
            entry.text = []
            self._row_entries.append(entry)

        # _reference selection (halMafBlock.cpp:353-363)
        ref_seq_idx = None
        if sl.rows:
            rg = self._g(self.ref)
            pos = sl.lo
            ref_seq_idx = int(np.searchsorted(rg.seq_start, pos, side="right")) - 1
        ref_key = (self.ref, ref_seq_idx)
        self.reference = None
        for e in self.entries:
            if e.key == ref_key:
                self.reference = e
                starts, _ = self._seqs(self.ref)
                self.ref_index = sl.lo - starts[ref_seq_idx]
                break
        if self.reference is None and self.entries:
            self.reference = self.entries[0]
            self.ref_index = None

        self.tree = (self._slice_tree(sl) if self.print_tree and sl.rows
                     else None)

    def _can_append(self, sl: Slice) -> bool:
        """canAppendColumn at slice granularity (halMafBlock.cpp:401-450)."""
        if self.print_tree and self.tree is not None:
            if not sl.rows or not self._slice_tree(sl).same_shape(self.tree):
                return False
        e = 0
        for row in self._sorted_rows(sl):
            key = (row.genome, row.seq_idx)
            while e < len(self.entries) and self.entries[e].key != key:
                e += 1
            if e >= len(self.entries):
                return False
            entry = self.entries[e]
            if entry.start != -1:
                if entry.length >= self.max_len:
                    return False
                if entry.length > 0 and (entry.strand == "-") != row.rev:
                    return False
                start, _ = self._row_start_strand(row)
                if start - entry.start != entry.length:
                    return False
            e += 1
        return True

    def _append_budget(self, sl: Slice) -> int:
        """Columns appendable before some row's entry hits max_len (the
        per-column `_length >= _maxLength` check, halMafBlock.cpp:426)."""
        budget = self.max_len
        e = 0
        for row in self._sorted_rows(sl):
            key = (row.genome, row.seq_idx)
            while e < len(self.entries) and self.entries[e].key != key:
                e += 1
            if e < len(self.entries):
                budget = min(budget, self.max_len - self.entries[e].length)
                e += 1
        return budget

    def _append(self, sl: Slice) -> None:
        """appendColumn for a whole run (halMafBlock.cpp:370-395)."""
        n = sl.width
        pad = "-" * n
        e = 0
        self._row_entries = []
        for row in self._sorted_rows(sl):
            key = (row.genome, row.seq_idx)
            while e < len(self.entries) and self.entries[e].key != key:
                self.entries[e].text.append(pad)
                e += 1
            entry = self.entries[e]
            if entry.start == -1:
                # late joiner: initEntry(..., clearSequence=false) keeps the
                # '-' padding accumulated so far (halMafBlock.cpp:109-113)
                start, _ = self._row_start_strand(row)
                entry.start = start
                entry.strand = "-" if row.rev else "+"
            entry.length += n
            entry.text.append(self._row_text(row))
            self._row_entries.append(entry)
            e += 1
        for k in range(e, len(self.entries)):
            self.entries[k].text.append(pad)

    def _entry_line(self, e: _Entry, start=None) -> str:
        return "s\t%s\t%d\t%d\t%s\t%d\t%s\n" % (
            e.name, e.start if start is None else start, e.length, e.strand,
            e.src_length, "".join(e.text))

    def _flush(self) -> str | None:
        """printBlock (halMafBlock.cpp:499-519) + the all-gaps-reference
        suppression from MafExport (halMafExport.cpp:73-75)."""
        ref = self.reference
        if ref is None:
            return None
        if not self.keep_empty_ref_blocks:
            text = "".join(ref.text)
            if all(c == "-" for c in text):
                return None
        if self.print_tree and self.tree is not None:
            return self._flush_with_tree()
        out = ["a\n"]
        if ref.start == -1:
            if self.ref_index is not None:
                out.append(self._entry_line(ref, start=self.ref_index))
        else:
            out.append(self._entry_line(ref))
        for e in self.entries:
            if e.start != -1 and e is not ref:
                out.append(self._entry_line(e))
        return "".join(out)

    def _flush_with_tree(self) -> str:
        """printBlockWithTree (halMafBlock.cpp:485-497): reference-first
        child ordering, 'a tree=...' header, s-lines in tree post-order."""
        def find_ref(node, path):
            if node.row_key and node.row_key[0] == "entry":
                e = self._row_entries[node.row_key[1]]
                if e is self.reference:
                    return path + [node]
            for c in node.children:
                r = find_ref(c, path + [node])
                if r:
                    return r
            return None
        path = find_ref(self.tree, [])
        if path:
            # bring the reference's node to child slot 0 along its path
            for parent, child in zip(path, path[1:]):
                i = parent.children.index(child)
                parent.children[0], parent.children[i] = (
                    parent.children[i], parent.children[0])
        out = ['a tree="%s;"\n' % self.tree.newick()]
        emitted = set()
        def emit(node):
            for c in node.children:
                emit(c)
            if node.row_key and node.row_key[0] == "entry":
                e = self._row_entries[node.row_key[1]]
                if e.start != -1 and id(e) not in emitted:
                    emitted.add(id(e))
                    out.append(self._entry_line(e))
        emit(self.tree)
        for e in self.entries:
            if e.start != -1 and id(e) not in emitted:
                out.append(self._entry_line(e))
        return "".join(out)

    @staticmethod
    def _split_slice(sl: Slice, k: int) -> tuple[Slice, Slice]:
        """Cut a slice after k columns (maxBlockLen break mid-run)."""
        mid = sl.lo if sl.lo == sl.hi else sl.lo + k
        left_rows, right_rows = [], []
        for r in sl.rows:
            if r.rev:
                left_rows.append(Row(r.genome, r.seq_idx, r.tgt_hi - k, r.tgt_hi, True, r.is_ref))
                right_rows.append(Row(r.genome, r.seq_idx, r.tgt_lo, r.tgt_hi - k, True, r.is_ref))
            else:
                left_rows.append(Row(r.genome, r.seq_idx, r.tgt_lo, r.tgt_lo + k, False, r.is_ref))
                right_rows.append(Row(r.genome, r.seq_idx, r.tgt_lo + k, r.tgt_hi, False, r.is_ref))
        return (Slice(sl.lo, mid, left_rows, width=k,
                      sorted_rows=sl.sorted_rows),
                Slice(mid, sl.hi, right_rows, width=sl.width - k,
                      sorted_rows=sl.sorted_rows))

    def feed(self, slices):
        """Consume slices, yielding finished MAF block strings."""
        started = self.reference is not None and any(
            e.start != -1 for e in self.entries)
        for sl in slices:
            while sl is not None:
                if not started:
                    self._init_block(sl)
                    started = True
                elif not self._can_append(sl):
                    block = self._flush()
                    if block:
                        yield block
                    self._init_block(sl)
                budget = self._append_budget(sl)
                rest = None
                if sl.width > budget:
                    sl, rest = self._split_slice(sl, budget)
                self._append(sl)
                if rest is not None:
                    block = self._flush()
                    if block:
                        yield block
                    started = False
                sl = rest

    def flush_end(self):
        """End-of-scan flush (convertSequence tail, halMafExport.cpp:85-88)."""
        if any(e.start != -1 for e in self.entries):
            block = self._flush()
            self._reset_entries()
            if block:
                return block
        return None


def write_header(stream, aln: Alignment) -> None:
    """reference MafExport::writeHeader (halMafExport.cpp:15-23)."""
    stream.write("##maf version=1 scoring=N/A\n# hal %s\n\n" % aln.get_newick_tree())


# --------------------------------------------------------------------- read

@dataclass
class MafSeqLine:
    src: str
    start: int
    size: int
    strand: str
    src_size: int
    text: str


def read_maf_blocks(stream):
    """Yield lists of MafSeqLine per alignment block (maf2hal's scanner model,
    maf/inc/halMafScanner.h:23-50)."""
    block: list[MafSeqLine] = []
    for line in stream:
        line = line.strip()
        if not line or line.startswith("#"):
            if block:
                yield block
                block = []
            continue
        if line.startswith("a"):
            if block:
                yield block
                block = []
            continue
        if line.startswith("s"):
            parts = line.split()
            if len(parts) != 7:
                raise ValueError("bad MAF s-line: " + line)
            block.append(MafSeqLine(parts[1], int(parts[2]), int(parts[3]),
                                    parts[4], int(parts[5]), parts[6]))
    if block:
        yield block

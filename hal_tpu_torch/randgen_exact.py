"""Port copy of hal_tpu/randgen_exact.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

Bit-exact reimplementation of the reference's random-alignment generator.

The reference's golden test fixtures are all produced by
`halRandGen --preset <p> --seed 0 --testRand` (liftover/Makefile:67,
maf/Makefile:78-84, synteny/Makefile:27-29, blockViz/Makefile:61-67).
Despite the flag, halRandGen constructs its RNG with testMode=false
(randgen/halRandGen.cpp:110), so the actual stream is std::mt19937(seed)
drawn through libstdc++'s std::uniform_real_distribution<double>
(api/tests/halRandNumberGen.h:62-68).  Reproducing the fixtures therefore
needs three things, all replicated here bit-for-bit:

1. mt19937 with init_genrand seeding (standard, vectorized twist below);
2. generate_canonical<double>: ret = (g0 + g1*2^32) / 2^64 with g0 drawn
   first, IEEE round-to-nearest (same as numpy float64 arithmetic);
3. the exact draw ORDER of createRandomAlignment
   (api/tests/halRandomData.cpp): BFS tree build, BFS dimension pass,
   BFS content pass with the per-segment case analysis of
   createRandomSegment (halRandomData.cpp:268-346) — including its quirks:
   * getRandDouble returns *int* (halRandNumberGen.h:74-81), so every
     branch length truncates to 0, making every exponEvent compare
     getRand() <= 0.0;
   * the minGenomes clamp sets numChildren = minGenomes, not
     minGenomes - count (halRandomData.cpp:111-113);
   * C++ short-circuit evaluation determines how many draws each
     segment consumes.

Draw-heavy inner loops (DNA fills, mutateString) are vectorized over a
buffered word stream while preserving exact consumption order.
"""

from __future__ import annotations

import math

import numpy as np

from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.genome import GenomeArrays, SequenceInfo

_DNA = np.frombuffer(b"ACGT", dtype=np.uint8)

# RandOptions presets (randgen/halRandGen.cpp:34-37): meanDegree,
# maxBranchLength, minGenomes, maxGenomes, minSegmentLength,
# maxSegmentLength, minSegments, maxSegments
REF_PRESETS = {
    "small": (0.75, 0.1, 2, 5, 250, 1000, 5, 10),
    "medium": (1.25, 0.7, 8, 20, 500, 2000, 100, 500),
    "big": (2.00, 0.7, 20, 50, 1000, 8000, 400, 5000),
    "large": (2.00, 1.0, 50, 100, 5000, 10000, 10000, 50000),
}

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)
_TWO32 = 4294967296.0
_TWO64 = 18446744073709551616.0


class MT19937:
    """std::mt19937 with init_genrand seeding; vectorized block twist."""

    def __init__(self, seed: int):
        mt = np.empty(_N, np.uint32)
        prev = seed & 0xFFFFFFFF
        mt[0] = prev
        for i in range(1, _N):
            prev = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF
            mt[i] = prev
        self._mt = mt

    def next_block(self) -> np.ndarray:
        """Twist once and return all 624 tempered outputs."""
        mt = self._mt
        # the twist reads values produced earlier in the same pass for
        # i >= 227, so process in dependency-safe chunks
        for lo, hi in ((0, _N - _M), (_N - _M, 2 * (_N - _M)), (2 * (_N - _M), _N - 1)):
            y = (mt[lo:hi] & _UPPER) | (mt[lo + 1:hi + 1] & _LOWER)
            mag = np.where((y & np.uint32(1)).astype(bool), _MATRIX_A, np.uint32(0))
            mt[lo:hi] = mt[(lo + _M) % _N:(lo + _M) % _N + (hi - lo)] ^ (y >> np.uint32(1)) ^ mag
        y = (mt[_N - 1] & _UPPER) | (mt[0] & _LOWER)
        mag = _MATRIX_A if (int(y) & 1) else np.uint32(0)
        mt[_N - 1] = mt[_M - 1] ^ (y >> np.uint32(1)) ^ mag
        # temper
        y = mt.copy()
        y ^= y >> np.uint32(11)
        y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
        y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
        y ^= y >> np.uint32(18)
        return y


class RefRng:
    """RandNumberGen in non-test mode (halRandNumberGen.h:45-106) over a
    buffered mt19937 word stream with peek/consume so vectorized consumers
    preserve the exact scalar draw order."""

    def __init__(self, seed: int):
        self._gen = MT19937(seed)
        self._buf = np.zeros(0, np.uint32)
        self._pos = 0

    def _ensure_words(self, n: int) -> None:
        avail = len(self._buf) - self._pos
        if avail >= n:
            return
        blocks = [self._buf[self._pos:]]
        need = n - avail
        while need > 0:
            b = self._gen.next_block()
            blocks.append(b)
            need -= len(b)
        self._buf = np.concatenate(blocks)
        self._pos = 0

    def peek_doubles(self, n: int) -> np.ndarray:
        """Next n canonical doubles without consuming (2 words each)."""
        self._ensure_words(2 * n)
        w = self._buf[self._pos:self._pos + 2 * n]
        lo = w[0::2].astype(np.float64)
        hi = w[1::2].astype(np.float64)
        return (lo + hi * _TWO32) / _TWO64

    def consume_doubles(self, n: int) -> None:
        self._pos += 2 * n

    def get_rand(self) -> float:
        d = float(self.peek_doubles(1)[0])
        self.consume_doubles(1)
        return d

    def get_rand_doubles(self, n: int) -> np.ndarray:
        d = self.peek_doubles(n)
        self.consume_doubles(n)
        return d

    def get_rand_double_as_int(self, min_val: float, max_val: float) -> int:
        """getRandDouble — declared double-range but returns int
        (halRandNumberGen.h:74-81): truncation toward zero."""
        if max_val < min_val:
            max_val = min_val
        return int(self.get_rand() * (max_val - min_val) + min_val)

    def get_rand_int(self, min_val: int, max_val: int) -> int:
        """Round-half-up integer draw (halRandNumberGen.h:86-98)."""
        if max_val < min_val:
            max_val = min_val
        rnum = self.get_rand() * float(max_val - min_val)
        frac = rnum - math.floor(rnum)
        if frac >= 0.5:
            return min_val + int(math.ceil(rnum))
        return min_val + int(math.floor(rnum))

    def expon_event(self, mu: float) -> bool:
        """exponEvent (halRandomData.cpp:18-20): one draw."""
        return self.get_rand() <= (1.0 - math.exp(-mu))

    def rand_dna(self) -> int:
        """randDNA (halRandomData.cpp:22-34): one getRandInt(0,3) draw."""
        return int(_DNA[self.get_rand_int(0, 3)])

    def rand_dna_many(self, n: int) -> np.ndarray:
        """n consecutive randDNA draws, vectorized."""
        rnum = self.get_rand_doubles(n) * 3.0
        fl = np.floor(rnum)
        idx = np.where(rnum - fl >= 0.5, np.ceil(rnum), fl).astype(np.int64)
        return _DNA[idx]


# ------------------------------------------------------------------- phases

def _create_random_tree(rng: RefRng, aln: Alignment, mean_degree: float,
                        max_branch_length: float, min_genomes: int,
                        max_genomes: int) -> None:
    """createRandomTree (halRandomData.cpp:122-136): BFS via a deque used
    as push_front/pop_back — i.e. FIFO over creation order."""
    aln.add_root_genome("Genome_0")
    queue = ["Genome_0"]
    count = 1
    while queue:
        name = queue.pop(0)
        # (hal_size_t)(getRandDouble(0, 2*meanDegree) + 0.5): getRandDouble
        # already truncated to int, so +0.5 is a no-op (halRandomData.cpp:107)
        n_children = rng.get_rand_double_as_int(0.0, 2.0 * mean_degree)
        if count + n_children >= max_genomes:
            n_children = max_genomes - count
        if count + n_children < min_genomes:
            n_children = min_genomes  # sic — not min_genomes - count
        for _ in range(n_children):
            child = "Genome_%d" % count
            count += 1
            bl = rng.get_rand_double_as_int(1e-5, max_branch_length)
            aln.add_leaf_genome(child, name, float(bl))
            queue.append(child)


def _create_random_dimensions(rng: RefRng, aln: Alignment,
                              min_seg_len: int, max_seg_len: int,
                              min_segs: int, max_segs: int) -> dict:
    """createRandomDimensions (halRandomData.cpp:152-226), BFS order."""
    dims = {}
    queue = [aln.root_name]
    while queue:
        name = queue.pop(0)
        parent = aln.tree.parent(name)
        bot_size = rng.get_rand_int(min_seg_len, max_seg_len)
        n_bot = rng.get_rand_int(min_segs, max_segs)
        length = n_bot * bot_size
        top_size = dims[parent]["bot_size"] if parent else 0
        n_top = 0
        if parent:
            n_top = length // top_size + (1 if length % top_size else 0)
        children = aln.tree.children(name)
        if not children:
            n_bot = 0
        if n_bot == 0 and n_top == 0:
            length = 0
        d = dict(length=length, bot_size=bot_size, n_bot=n_bot,
                 top_size=top_size, n_top=n_top, n_children=len(children))
        dims[name] = d

        g = GenomeArrays.create(
            name,
            [SequenceInfo(name + "_seq", length, n_top, n_bot)] if length else [],
            num_children=len(children),
        )
        if n_bot:
            g.bot_start[:-1] = np.arange(n_bot, dtype=np.int64) * bot_size
            if n_top:
                g.bot_top_parse = (np.arange(n_bot, dtype=np.int64) * bot_size) // top_size
            else:
                g.bot_top_parse = np.full(n_bot, NULL_INDEX, np.int64)
        if n_top:
            g.top_start[:-1] = np.arange(n_top, dtype=np.int64) * top_size
            if n_bot:
                g.top_bottom_parse = (np.arange(n_top, dtype=np.int64) * top_size) // bot_size
            else:
                g.top_bottom_parse = np.full(n_top, NULL_INDEX, np.int64)
        aln.set_genome(g)
        queue.extend(children)
    return dims


def _mutate_string(rng: RefRng, buf: np.ndarray, mu: float) -> None:
    """mutateString (halRandomData.cpp:36-42) with exact draw order: one
    exponEvent draw per base, plus one randDNA draw per hit.  Vectorized
    between hits (with truncated branch lengths, mu is always 0 and the
    fast path is a single block consume)."""
    thresh = 1.0 - math.exp(-mu)
    n = len(buf)
    i = 0
    while i < n:
        d = rng.peek_doubles(n - i)
        hits = np.flatnonzero(d <= thresh)
        if len(hits) == 0:
            rng.consume_doubles(n - i)
            return
        first = int(hits[0])
        rng.consume_doubles(first + 1)
        buf[i + first] = rng.rand_dna()
        i += first + 1


def _create_genome_content(rng: RefRng, aln: Alignment, name: str, dims: dict) -> None:
    """createRandomGenome / createRandomSegment (halRandomData.cpp:228-346)."""
    d = dims[name]
    g = aln.open_genome(name)
    parent_name = aln.tree.parent(name)
    if parent_name is None:
        if d["length"]:
            g.set_dna(0, rng.rand_dna_many(d["length"]))
        return

    pg = aln.open_genome(parent_name)
    slot = aln.tree.child_index(parent_name, name)
    bl = aln.tree.branch_length(name)
    n_top = d["n_top"]
    n_bot = pg.num_bottom_segments
    out = np.empty(d["length"], np.uint8)
    edge_set: dict[int, list[int]] = {}

    for i in range(n_top):
        seg_start = int(g.top_start[i])
        seg_len = int(g.top_start[i + 1]) - seg_start

        # case 1: parent index same as child index
        parent_idx = i
        # case 2: random parent (transposition/duplication); C++ short-circuit
        if parent_idx >= n_bot or rng.expon_event(bl):
            parent_idx = rng.get_rand_int(0, n_bot - 1)
        # case 3: null parent (insertion)
        elif rng.expon_event(bl) and rng.expon_event(bl):
            parent_idx = NULL_INDEX
        # case 4: last segments have unknown pairing sizes
        if parent_idx == n_bot - 1 or i == n_top - 1:
            parent_idx = NULL_INDEX

        g.top_parent[i] = parent_idx
        g.top_parent_reversed[i] = 0
        g.top_paralogy[i] = NULL_INDEX

        if parent_idx == NULL_INDEX:
            out[seg_start:seg_start + seg_len] = rng.rand_dna_many(seg_len)
        else:
            reversed_ = rng.expon_event(bl)
            g.top_parent_reversed[i] = 1 if reversed_ else 0
            buf = pg.get_dna(int(pg.bot_start[parent_idx]), seg_len, reversed_=reversed_)
            buf = np.array(buf, copy=True)
            _mutate_string(rng, buf, bl)
            pg.bot_child[parent_idx, slot] = i
            pg.bot_child_reversed[parent_idx, slot] = 1 if reversed_ else 0
            ring = edge_set.get(parent_idx)
            if ring:
                g.top_paralogy[ring[-1]] = i
                g.top_paralogy[i] = ring[0]
                ring.append(i)
            else:
                edge_set[parent_idx] = [i]
            out[seg_start:seg_start + seg_len] = buf

    if d["length"]:
        g.set_dna(0, out)


def create_random_alignment_exact(
    seed: int = 0,
    mean_degree: float = 1.25,
    max_branch_length: float = 0.7,
    min_genomes: int = 8,
    max_genomes: int = 20,
    min_segment_length: int = 500,
    max_segment_length: int = 2000,
    min_segments: int = 100,
    max_segments: int = 500,
) -> Alignment:
    """createRandomAlignment (halRandomData.cpp:62-100) with the exact
    mt19937(seed) stream of halRandGen (randgen/halRandGen.cpp:110).
    Defaults are the 'medium' preset."""
    rng = RefRng(seed if seed >= 0 else -1 & 0xFFFFFFFF)
    aln = Alignment()
    _create_random_tree(rng, aln, mean_degree, max_branch_length,
                        min_genomes, max_genomes)
    dims = _create_random_dimensions(rng, aln, min_segment_length,
                                     max_segment_length, min_segments,
                                     max_segments)
    queue = [aln.root_name]
    while queue:
        name = queue.pop(0)
        _create_genome_content(rng, aln, name, dims)
        queue.extend(aln.tree.children(name))
    return aln


def create_preset_alignment_exact(preset: str = "medium", seed: int = 0,
                                  **overrides) -> Alignment:
    """halRandGen CLI model: preset defaults + per-option overrides
    (randgen/halRandGen.cpp:64-95)."""
    p = REF_PRESETS[preset]
    kw = dict(
        mean_degree=p[0], max_branch_length=p[1], min_genomes=p[2],
        max_genomes=p[3], min_segment_length=p[4], max_segment_length=p[5],
        min_segments=p[6], max_segments=p[7],
    )
    kw.update(overrides)
    return create_random_alignment_exact(seed=seed, **kw)

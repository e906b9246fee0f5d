"""Port copy of hal_tpu/randgen.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

Random alignment generator — vectorized fixture machinery.

Implements the same *structural model* as the reference's test generator
(reference api/tests/halRandomData.cpp) and the halRandGen tool
(reference randgen/halRandGen.cpp), but built bottom-up with numpy:

* random tree with mean degree / max branch length,
* each genome = one sequence; uniform bottom-segment size per genome;
  a child's top-segment size equals its parent's bottom-segment size so
  homologous segments have equal length,
* per-branch Poisson-style events (prob 1-exp(-branchLength)):
  transposition/duplication (random parent index), insertion (no parent),
  inversion (reversed flag); deletions arise implicitly when no child top
  claims a parent bottom,
* paralogy rings link all child tops sharing a parent bottom; the parent's
  child index points at the *last* such top (matching the reference's
  last-writer-wins edgeSet behaviour, halRandomData.cpp:321),
* parse links are position-derived: bottom.topParse = start // topSegSize etc.
  (halRandomData.cpp:189-210),
* DNA: root uniform random ACGT; children copy the parent segment
  (reverse-complemented when inverted) with substitutions at rate
  1-exp(-branchLength); inserted segments get fresh random bases.

Determinism: numpy PCG64 — seeds reproduce across platforms, serving the
same role as the reference's portable RNG (api/tests/halRandNumberGen.h,
used by halRandGen --testRand).
"""

from __future__ import annotations

import numpy as np

from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch import dna as dnacodec
from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.genome import GenomeArrays

_DNA = np.frombuffer(b"ACGT", dtype=np.uint8)

# halRandGen presets (reference randgen/halRandGen.cpp:41-54)
PRESETS = {
    "small": dict(mean_degree=0.75, max_branch_length=0.1, max_genomes=5,
                  min_segment_length=10, max_segment_length=1000, max_segments=100),
    "medium": dict(mean_degree=1.25, max_branch_length=0.7, max_genomes=20,
                   min_segment_length=2, max_segment_length=50, max_segments=1000),
    "big": dict(mean_degree=2.0, max_branch_length=0.7, max_genomes=50,
                min_segment_length=2, max_segment_length=500, max_segments=10000),
    "large": dict(mean_degree=2.0, max_branch_length=1.0, max_genomes=100,
                  min_segment_length=2, max_segment_length=1000, max_segments=100000),
}


def _expon_mask(rng: np.random.Generator, mu: float, n: int) -> np.ndarray:
    """Vectorized exponEvent: True with prob 1-exp(-mu) per element."""
    return rng.random(n) <= (1.0 - np.exp(-mu))


def create_random_tree(
    rng: np.random.Generator,
    mean_degree: float = 1.0,
    max_branch_length: float = 1.0,
    min_genomes: int = 2,
    max_genomes: int = 10,
) -> Alignment:
    aln = Alignment()
    aln.add_root_genome("Genome_0")
    queue = ["Genome_0"]
    count = 1
    while queue:
        name = queue.pop(0)
        n_children = int(rng.uniform(0.0, 2.0 * mean_degree) + 0.5)
        if count + n_children >= max_genomes:
            n_children = max_genomes - count
        if count + n_children < min_genomes:
            n_children = min_genomes
        for _ in range(n_children):
            child = "Genome_%d" % count
            count += 1
            aln.add_leaf_genome(child, name, float(rng.uniform(1e-5, max_branch_length)))
            queue.append(child)
    return aln


def create_random_dimensions(
    rng: np.random.Generator,
    aln: Alignment,
    min_segment_length: int = 2,
    max_segment_length: int = 10,
    min_segments: int = 1,
    max_segments: int = 10,
) -> dict[str, dict]:
    """Pick per-genome sizes (preorder so a child knows its parent's bottom
    segment size).  Returns {genome: dims dict} used by create_random_genome."""
    dims: dict[str, dict] = {}
    for name in aln.tree.preorder():
        parent = aln.tree.parent(name)
        bot_size = int(rng.integers(min_segment_length, max_segment_length + 1))
        n_bot = int(rng.integers(min_segments, max_segments + 1))
        length = n_bot * bot_size
        top_size = dims[parent]["bot_size"] if parent else 0
        children = aln.tree.children(name)
        if not children:
            n_bot = 0
        if parent:
            n_top = length // top_size + (1 if length % top_size else 0)
        else:
            n_top = 0
        if n_bot == 0 and n_top == 0:
            length = 0
        dims[name] = dict(length=length, bot_size=bot_size, n_bot=n_bot,
                          top_size=top_size, n_top=n_top, n_children=len(children))
    return dims


def _alloc_genome(aln: Alignment, name: str, d: dict, store_dna: bool = True) -> GenomeArrays:
    from hal_tpu_torch.genome import SequenceInfo

    g = GenomeArrays.create(
        name,
        [SequenceInfo(name + "_seq", d["length"], d["n_top"], d["n_bot"])] if d["length"] else [],
        num_children=d["n_children"],
        store_dna=store_dna,
    )
    g.name = name
    n_top, n_bot = d["n_top"], d["n_bot"]
    top_size, bot_size, length = d["top_size"], d["bot_size"], d["length"]
    if n_top:
        g.top_start[:-1] = np.arange(n_top, dtype=np.int64) * top_size
        if n_bot:
            g.top_bottom_parse = (np.arange(n_top, dtype=np.int64) * top_size) // bot_size
    if n_bot:
        g.bot_start[:-1] = np.arange(n_bot, dtype=np.int64) * bot_size
        if n_top:
            g.bot_top_parse = (np.arange(n_bot, dtype=np.int64) * bot_size) // top_size
    return g


def _fill_dna_fast(rng, g, pg, parent_idx, reversed_, d, bl) -> None:
    """Vectorized DNA fill (chunked fancy-gather from the parent's ASCII
    bases) — same statistical model as the per-segment loop but a different
    RNG draw order, so only selectable via create_random_alignment(
    fast_dna=True).  Makes 100 Mb-per-genome DNA-bearing fixtures feasible
    for the hal2maf throughput benchmark (the loop is ~15 s per 500k
    segments; this is ~1 s per 134 Mb)."""
    from hal_tpu_torch.dna import COMP_MAP

    length = d["length"]
    ts = d["top_size"]
    n_top = d["n_top"]
    pa = dnacodec.unpack_dna(pg.dna, 0, pg.length)
    p_start = pg.bot_start
    sub_p = 1.0 - np.exp(-bl)
    out = np.empty(length, np.uint8)
    n_full = length // ts  # segments of exactly ts bases
    offr = np.arange(ts, dtype=np.int64)
    SEG_CH = max((1 << 23) // max(ts, 1), 1)
    for s0 in range(0, n_full, SEG_CH):
        s1 = min(s0 + SEG_CH, n_full)
        pi = parent_idx[s0:s1]
        mapped = pi != NULL_INDEX
        pic = np.where(mapped, pi, 0)
        rv = reversed_[s0:s1].astype(bool)
        base = np.where(rv, p_start[pic] + ts - 1, p_start[pic])
        step = np.where(rv, -1, 1)
        src = base[:, None] + step[:, None] * offr[None, :]
        val = pa[src.reshape(-1)].reshape(s1 - s0, ts)
        ridx = np.flatnonzero(rv)
        if len(ridx):
            val[ridx] = COMP_MAP[val[ridx]]
        uidx = np.flatnonzero(~mapped)
        if len(uidx):
            val[uidx] = _DNA[rng.integers(0, 4, (len(uidx), ts))]
        # substitutions: sampled positions at the expected Bernoulli count
        # (with replacement — statistically equivalent at fixture scale)
        nb = (s1 - s0) * ts
        k = int(rng.binomial(nb, sub_p))
        if k:
            flat = val.reshape(-1)
            flat[rng.integers(0, nb, k)] = _DNA[rng.integers(0, 4, k)]
        out[s0 * ts:s1 * ts] = val.reshape(-1)
    if n_full * ts < length:  # ragged tail segment
        t0 = n_full * ts
        ln = length - t0
        pi = parent_idx[n_full] if n_full < n_top else NULL_INDEX
        if pi == NULL_INDEX:
            out[t0:] = _DNA[rng.integers(0, 4, ln)]
        else:
            ps = int(p_start[pi])
            seq = pg.get_dna(ps, ln, reversed_=bool(reversed_[n_full]))
            sub = _expon_mask(rng, bl, ln)
            if sub.any():
                seq = seq.copy()
                seq[sub] = _DNA[rng.integers(0, 4, int(sub.sum()))]
            out[t0:] = seq
    g.set_dna(0, out)


def create_random_genome(
    rng: np.random.Generator,
    aln: Alignment,
    name: str,
    dims: dict[str, dict],
    fast_dna: bool = False,
) -> None:
    """Fill a genome's links and DNA given its (already filled) parent."""
    d = dims[name]
    g = aln.open_genome(name)
    parent_name = aln.tree.parent(name)
    if parent_name is None:
        # random root DNA
        if d["length"] and g.dna.size:
            bases = _DNA[rng.integers(0, 4, d["length"])]
            g.set_dna(0, bases)
        return

    pg = aln.open_genome(parent_name)
    bl = aln.tree.branch_length(name)
    child_slot = aln.tree.child_index(parent_name, name)
    n_top, n_bot = d["n_top"], pg.num_bottom_segments

    idx = np.arange(n_top, dtype=np.int64)
    parent_idx = idx.copy()
    # transposition/duplication: random remap
    remap = (parent_idx >= n_bot) | _expon_mask(rng, bl, n_top)
    if n_bot >= 1:
        # getRandInt is inclusive in the reference (randgen/halRandGen.cpp)
        parent_idx[remap] = rng.integers(0, n_bot, int(remap.sum()))
    # insertion: prob p^2, only where not remapped
    ins = (~remap) & _expon_mask(rng, bl, n_top) & _expon_mask(rng, bl, n_top)
    parent_idx[ins] = NULL_INDEX
    # the last parent bottom / last child top have unknown-length pairing: cut
    parent_idx[parent_idx == n_bot - 1] = NULL_INDEX
    if n_top:
        parent_idx[n_top - 1] = NULL_INDEX
    if n_bot <= 1:
        parent_idx[:] = NULL_INDEX

    reversed_ = np.zeros(n_top, np.uint8)
    mapped = parent_idx != NULL_INDEX
    reversed_[mapped] = _expon_mask(rng, bl, int(mapped.sum())).astype(np.uint8)

    g.top_parent = parent_idx
    g.top_parent_reversed = reversed_

    # parent child links: last writer wins (reference halRandomData.cpp:321)
    pidx = parent_idx[mapped]
    tidx = idx[mapped]
    pg.bot_child[pidx, child_slot] = tidx
    pg.bot_child_reversed[pidx, child_slot] = reversed_[mapped]

    # paralogy rings: tops sharing a parent bottom, ring-linked in index
    # order (vectorized group-boundary scan; the python group loop was the
    # mammal-scale fixture bottleneck)
    order = np.argsort(pidx, kind="stable")
    sp, st = pidx[order], tidx[order]
    ring_next = np.full(n_top, NULL_INDEX, np.int64)
    if len(sp):
        grp_start_mask = np.r_[True, sp[1:] != sp[:-1]]
        grp_start = np.flatnonzero(grp_start_mask)
        grp_end = np.r_[grp_start[1:], len(sp)]
        sizes = grp_end - grp_start
        nxt = np.empty_like(st)
        if len(st) > 1:
            nxt[:-1] = st[1:]
        nxt[grp_end - 1] = st[grp_start]
        in_ring = np.repeat(sizes > 1, sizes)
        ring_next[st[in_ring]] = nxt[in_ring]
    g.top_paralogy = ring_next

    # DNA: copy parent segment (revcomp when inverted), substitute, or random
    if d["length"] and g.dna.size:
        if fast_dna:
            _fill_dna_fast(rng, g, pg, parent_idx, reversed_, d, bl)
            return
        out = np.empty(d["length"], np.uint8)
        top_size = d["top_size"]
        for i in range(n_top):
            s = int(g.top_start[i])
            ln = int(g.top_start[i + 1]) - s
            p = parent_idx[i]
            if p == NULL_INDEX:
                out[s : s + ln] = _DNA[rng.integers(0, 4, ln)]
            else:
                ps = int(pg.bot_start[p])
                seq = pg.get_dna(ps, ln, reversed_=bool(reversed_[i]))
                sub = _expon_mask(rng, bl, ln)
                if sub.any():
                    seq = seq.copy()
                    seq[sub] = _DNA[rng.integers(0, 4, int(sub.sum()))]
                out[s : s + ln] = seq
        g.set_dna(0, out)


def create_random_alignment(
    seed: int = 0,
    mean_degree: float = 1.0,
    max_branch_length: float = 1.0,
    min_genomes: int = 2,
    max_genomes: int = 10,
    min_segment_length: int = 2,
    max_segment_length: int = 10,
    min_segments: int = 1,
    max_segments: int = 10,
    store_dna: bool = True,
    fast_dna: bool = False,
) -> Alignment:
    """End-to-end random alignment (reference createRandomAlignment,
    api/tests/halRandomData.h:17).  store_dna=False skips DNA generation
    (structure-only fixtures for mammal-scale benchmarks; the reference
    supports DNA-less genomes the same way, halGenome.h:53-57).
    fast_dna=True fills DNA with the chunked vectorized gather (same model,
    different RNG draw order) for large benchmark fixtures."""
    rng = np.random.default_rng(seed)
    aln = create_random_tree(rng, mean_degree, max_branch_length, min_genomes, max_genomes)
    dims = create_random_dimensions(rng, aln, min_segment_length, max_segment_length,
                                    min_segments, max_segments)
    for name in aln.tree.preorder():
        aln.set_genome(_alloc_genome(aln, name, dims[name], store_dna=store_dna))
    for name in aln.tree.preorder():
        create_random_genome(rng, aln, name, dims, fast_dna=fast_dna)
    return aln


def create_preset_alignment(preset: str = "small", seed: int = 0) -> Alignment:
    """halRandGen --preset equivalent (reference randgen/halRandGen.cpp:41-54).

    Note: preset sizes are capped for tests; 'big'/'large' are expensive.
    """
    p = PRESETS[preset]
    return create_random_alignment(
        seed=seed,
        mean_degree=p["mean_degree"],
        max_branch_length=p["max_branch_length"],
        min_genomes=2,
        max_genomes=p["max_genomes"],
        min_segment_length=p["min_segment_length"],
        max_segment_length=p["max_segment_length"],
        min_segments=1,
        max_segments=p["max_segments"],
    )

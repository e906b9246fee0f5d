"""The benchmark's input generator: a frozen copy of
hal_tpu_torch/randgen.py's create_random_alignment (numpy only), which makes
an alignment's plain segment arrays and DNA from a seed.

It builds the reference's model (hal_bench.reference.alignment), whose
arrays the drivers hand to the port's public in-memory constructors
(hal_tpu_torch.alignment.Alignment, hal_tpu_torch.genome.GenomeArrays) and
the reference reads directly, so both sides get the same arrays.  A later
change to the port's generator does not move the yardstick.

One change to the copy: create_random_alignment takes content_seed.  With
it, the tree and the genome sizes come from `seed` and everything else
(links, inversions, paralogy rings, DNA) from content_seed, so every
benchmark seed gets the same tree, the same genome lengths and the same
liftover path, and only the alignment's content changes.  Without it the
draws are the original's, one stream from `seed`.

One addition: dna_device.  With it the DNA is filled on a torch device
(the card, in a few large calls a genome) after the links are made, with
the same model as the original's fill: each child base copied from its
parent bottom (reverse-complemented when inverted), a fresh random base
where the top segment has no parent, and a substitution at each base with
probability 1 - exp(-branch length).  Only the order of the random draws
differs, so the same seed gives the same bases on every card.
"""

from __future__ import annotations

import numpy as np

from hal_bench.reference.alignment import Alignment
from hal_bench.reference.constants import NULL_INDEX
from hal_bench.reference.genome import GenomeArrays, SequenceInfo

_DNA = np.frombuffer(b"ACGT", dtype=np.uint8)


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
    aln.tree.set_root("Genome_0")
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
            aln.tree.add_child(name, child, float(rng.uniform(1e-5, max_branch_length)))
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


def create_random_genome(
    rng: np.random.Generator,
    aln: Alignment,
    name: str,
    dims: dict[str, dict],
    fill_dna: bool = True,
) -> None:
    """Fill a genome's links and DNA given its (already filled) parent."""
    d = dims[name]
    g = aln.open_genome(name)
    parent_name = aln.tree.parent(name)
    if parent_name is None:
        # random root DNA
        if fill_dna and d["length"] and g.dna.size:
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
    if fill_dna and d["length"] and g.dna.size:
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


# 4-bit codes of A, C, G, T (reference.dna: uppercase ACGT are 8..11); the
# complement of code c is 19 - c
_CODE_A = 8
_DEVICE_CHUNK = 1 << 27  # bases a step of the device fill


def _device_generator(torch, device, content_seed: int, index: int):
    """The device fill's random stream of the index-th genome (preorder)."""
    words = np.random.SeedSequence([int(content_seed) % (1 << 64), index])
    gen_ = torch.Generator(device=device)
    gen_.manual_seed(int(words.generate_state(1, np.uint64)[0] >> 1))
    return gen_


def _fill_dna_device(torch, device, gen_, g, d, p_start, parent_codes, bl):
    """A genome's bases as 4-bit codes on `device`: the root's at random, a
    child's copied from its parent's codes by its top segments' links."""
    length = d["length"]
    if parent_codes is None:
        return torch.randint(0, 4, (length,), generator=gen_, device=device,
                             dtype=torch.uint8) + _CODE_A
    out = torch.empty(length, dtype=torch.uint8, device=device)
    ts = d["top_size"]
    pidx = torch.as_tensor(g.top_parent, device=device)
    rev = torch.as_tensor(g.top_parent_reversed, device=device).bool()
    p_start = torch.as_tensor(p_start, device=device)
    sub_p = float(1.0 - np.exp(-bl))
    for c0 in range(0, length, _DEVICE_CHUNK):
        c1 = min(c0 + _DEVICE_CHUNK, length)
        pos = torch.arange(c0, c1, device=device, dtype=torch.int64)
        seg = torch.div(pos, ts, rounding_mode="floor")
        off = pos - seg * ts
        # the last top segment may be shorter than ts
        seg_len = torch.clamp(length - seg * ts, max=ts)
        pi = pidx[seg]
        mapped = pi != NULL_INDEX
        r = rev[seg] & mapped
        base = p_start[torch.where(mapped, pi, 0)]
        val = parent_codes[torch.where(r, base + seg_len - 1 - off,
                                       base + off)]
        val = torch.where(r, 19 - val, val)
        fresh = torch.randint(0, 4, (c1 - c0,), generator=gen_,
                              device=device, dtype=torch.uint8) + _CODE_A
        sub = torch.rand(c1 - c0, generator=gen_, device=device) < sub_p
        out[c0:c1] = torch.where(mapped & ~sub, val, fresh)
    return out


def _pack_codes(torch, codes) -> np.ndarray:
    """4-bit codes -> the packed host array (reference.dna: two bases a
    byte, the even position in the high nibble)."""
    if codes.numel() % 2:
        codes = torch.cat([codes, codes.new_zeros(1)])
    pairs = codes.view(-1, 2)
    return ((pairs[:, 0] << 4) | pairs[:, 1]).cpu().numpy()


def fill_dna_on_device(aln: Alignment, dims: dict[str, dict],
                       content_seed: int, device: str) -> None:
    """Every genome's DNA, made on `device` in preorder and stored packed
    on the host; a parent's codes stay on the device until its last child
    has its own."""
    import torch

    order = list(aln.tree.preorder())
    last_child = {aln.tree.parent(n): n for n in order
                  if aln.tree.parent(n) is not None}
    codes: dict[str, object] = {}
    for i, name in enumerate(order):
        d = dims[name]
        g = aln.open_genome(name)
        parent = aln.tree.parent(name)
        if d["length"] and g.dna.size:
            pc = codes.get(parent) if parent is not None else None
            if parent is not None and pc is None:
                raise ValueError("%s has DNA and its parent none" % name)
            c = _fill_dna_device(
                torch, device, _device_generator(torch, device,
                                                 content_seed, i),
                g, d, aln.open_genome(parent).bot_start if parent else None,
                pc, aln.tree.branch_length(name) if parent else 0.0)
            g.dna[:] = _pack_codes(torch, c)
            if name in last_child:
                codes[name] = c
        if parent is not None and last_child[parent] == name:
            codes.pop(parent, None)


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
    content_seed: int | None = None,
    dna_device: str | None = None,
) -> Alignment:
    """End-to-end random alignment (reference createRandomAlignment,
    api/tests/halRandomData.h:17).  store_dna=False skips DNA generation
    (structure-only fixtures for mammal-scale benchmarks; the reference
    supports DNA-less genomes the same way, halGenome.h:53-57).
    dna_device fills the DNA on that torch device (same model, another
    order of random draws) for large benchmark configurations."""
    rng = np.random.default_rng(seed)
    aln = create_random_tree(rng, mean_degree, max_branch_length, min_genomes, max_genomes)
    dims = create_random_dimensions(rng, aln, min_segment_length, max_segment_length,
                                    min_segments, max_segments)
    for name in aln.tree.preorder():
        aln.genomes[name] = _alloc_genome(aln, name, dims[name], store_dna=store_dna)
    if content_seed is not None:
        rng = np.random.default_rng(content_seed)
    for name in aln.tree.preorder():
        create_random_genome(rng, aln, name, dims,
                             fill_dna=dna_device is None)
    if dna_device is not None and store_dna:
        fill_dna_on_device(aln, dims, seed if content_seed is None
                           else content_seed, dna_device)
    return aln


GENERATOR_KEYS = ("mean_degree", "max_branch_length", "min_genomes",
                  "max_genomes", "min_segment_length", "max_segment_length",
                  "min_segments", "max_segments", "store_dna")


def from_config(config: dict, seed: int, device: str = "cpu") -> Alignment:
    """The configuration's alignment for a benchmark seed: its tree and
    sizes from config["structure_seed"], its content from `seed`; with
    config["dna_on_device"] its DNA is made on `device`.  Every
    array is made read-only, so a program that wrote into the inputs it
    shares with the reference would fail instead of moving the yardstick."""
    kw = {k: config[k] for k in GENERATOR_KEYS if k in config}
    aln = create_random_alignment(
        seed=int(config["structure_seed"]), content_seed=int(seed),
        dna_device=device if config.get("dna_on_device") else None, **kw)
    for g in aln.genomes.values():
        for v in vars(g).values():
            if isinstance(v, np.ndarray):
                v.flags.writeable = False
    return aln

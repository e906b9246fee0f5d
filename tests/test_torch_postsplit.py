"""The column engine's split plan (column_torch.split_plan) and the
post-split that follows it, on the CPU.  With the plan, _postsplit gives
exactly the fragments of the full cut at both of the target's grids
(ColumnHostSim._split at the top grid, then at the bottom grid), field by
field and dtype by dtype, through window_frags (the overflow re-size
included) and collect_sharded, on the benchmark's star tree (a root over 9
leaves, at its CPU test size) and on the deeper random trees of the column
tests; and a link or ring member of unequal lengths planted in an
alignment keeps its grid in the plan."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hal_bench import gen, traffic
from hal_bench.port import port_alignment
from hal_bench.tests.small import CONFIG
from hal_tpu_torch.ops import column_torch as ct
from hal_tpu_torch.parallel import sharded as ps
from hal_tpu_torch.randgen import create_random_alignment

ROOT = Path(__file__).resolve().parents[1]
STAR_SEEDS = (3100000001, 2 ** 31 + 41)
RANDOM_SEEDS = (11, 42)
FIELDS = ("s_lo", "t_lo", "ln", "rev", "key")


def star(seed):
    """(alignment, reference) of the maf.window-4m cell's configuration at
    its CPU test size, without DNA: a root over 9 leaves, the reference
    its longest leaf."""
    cfg = json.loads(
        (ROOT / "hal_bench/configs/mammal10-dna128.json").read_text())
    cfg.update(CONFIG["maf.window-4m"], store_dna=False, dna_on_device=False)
    model = gen.from_config(cfg, seed)
    return port_alignment(model), traffic.longest_leaf(model)


def deep(seed):
    """(alignment, reference leaf) of tests/test_torch_column.py's fixture:
    random trees of 5-7 genomes with ancestors below the root."""
    aln = create_random_alignment(
        seed=seed, max_genomes=7, min_genomes=5, min_segments=6,
        max_segments=30, min_segment_length=3, max_segment_length=12)
    ref = [n for n in aln.genome_names() if aln.tree.is_leaf(n)
           and aln.open_genome(n).length][0]
    return aln, ref


TREES = {"star": (star, STAR_SEEDS), "deep": (deep, RANDOM_SEEDS)}
CASES = [(tree, seed) for tree, (_f, seeds) in TREES.items()
         for seed in seeds]


def full_split(aln, frags):
    """Every program's fragments cut at both of its target's grids."""
    out = {}
    for t, parts in frags.items():
        g = aln.open_genome(t)
        split = []
        for o, st_ in parts:
            if g.num_top_segments:
                st_ = ct.ColumnHostSim._split(st_, g.top_start)[0]
            if g.num_bottom_segments:
                st_ = ct.ColumnHostSim._split(st_, g.bot_start)[0]
            if len(st_.s_lo):
                split.append((o, st_))
        out[t] = split
    return out


def assert_equal(got, want):
    assert got.keys() == want.keys()
    for t in want:
        assert [o for o, _ in got[t]] == [o for o, _ in want[t]], t
        for (_o, a), (_p, b) in zip(got[t], want[t]):
            for f in FIELDS:
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), (t, f)


@pytest.fixture
def received(monkeypatch):
    """A copy of each fragment dict _postsplit is handed."""
    seen = []
    orig = ct.DeviceColumnEngine._postsplit

    def postsplit(self, frags):
        seen.append(copy.deepcopy(frags))
        return orig(self, frags)
    monkeypatch.setattr(ct.DeviceColumnEngine, "_postsplit", postsplit)
    return seen


@pytest.mark.parametrize("dtype", [None, np.uint32], ids=["picked", "uint32"])
@pytest.mark.parametrize("tree,seed", CASES)
def test_window_frags_equal_the_full_split(tree, seed, dtype, received):
    """Whole-reference and two part windows, then the whole window again
    with the cached output widths cut so that it overflows and is re-sized:
    the planned post-split equals the full cut of what it received and the
    host twin's fragments (_target_frags_host, which cuts at both grids)."""
    make, _seeds = TREES[tree]
    aln, ref = make(seed)
    eng = ct.DeviceColumnEngine(aln, ref, dtype=dtype, device="cpu")
    ge = int(aln.open_genome(ref).length)
    for gs, we in ((0, ge), (0, ge // 2), (ge // 3, ge)):
        got = eng.window_frags(gs, we)
        assert_equal(got, full_split(aln, received[-1]))
        assert_equal(got, ct._target_frags_host(eng.sim, eng.programs,
                                                gs, we))
    cut = {k: (caps, 5) for k, (caps, _oc) in eng._caps.items()
           if k[1] == ge}
    eng._caps.update(cut)
    n = len(received)
    got = eng.window_frags(0, ge)
    assert len(received) == n + 1
    assert_equal(got, full_split(aln, received[-1]))
    assert_equal(got, ct._target_frags_host(eng.sim, eng.programs, 0, ge))
    assert any(eng._caps[k][1] > 5 for k in cut), \
        "the cut widths must overflow and be re-sized"


@pytest.mark.parametrize("tree,seed", CASES)
def test_collect_sharded_equals_the_full_split(tree, seed, received):
    """The sharded column step over 4 local shards of a window: what
    collect_sharded returns equals the full cut of what it received."""
    make, _seeds = TREES[tree]
    aln, ref = make(seed)
    eng = ct.DeviceColumnEngine(aln, ref, device="cpu")
    ge = int(aln.open_genome(ref).length)
    edges = np.linspace(0, ge, 5).astype(np.int64)
    caps_all, oc_all = ct.size_sharded_caps(eng, edges)
    step = ct.make_sharded_column_step(eng, caps_all, oc_all,
                                       ps.make_mesh(4, 1, device="cpu"))
    outs = step(torch.from_numpy(edges[:-1].copy()),
                torch.from_numpy(edges[1:].copy()))
    got = ct.collect_sharded(eng, outs, edges)
    assert len(received) == 1
    assert_equal(got, full_split(aln, received[0]))
    assert sum(len(s.s_lo) for p in got.values() for _o, s in p) > 8


@pytest.mark.parametrize("seed", STAR_SEEDS)
def test_star_tree_plan_cuts_only_the_identity_row(seed):
    """Every device program of the star tree lands on a grid it respects,
    and its target has no other: only the reference's identity row keeps a
    grid (a leaf's, the top)."""
    aln, ref = star(seed)
    eng = ct.DeviceColumnEngine(aln, ref, device="cpu")
    assert len(aln.tree.children(aln.root_name)) == 9
    assert eng.lands_inside and all(eng.lands_inside.values())
    kept = {k: v for k, v in eng.plan.items() if v}
    identity = [s.ordinal for s in eng.programs[ref] if not s.ops]
    assert kept == {(ref, o): ("top_start",) for o in identity}
    assert len(eng.plan) == sum(len(s) for s in eng.programs.values())


@pytest.mark.parametrize("seed", RANDOM_SEEDS)
def test_plan_leaves_out_only_the_landed_grid(seed):
    """On the deeper random trees, with the reference a leaf and the root:
    every check passes, and each program keeps every grid its target has
    but the one its last level lands on; ancestors reached by down keep
    their bottom grid, so some device program is still cut."""
    aln, leaf = deep(seed)
    cut_jobs = 0
    for ref in (leaf, aln.root_name):
        eng = ct.DeviceColumnEngine(aln, ref, device="cpu")
        assert all(eng.lands_inside.values())
        for t, specs in eng.programs.items():
            g = aln.open_genome(t)
            have = tuple(grid for grid, n in (
                ("top_start", g.num_top_segments),
                ("bot_start", g.num_bottom_segments)) if n)
            for spec in specs:
                want = have
                if spec.ops:
                    op = spec.ops[-1]
                    landed = ("bot_start" if op[0] in ("up", "upc")
                              else "top_start")
                    want = tuple(x for x in have if x != landed)
                    cut_jobs += bool(want)
                assert eng.plan[t, spec.ordinal] == want, (t, spec.ops)
    assert cut_jobs


def _plant(aln, ref, kind):
    """Moves one top-segment boundary by a base, in a leaf other than the
    reference at a segment its parent's bottom links to ("link"), or in the
    reference at the end of a paralogy ring member ("ring").  Returns the
    genome and the last op whose check must now fail."""
    root = aln.root_name
    if kind == "link":
        t = sorted(n for n in aln.tree.children(root) if n != ref)[0]
        pg = aln.open_genome(root)
        slot = aln.tree.child_index(root, t)
        link = np.sort(pg.bot_child[:pg.num_bottom_segments, slot])
        link = link[link > 0]
        k = int(link[len(link) // 2])
        g = aln.open_genome(t)
        g.top_start = g.top_start.copy()
        g.top_start[k] += 1
        return t, ("down", root, t)
    g = aln.open_genome(ref)
    ring = np.flatnonzero(g.top_paralogy[:g.num_top_segments - 1] >= 0)
    k = int(ring[len(ring) // 2])
    g.top_start = g.top_start.copy()
    g.top_start[k + 1] -= 1
    return ref, ("selfring", ref)


@pytest.mark.parametrize("kind", ["link", "ring"])
def test_unequal_lengths_keep_the_grid(kind, received):
    """A planted link between segments of unequal length (into a leaf) or
    ring member shorter than its source (in the reference): the check
    fails, the plan keeps the landed grid, the full cut really cuts that
    target's fragments there, and the planned post-split still equals it
    and the host twin."""
    aln, ref = star(STAR_SEEDS[0])
    t, op = _plant(aln, ref, kind)
    eng = ct.DeviceColumnEngine(aln, ref, device="cpu")
    assert eng.lands_inside[op] is False
    assert all(v for o, v in eng.lands_inside.items() if t not in o[1:])
    ords = [s.ordinal for s in eng.programs[t] if s.ops and s.ops[-1] == op]
    assert ords and all("top_start" in eng.plan[t, o] for o in ords)
    ge = int(aln.open_genome(ref).length)
    got = eng.window_frags(0, ge)
    want = full_split(aln, received[-1])
    assert_equal(got, want)
    assert_equal(got, ct._target_frags_host(eng.sim, eng.programs, 0, ge))

    def n_frags(frags):
        return sum(len(s.s_lo) for o, s in frags[t] if o in ords)
    assert n_frags(want) > n_frags(received[-1])

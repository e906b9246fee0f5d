"""hal_tpu_torch.ops.segmap_torch against the JAX package (segmap_jax on
the CPU) and the host oracle (segmap_host): fragment matrices slot for
slot on equal capacities, map_batch fragments, the run wire byte for byte.
Tolerance: exact equality (integer outputs and bytes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hal_tpu.ops import segmap_host as sm
from hal_tpu.ops import segmap_jax as sj
from hal_tpu.randgen import create_random_alignment
from hal_tpu_torch.ops import segmap_torch as st
from hal_tpu_torch.ops import tables
from naive_oracle import fragments_to_base_pairs
from test_segmap_jax import _pairs_to_check, _pairs_with_owner


def _host_pairs(aln, src, tgt, lo, hi, **opts):
    want = set()
    for i, (l, h) in enumerate(zip(lo, hi)):
        frags = sm.map_source(aln, src, np.array([l]), np.array([h]), tgt,
                              **opts)
        for (sp, tp, rv) in fragments_to_base_pairs(frags):
            want.add((i, sp, tp, rv))
    return want


def _runs_fixture(seed):
    """tests/test_device_runs.py's fixture and intervals."""
    aln = create_random_alignment(seed=seed, max_genomes=8, min_genomes=5,
                                  mean_degree=1.4, max_branch_length=0.5,
                                  min_segment_length=5, max_segment_length=40,
                                  min_segments=10, max_segments=80,
                                  store_dna=False)
    leaves = [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)
              and aln.open_genome(n).length > 30]
    src, tgt = leaves[0], leaves[-1]
    g = aln.open_genome(src)
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, max(g.length - 30, 1), 64).astype(np.int64)
    hi = lo + rng.integers(1, 30, 64)
    return aln, src, tgt, lo, hi


def _three_genome():
    from fixtures import three_genome_alignment

    return (three_genome_alignment(), "A", "B", np.array([0, 5, 10]),
            np.array([25, 22, 18]))


def _run_both(aln, src, tgt, lo, hi, caps=None, **build):
    """(_map_batch_jit outputs as numpy, _run_path outputs as numpy) on the
    same capacities (host-sized unless given)."""
    pj = sj.PathData.build(aln, src, tgt, **build)
    pt = st.PathData.build(aln, src, tgt, device="cpu", **build)
    if caps is None:
        totals, _ = sj.host_path_totals(
            aln, src, tgt, lo, hi, do_dupes=build.get("do_dupes", True),
            coalescence_limit=build.get("coalescence_limit"))
        caps = sj.caps_from_totals(pj, totals)
    dt = pj.levels[0].grid.dtype
    n = len(lo)
    J = sj._map_batch_jit(pj, jnp.asarray(lo, dt), jnp.asarray(hi, dt),
                          jnp.arange(n, dtype=dt), caps)
    T = st._run_path(pt, st.coords(pt, lo), st.coords(pt, hi),
                     torch.arange(n, dtype=pt.dtype), caps)
    return ([np.asarray(a) for a in J], [a.numpy() for a in T], pj, pt, caps)


def _assert_same_run(J, T, full=True):
    FJ, FT = J[0], T[0]
    assert FJ.shape == FT.shape
    if full:
        assert FT.dtype == FJ.dtype
        assert np.array_equal(FT, FJ)
    else:  # uint32 path: valid columns are equal; masked slots may differ
        vj = FJ[st.C_VALID] > 0
        assert np.array_equal(FT[st.C_VALID] > 0, vj)
        assert np.array_equal(FT[:, vj], FJ[:, vj].astype(np.int64))
    assert int(T[1]) == int(J[1])  # last-valid bound
    assert bool(T[2]) == bool(J[2])  # overflow
    assert np.array_equal(T[3], J[3])  # per-level totals


CASES = {
    "runs3": lambda: _runs_fixture(3),
    "runs17": lambda: _runs_fixture(17),
    "runs29": lambda: _runs_fixture(29),
    "three_genome": _three_genome,
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_path_matrix_equals_jax(case):
    aln, src, tgt, lo, hi = CASES[case]()
    J, T, _pj, _pt, caps = _run_both(aln, src, tgt, lo, hi)
    assert not bool(T[2])
    _assert_same_run(J, T)
    # undersized capacities: both overflow, the matrices still agree
    small = tuple((2, 2) if isinstance(c, tuple) else 2 for c in caps)
    J, T, *_ = _run_both(aln, src, tgt, lo, hi, caps=small)
    assert bool(T[2])
    _assert_same_run(J, T)


@pytest.mark.parametrize("opts", [dict(do_dupes=False), dict(min_length=3),
                                  dict(coalescence_limit="root")],
                         ids=["noDupes", "minLength", "coalescence"])
def test_run_path_options_equal_jax(opts):
    aln, src, tgt, _lo, _hi = _runs_fixture(3)
    names = aln.genome_names()
    if opts.get("coalescence_limit") == "root":
        opts = dict(coalescence_limit=aln.root_name)
        src, tgt = next((s, t) for s in names for t in names
                        if s != t and aln.tree.lca(s, t) != aln.root_name)
    g = aln.open_genome(src)
    rng = np.random.default_rng(2)
    lo = rng.integers(0, max(g.length - 2, 1), 24)
    hi = np.minimum(lo + rng.integers(1, 25, 24), g.length)
    J, T, pj, pt, _caps = _run_both(aln, src, tgt, lo, hi, **opts)
    assert len(pt.para) == len(pj.para)
    assert bool(pt.para) == ("coalescence_limit" in opts)
    _assert_same_run(J, T)


def _assert_paths_equal(a, b):
    assert (a.n_up, a.min_length, len(a.levels), len(a.para)) == \
        (b.n_up, b.min_length, len(b.levels), len(b.para))
    la = list(a.levels) + [lv for up, downs in a.para for lv in (up, *downs)]
    lb = list(b.levels) + [lv for up, downs in b.para for lv in (up, *downs)]
    for x, y in zip(la, lb):
        assert (x.kind, x.max_ring, x.page_shift, x.u32) == \
            (y.kind, y.max_ring, y.page_shift, y.u32)
        for f in ("grid", "seg_table", "ring_mem_tab", "page_tab"):
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None)
            if u is not None:
                assert u.dtype == v.dtype and torch.equal(u, v)


def test_from_numpy_equals_build(monkeypatch):
    """PathData.from_numpy over the JAX package's Levels equals the port's
    own PathData.build, for int32, paged, paralogy-branch and uint32-range
    paths, and maps the same fragments."""
    aln, src, tgt, lo, hi = _runs_fixture(17)
    root = aln.root_name
    cases = [(aln, src, tgt, {}), (aln, src, tgt, dict(do_dupes=False))]
    names = aln.genome_names()
    deep = next(((s, t) for s in names for t in names
                 if s != t and aln.tree.lca(s, t) != root), None)
    assert deep is not None
    cases.append((aln, deep[0], deep[1], dict(coalescence_limit=root)))
    for a, s, t, opts in cases:
        pj = sj.PathData.build(a, s, t, **opts)
        pt = st.PathData.build(a, s, t, device="cpu", **opts)
        pf = st.PathData.from_numpy(pj.levels, pj.n_up, pj.para,
                                    pj.min_length, device="cpu")
        _assert_paths_equal(pf, pt)
        assert pf.coord_kind == pt.coord_kind == "int32"
        g = a.open_genome(s)
        lo2 = np.arange(0, g.length - 1, 7)
        hi2 = np.minimum(lo2 + 9, g.length)
        assert all(np.array_equal(x, y) for x, y in
                   zip(st.map_batch(pf, lo2, hi2), st.map_batch(pt, lo2, hi2)))
    monkeypatch.setattr(sj, "_PALLAS_GRID_LIMIT", 4)
    monkeypatch.setattr(st, "_PAGE_GRID_LIMIT", 4)
    monkeypatch.setattr(st, "_KERNEL_GRID_LIMIT", 4)
    pj = sj.PathData.build(aln, src, tgt)
    pt = st.PathData.build(aln, src, tgt, device="cpu")
    assert any(lv.page_tab is not None for lv in pt.levels)
    _assert_paths_equal(st.PathData.from_numpy(pj.levels, pj.n_up,
                                               device="cpu"), pt)
    big = _big_genome()[0]
    leaves = [n for n in big.genome_names() if big.tree.is_leaf(n)]
    pj = sj.PathData.build(big, leaves[0], leaves[-1])
    pt = st.PathData.build(big, leaves[0], leaves[-1], device="cpu")
    pf = st.PathData.from_numpy(pj.levels, pj.n_up, device="cpu")
    assert pt.coord_kind == "uint32" and pt.dtype == torch.int64
    _assert_paths_equal(pf, pt)


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_torch_matches_host_and_jax(seed):
    """test_segmap_jax.py::test_jax_matches_host on the port; the port's
    map_batch also equals segmap_jax.map_batch array for array."""
    aln = create_random_alignment(seed=seed, max_genomes=6, min_segments=3,
                                  max_segments=25, min_segment_length=2,
                                  max_segment_length=12)
    rng = np.random.default_rng(seed)
    count = 0
    for src, tgt in _pairs_to_check(aln, False):
        g = aln.open_genome(src)
        if g.length < 4:
            continue
        lo = rng.integers(0, g.length - 2, 8)
        hi = np.minimum(lo + rng.integers(1, 30, 8), g.length)
        keep = hi > lo
        lo, hi = lo[keep], hi[keep]
        pt = st.PathData.build(aln, src, tgt, device="cpu")
        got = st.map_batch(pt, lo, hi)
        assert _pairs_with_owner(*got) == _host_pairs(aln, src, tgt, lo, hi)
        want = sj.map_batch(sj.PathData.build(aln, src, tgt), lo, hi)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        count += 1
    assert count > 0


def test_overflow_retry():
    aln = create_random_alignment(seed=1, max_genomes=5, min_segments=10,
                                  max_segments=60, min_segment_length=2,
                                  max_segment_length=6)
    names = aln.genome_names()
    src = [n for n in names if aln.tree.is_leaf(n)][0]
    tgt = names[-1] if names[-1] != src else names[0]
    g = aln.open_genome(src)
    lo, hi = np.array([0]), np.array([g.length])
    pt = st.PathData.build(aln, src, tgt, device="cpu")
    got = st.map_batch(pt, lo, hi, cap_mult=1)
    assert _pairs_with_owner(*got) == _host_pairs(aln, src, tgt, lo, hi)
    want = sj.map_batch(sj.PathData.build(aln, src, tgt), lo, hi, cap_mult=1)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    # the pipelined mapper retries the same way
    bm = st.BatchMapper(aln, src, tgt, device="cpu")
    got2 = bm.decode(bm.dispatch(lo, hi, cap_mult=1))
    assert all(np.array_equal(a, b) for a, b in zip(got2, want))


def test_paged_lookup_matches_host_and_jax(monkeypatch):
    """Force the paged lookup on small grids (test_segmap_jax.py's
    test_paged_lookup_matches_host) on both packages."""
    monkeypatch.setattr(st, "_PAGE_GRID_LIMIT", 4)
    monkeypatch.setattr(st, "_KERNEL_GRID_LIMIT", 4)
    monkeypatch.setattr(sj, "_PALLAS_GRID_LIMIT", 4)
    aln = create_random_alignment(seed=5, max_genomes=5, min_segments=8,
                                  max_segments=40, min_segment_length=3,
                                  max_segment_length=9)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    g = aln.open_genome(src)
    rng = np.random.default_rng(5)
    lo = rng.integers(0, g.length - 2, 16)
    hi = np.minimum(lo + rng.integers(1, 40, 16), g.length)
    J, T, pj, pt, caps = _run_both(aln, src, tgt, lo, hi)
    assert any(lv.page_tab is not None for lv in pt.levels)
    assert not bool(T[2]), "host sizing undersized"
    _assert_same_run(J, T)
    got = st.map_batch(pt, lo, hi)
    assert _pairs_with_owner(*got) == _host_pairs(aln, src, tgt, lo, hi)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_option_combos_exhaustive_pairs(seed):
    """Port == host over every ordered genome pair x option combos
    (test_segmap_jax.py's case); seed 0 also against segmap_jax."""
    aln = create_random_alignment(seed=seed, max_genomes=5, min_genomes=4,
                                  min_segments=3, max_segments=18,
                                  min_segment_length=2, max_segment_length=9)
    names = aln.genome_names()
    rng = np.random.default_rng(seed)
    root = aln.root_name
    checked = 0
    for src in names:
        g = aln.open_genome(src)
        if g.length < 4:
            continue
        lo = rng.integers(0, g.length - 2, 6)
        hi = np.minimum(lo + rng.integers(1, 25, 6), g.length)
        for tgt in names:
            if tgt == src:
                continue
            combos = [dict(do_dupes=True), dict(do_dupes=False),
                      dict(do_dupes=True, min_length=3)]
            if aln.tree.lca(src, tgt) != root:
                combos.append(dict(do_dupes=True, coalescence_limit=root))
            for opts in combos:
                pt = st.PathData.build(aln, src, tgt, device="cpu", **opts)
                got = st.map_batch(pt, lo, hi)
                host_opts = dict(opts)
                assert _pairs_with_owner(*got) == _host_pairs(
                    aln, src, tgt, lo, hi, **host_opts), (src, tgt, opts)
                if seed == 0:
                    want = sj.map_batch(sj.PathData.build(aln, src, tgt,
                                                          **opts), lo, hi)
                    assert all(np.array_equal(a, b)
                               for a, b in zip(got, want)), (src, tgt, opts)
                checked += 1
    assert checked >= 12


def _big_genome():
    aln = create_random_alignment(seed=4, max_genomes=5, min_genomes=4,
                                  min_segments=6, max_segments=14,
                                  min_segment_length=1 << 28,
                                  max_segment_length=(1 << 28) + 64,
                                  store_dna=False)
    rng = np.random.default_rng(0)
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    g = aln.open_genome(leaves[0])
    lo = rng.integers(0, g.length - 300, 32)
    hi = lo + rng.integers(1, 200, 32)
    return aln, lo, hi


def test_uint32_path_big_genome():
    """Genomes past 2^31 bases: the JAX package picks uint32, the port
    int64 with the u32 mark; results equal the host oracle and segmap_jax,
    and the run wire equals _runs_packed_jit's."""
    aln, lo, hi = _big_genome()
    names = aln.genome_names()
    leaves = [n for n in names if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], (leaves[-1] if leaves[-1] != leaves[0] else names[0])
    assert aln.open_genome(src).length > 2 ** 31
    pt = st.PathData.build(aln, src, tgt, device="cpu")
    assert pt.coord_kind == "uint32" and pt.levels[0].u32
    got = st.map_batch(pt, lo, hi)
    assert _pairs_with_owner(*got) == _host_pairs(aln, src, tgt, lo, hi)
    want = sj.map_batch(sj.PathData.build(aln, src, tgt), lo, hi)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    J, T, *_ = _run_both(aln, src, tgt, lo, hi)
    _assert_same_run(J, T, full=False)
    _assert_same_wire(aln, tgt, lo, J[0], T[0])


def _assert_same_wire(aln, tgt, lo, FJ, FT, out_cols=None, len_bits=8,
                      exc_cap=None):
    """runs_packed's wire, run total and overflow equal _runs_packed_jit's
    on equal fragment matrices."""
    tg = aln.open_genome(tgt)
    if out_cols is None:
        out_cols = sj._bucket_cap(int((FJ[st.C_VALID] > 0).sum()))
    dt = jnp.asarray(FJ).dtype
    wj, tj, oj = sj._runs_packed_jit(jnp.asarray(FJ), jnp.asarray(lo, dt),
                                     sj.target_seq_grid(tg), out_cols,
                                     len_bits, exc_cap)
    pt_dt = torch.int32 if FT.dtype == np.int32 else torch.int64
    wt, tt, ot = st.runs_packed(torch.from_numpy(FT),
                                torch.from_numpy(np.asarray(lo)).to(pt_dt),
                                st.target_seq_grid(tg, device="cpu"),
                                out_cols, len_bits, exc_cap)
    w = st.wire_to_host(wt)
    assert w.dtype == np.uint32
    if exc_cap is None:
        assert len(w) == sj.wire_words(out_cols, len(lo))
    assert w.tobytes() == np.asarray(wj).tobytes()
    assert int(tt) == int(tj)
    assert bool(ot) == bool(oj)
    return bool(ot)


@pytest.mark.parametrize("case", list(CASES))
def test_runs_packed_wire_equals_jax(case):
    """test_device_runs.py's cases (:90, :113): the wire is byte-identical,
    and it decodes to the host oracle's runs."""
    aln, src, tgt, lo, hi = CASES[case]()
    J, T, *_ = _run_both(aln, src, tgt, lo, hi)
    assert not _assert_same_wire(aln, tgt, lo, J[0], T[0])
    # overflow paths: too few columns, too few length bits, a tiny escape
    # region — flags and bytes still agree
    assert _assert_same_wire(aln, tgt, lo, J[0], T[0], out_cols=2)
    assert _assert_same_wire(aln, tgt, lo, J[0], T[0], len_bits=2)
    _assert_same_wire(aln, tgt, lo, J[0], T[0], exc_cap=1)
    # decoded runs equal test_device_runs.py's host oracle
    from test_device_runs import _host_runs

    wire, total, ovf = st.runs_packed(
        torch.from_numpy(T[0]), torch.from_numpy(np.asarray(lo, np.int32)),
        st.target_seq_grid(aln.open_genome(tgt), device="cpu"),
        sj._bucket_cap(int((T[0][st.C_VALID] > 0).sum())), 8)
    dec = tables.decode_runs_packed(
        st.wire_to_host(wire), int(total), lo,
        sj._bucket_cap(int((T[0][st.C_VALID] > 0).sum())), 8)
    s_lo, s_hi, t_lo, t_hi, rev, own, dupes = dec
    rows = [(int(own[i]), int(s_lo[i]), int(s_hi[i]), int(t_lo[i]),
             int(t_hi[i]), int(rev[i])) for i in range(len(own))
            if not dupes[own[i]]]
    want = [r for r in _host_runs(aln, src, tgt, lo, hi)
            if not dupes[r[0]]]
    assert sorted(rows) == want


@pytest.mark.parametrize("case", list(CASES) + ["options3", "big_u32"])
def test_kernel_lookup_on_paged_levels_equals_jax(monkeypatch, case):
    """Levels carry page tables (page limit 4, as segmap_jax's paged
    fixtures) while the port's lookups take the searchsorted kernel (its
    limit left at the default): _run_path's fragment matrix and
    runs_packed's wire still equal segmap_jax's paged results slot for
    slot (valid columns only on the uint32 path, as everywhere)."""
    monkeypatch.setattr(sj, "_PALLAS_GRID_LIMIT", 4)
    monkeypatch.setattr(st, "_PAGE_GRID_LIMIT", 4)
    build = {}
    if case == "options3":
        aln, src, tgt, lo, hi = _runs_fixture(3)
        build = dict(min_length=3)
    elif case == "big_u32":
        aln, lo, hi = _big_genome()
        leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
        src, tgt = leaves[0], leaves[-1]
    else:
        aln, src, tgt, lo, hi = CASES[case]()
    J, T, pj, pt, caps = _run_both(aln, src, tgt, lo, hi, **build)
    paged = [lv for lv in pt.levels if lv.page_tab is not None]
    assert paged and all(lv.fences8 is not None for lv in paged)
    assert all(lv.page_tab is not None for lv in pj.levels
               if lv.grid.shape[0] > 4)
    assert not bool(T[2])
    u32 = case == "big_u32"
    _assert_same_run(J, T, full=not u32)
    _assert_same_wire(aln, tgt, lo, J[0], T[0])
    # the kernel (its plain version here) served every lookup
    seen = []
    real = st.kernels.searchsorted_right_u32 if u32 else \
        st.kernels.searchsorted_right
    monkeypatch.setattr(st.kernels, real.__name__,
                        lambda g, q, f=None: seen.append(f) or real(g, q, f))
    st._run_path(pt, st.coords(pt, lo), st.coords(pt, hi),
                 torch.arange(len(lo), dtype=pt.dtype), caps)
    assert len(seen) == 2 * len(caps) and all(f is not None for f in seen)


@pytest.mark.parametrize("case", ["paged", "big_u32"])
def test_compaction_programs_equal_jax(monkeypatch, case):
    """compact, compact_packed and compact_u32_fixed (at the host-sized
    out_cols and at a quarter of it, which overflows) on the fragment
    matrices of test_segmap_jax's paged and uint32 fixtures are element-
    equal to segmap_jax's _compact_jit, _compact_packed_jit and
    _compact_u32_fixed_jit on its own; decode_u32_fixed equals its
    decode_u32_fixed; compact's rows are the valid columns in order."""
    if case == "paged":
        monkeypatch.setattr(sj, "_PALLAS_GRID_LIMIT", 4)
        monkeypatch.setattr(st, "_PAGE_GRID_LIMIT", 4)
        aln = create_random_alignment(seed=5, max_genomes=5, min_segments=8,
                                      max_segments=40, min_segment_length=3,
                                      max_segment_length=9)
        leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
        rng = np.random.default_rng(5)
        g = aln.open_genome(leaves[0])
        lo = rng.integers(0, g.length - 2, 16)
        hi = np.minimum(lo + rng.integers(1, 40, 16), g.length)
    else:
        aln, lo, hi = _big_genome()
        leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    src, tgt = leaves[0], leaves[-1]
    J, T, pj, pt, caps = _run_both(aln, src, tgt, lo, hi)
    FJ, FT = jnp.asarray(J[0]), torch.from_numpy(T[0])
    assert not bool(J[2]) and not bool(T[2])

    a, ta = sj._compact_jit(FJ)
    b, tb = st.compact(FT)
    assert b.numpy().dtype == np.asarray(a).dtype or case == "big_u32"
    assert np.array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype))
    assert int(tb) == int(ta) > 0 and tb.dtype == torch.int32
    valid = T[0][st.C_VALID] > 0
    assert np.array_equal(b.numpy()[:, :int(tb)], T[0][:6, valid])

    a1, a2, ta = sj._compact_packed_jit(FJ)
    b1, b2, tb = st.compact_packed(FT)
    assert np.array_equal(b1.numpy(), np.asarray(a1).astype(b1.numpy().dtype))
    assert b2.dtype == torch.int32 and np.array_equal(b2.numpy(), np.asarray(a2))
    assert int(tb) == int(ta)

    _totals, final_rows = sj.host_level_totals(aln, src, tgt, lo, hi,
                                               with_final=True)
    out_cols = sj._bucket_cap(final_rows)
    for oc, ovf in ((out_cols, False), (max(out_cols // 4, 1), True)):
        a, ta, oa = sj._compact_u32_fixed_jit(FJ, oc, 8)
        b, tb, ob = st.compact_u32_fixed(FT, oc, 8)
        host = st.wire_to_host(b)
        assert host.shape == (3, oc) and np.array_equal(host, np.asarray(a))
        assert int(tb) == int(ta) == final_rows
        assert bool(ob) == bool(oa) == ovf
        k = min(int(ta), oc)
        for x, y in zip(st.decode_u32_fixed(host, k, 8),
                        sj.decode_u32_fixed(np.asarray(a), k, 8)):
            assert np.array_equal(x, y)
    # a packing the rows do not fit (a len >= 2^1) raises the flag
    _b, tb, ob = st.compact_u32_fixed(FT, out_cols, 1)
    _a, ta, oa = sj._compact_u32_fixed_jit(FJ, out_cols, 1)
    assert bool(ob) and bool(oa) and int(tb) == int(ta)

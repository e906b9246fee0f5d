"""The port's device column engine (hal_tpu_torch.ops.column_torch), the
self-ring level (segmap_torch.build_selfring_level) and its hal2maf CLI on
the CPU, held against the JAX package on the same seeded inputs: level
tables, per-program (out, total, overflow), keyed window fragments, MAF
bytes against the exact DFS engine (the nine cases of
tests/test_column_jax.py) and CLI bytes.  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from hal_tpu.io.maf_io import MafBlockBuilder as JaxBuilder
from hal_tpu.ops import column_jax as jc
from hal_tpu.ops import segmap_jax as sj
from hal_tpu.ops.column import iter_slices_exact
from hal_tpu.randgen import create_random_alignment as jax_random_alignment
from hal_tpu.storage import save_alignment
from hal_tpu_torch.io.maf_io import MafBlockBuilder
from hal_tpu_torch.ops import column_torch as ct
from hal_tpu_torch.ops import segmap_torch as st
from hal_tpu_torch.ops import tables
from hal_tpu_torch.ops.column import compute_scope
from hal_tpu_torch.randgen import create_random_alignment


def _kw(seed):
    # tests/test_column_jax.py's fixture
    return dict(seed=seed, max_genomes=7, min_genomes=5, min_segments=6,
                max_segments=30, min_segment_length=3, max_segment_length=12)


_ALNS: dict = {}


def _alns(seed):
    """(port alignment, JAX-package alignment) of one seed, built once."""
    if seed not in _ALNS:
        _ALNS[seed] = (create_random_alignment(**_kw(seed)),
                       jax_random_alignment(**_kw(seed)))
    return _ALNS[seed]


def _export(aln, ref, slices, builder=MafBlockBuilder, **kw):
    b = builder(aln, ref, ucsc_names=True, **kw)
    blocks = list(b.feed(slices))
    t = b.flush_end()
    if t:
        blocks.append(t)
    return "\n".join(blocks)


def _want(ref_aln, ref, ge, **kw):
    """The JAX package's exact-DFS MAF text of [0, ge)."""
    builder_kw = {k: kw.pop(k) for k in ("max_block_len",) if k in kw}
    return _export(ref_aln, ref, iter_slices_exact(ref_aln, ref, 0, ge, **kw),
                   JaxBuilder, **builder_kw)


def _refs(aln):
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    return [r for r in (leaves[0], aln.root_name)
            if aln.open_genome(r).length]


# ------------------------------------------------------------- levels

@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int64],
                         ids=["int32", "uint32", "int64"])
def test_build_selfring_level_equals_jax(dtype):
    """Every genome's self-ring level: the same grid, segment table, ring
    member table, max ring and page table as segmap_jax's (uint32 levels
    hold the same values as int64, marked u32)."""
    port, ref_aln = _alns(11)
    n_rings = 0
    for name in port.genome_names():
        if not port.open_genome(name).num_top_segments:
            continue
        got = st.build_selfring_level(port, name, tables.RingTables(port),
                                      dtype, device="cpu")
        want = sj.build_selfring_level(ref_aln, name, dtype)
        assert got.kind == want.kind == "down"
        assert got.max_ring == want.max_ring
        assert got.u32 == (dtype == np.uint32)
        for f in ("grid", "seg_table", "ring_mem_tab"):
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert a.shape == b.shape and np.array_equal(a, b.astype(np.int64)), f
        assert (got.page_tab is None) == (want.page_tab is None)
        assert got.page_shift == want.page_shift
        n_rings += got.max_ring > 0
    assert n_rings, "fixture must carry paralogy rings"


def count_ring_builds(monkeypatch, aln) -> list:
    """The names of the genomes whose ring CSR tables._build_ring_csr
    builds from now on, one entry a call."""
    built = []
    build = tables._build_ring_csr

    def counting(ring, reversed_):
        built.append(next(n for n in aln.genome_names()
                          if aln.open_genome(n).top_paralogy is ring))
        return build(ring, reversed_)

    monkeypatch.setattr(tables, "_build_ring_csr", counting)
    return built


def test_engine_builds_each_level_once(monkeypatch):
    """Each op's Level is built once, and each genome's ring CSR once: the
    host twin, the down and self-ring levels and split_plan share it."""
    port, _ = _alns(42)
    ref = _refs(port)[0]
    built = count_ring_builds(monkeypatch, port)
    eng = ct.DeviceColumnEngine(port, ref, device="cpu")
    ops = {op for _t, spec, _lv, _m in eng.jobs for op in spec.ops}
    assert set(eng.levels) == ops
    for _t, spec, levels, _m in eng.jobs:
        assert all(lv is eng.levels[op] for op, lv in zip(spec.ops, levels))
    read = ({op[1] for op in ops if op[0] == "selfring"}
            | {op[2] for op in ops if op[0] == "down"})
    ringed = {n for n in read
              if (port.open_genome(n).top_paralogy != -1).any()}
    assert ringed and sorted(built) == sorted(ringed)


# ----------------------------------------------------------- programs

@pytest.mark.parametrize("seed", [11, 42])
def test_program_body_equals_jax(seed):
    """(out, total, overflow) of every program equal JAX run_program's, at
    the engine's caps and with out_cols cut below the fragment count (the
    dropped columns and the overflow flag included)."""
    port, ref_aln = _alns(seed)
    run = jc._get_col_jit()
    for ref in _refs(port):
        ge = int(port.open_genome(ref).length)
        eng = ct.DeviceColumnEngine(port, ref, device="cpu")
        jeng = jc.DeviceColumnEngine(ref_aln, ref)
        assert [(t, s.ordinal, s.ops) for t, s, _l, _m in eng.jobs] == \
            [(t, s.ordinal, s.ops) for t, s, _l, _m in jeng.jobs]
        lo = torch.tensor([0], dtype=eng.coord_dtype)
        hi = torch.tensor([ge], dtype=eng.coord_dtype)
        jlo = np.asarray([0], jeng.dtype)
        jhi = np.asarray([ge], jeng.dtype)
        cut = 0
        for ji, (_t, _s, levels, meta) in enumerate(eng.jobs):
            caps, oc = eng._size(ji, 0, ge)
            assert (caps, oc) == jeng._size(ji, 0, ge)
            assert meta == jeng.jobs[ji][3]
            for out_cols in (oc, 5):
                got = ct.run_program(levels, lo, hi, caps, meta, out_cols)
                want = run(jeng.jobs[ji][2], jlo, jhi, caps, meta, out_cols)
                assert got[0].shape == (5, out_cols)
                assert np.array_equal(got[0].numpy(),
                                      np.asarray(want[0]).astype(np.int64))
                assert int(got[1]) == int(want[1])
                assert bool(got[2]) == bool(want[2])
                cut += bool(got[2])
        assert cut, "the cut out_cols must overflow some program"


@pytest.mark.parametrize("seed,dtype", [(11, None), (42, None),
                                        (11, np.uint32)],
                         ids=["11", "42", "11-uint32"])
def test_window_frags_equal_jax(seed, dtype):
    """Keyed window fragments equal the JAX engine's, whole-genome and in
    two windows, and again after the cached output widths were cut so that
    the window overflows and is re-sized exactly; a uint32 engine runs
    int64 tensors on u32 levels."""
    port, ref_aln = _alns(seed)

    def assert_equal(got, want):
        assert got.keys() == want.keys()
        for t in want:
            assert [o for o, _ in got[t]] == [o for o, _ in want[t]]
            for (_o, a), (_p, b) in zip(got[t], want[t]):
                for f in ("s_lo", "t_lo", "ln", "rev", "key"):
                    x, y = getattr(a, f), getattr(b, f)
                    assert x.dtype == y.dtype and np.array_equal(x, y)

    for ref in _refs(port):
        ge = int(port.open_genome(ref).length)
        eng = ct.DeviceColumnEngine(port, ref, dtype=dtype, device="cpu")
        jeng = jc.DeviceColumnEngine(
            ref_aln, ref, dtype=None if dtype is None else np.dtype(dtype))
        if dtype is not None:
            assert eng.coord_dtype == torch.int64
            assert all(lv.u32 for lv in eng.levels.values())
        for gs, we in ((0, ge), (0, ge // 2), (ge // 2, ge)):
            assert_equal(eng.window_frags(gs, we), jeng.window_frags(gs, we))
        cut = {k: (caps, 5) for k, (caps, _oc) in eng._caps.items()
               if k[1] == ge}
        eng._caps.update(cut)
        assert_equal(eng.window_frags(0, ge), jeng.window_frags(0, ge))
        assert any(eng._caps[k][1] > 5 for k in cut), \
            "the cut widths must overflow and be re-sized"


@pytest.mark.parametrize("dtype,ks,raises", [
    (np.int32, 2 ** 31 - 1, False), (np.int32, 2 ** 31, True),
    (np.uint32, 2 ** 31, False), (np.uint32, 2 ** 32, True),
    (np.int64, 2 ** 32, False), (np.int64, 2 ** 62, True)])
def test_key_space_guard_as_jax(monkeypatch, dtype, ks, raises):
    """The engine refuses a program where the JAX engine does: against the
    range of the JAX dtype it picked (2^31, 2^32, 2^62), not the range of
    the int64 tensors a uint32 engine runs."""
    port, ref_aln = _alns(3)
    ref = _refs(port)[0]
    for cls in (ct.ColumnHostSim, jc.ColumnHostSim):
        monkeypatch.setattr(cls, "key_space", lambda self, spec: ks)
    outcome = []
    for make in (lambda: ct.DeviceColumnEngine(port, ref, dtype=dtype,
                                               device="cpu"),
                 lambda: jc.DeviceColumnEngine(ref_aln, ref,
                                               dtype=np.dtype(dtype))):
        try:
            make()
            outcome.append(None)
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]
    assert (outcome[0] is not None) == raises
    if raises:
        with pytest.raises(ct.KeySpaceError, match="DFS key space"):
            ct.DeviceColumnEngine(port, ref, dtype=dtype, device="cpu")


def test_key_space_picked_dtype_equals_jax():
    """The engine picks the JAX engine's dtype and key spaces."""
    port, ref_aln = _alns(3)
    ref = _refs(port)[0]
    eng = ct.DeviceColumnEngine(port, ref, device="cpu")
    assert eng.dtype == np.dtype(jc.DeviceColumnEngine(ref_aln, ref).dtype)
    sim = ct.ColumnHostSim(port)
    jsim = jc.ColumnHostSim(ref_aln)
    for _t, spec, _l, _m in eng.jobs:
        assert sim.key_space(spec) == jsim.key_space(spec) >= 1


# ------------------------------------------------- MAF bytes (9 cases)

@pytest.mark.parametrize("seed", [3, 11, 21, 42, 77])
def test_hostsim_byte_equal_exact(seed):
    """The port's host twin (iter_slices_hostsim) == the JAX package's exact
    DFS MAF, leaf, last-leaf and root references."""
    port, ref_aln = _alns(seed)
    leaves = [n for n in port.genome_names() if port.tree.is_leaf(n)]
    for ref in (leaves[0], leaves[-1], port.root_name):
        ge = int(port.open_genome(ref).length)
        if ge:
            assert _export(port, ref, ct.iter_slices_hostsim(
                port, ref, 0, ge)) == _want(ref_aln, ref, ge), ref


@pytest.mark.parametrize("seed", [11, 42])
def test_device_engine_byte_equal_exact(seed):
    port, ref_aln = _alns(seed)
    for ref in _refs(port):
        ge = int(port.open_genome(ref).length)
        eng = ct.DeviceColumnEngine(port, ref, device="cpu")
        assert _export(port, ref, eng.window_slices(0, ge)) == \
            _want(ref_aln, ref, ge), ref


def test_device_engine_windowed_matches_single_window():
    """Windows through ONE persistent builder equal the single-window
    export."""
    port, ref_aln = _alns(21)
    ref = [n for n in port.genome_names() if port.tree.is_leaf(n)][0]
    ge = int(port.open_genome(ref).length)
    eng = ct.DeviceColumnEngine(port, ref, device="cpu")
    b = MafBlockBuilder(port, ref, ucsc_names=True)
    blocks = []
    w = max(ge // 3, 1)
    for pos in range(0, ge, w):
        blocks.extend(b.feed(eng.window_slices(pos, min(pos + w, ge))))
    t = b.flush_end()
    if t:
        blocks.append(t)
    assert "\n".join(blocks) == _want(ref_aln, ref, ge)


def test_device_engine_filters():
    """noAncestors and target filtering (targets include the reference)."""
    port, ref_aln = _alns(77)
    leaves = [n for n in port.genome_names() if port.tree.is_leaf(n)]
    ref = leaves[0]
    ge = int(port.open_genome(ref).length)
    eng = ct.DeviceColumnEngine(port, ref, no_ancestors=True, device="cpu")
    assert _export(port, ref, eng.window_slices(0, ge)) == \
        _want(ref_aln, ref, ge, no_ancestors=True)
    targets = set(leaves[:2]) | {ref}
    scope = port.tree.spanning_tree(sorted(targets))
    eng = ct.DeviceColumnEngine(port, ref, scope=scope, targets=targets,
                                device="cpu")
    assert _export(port, ref, eng.window_slices(0, ge)) == \
        _want(ref_aln, ref, ge, scope=scope, targets=targets)


def test_program_enumeration_equals_jax():
    """build_programs: the same programs, ordinals and ops as the JAX
    package's (MAIN first on the reference chain, last off it)."""
    port, ref_aln = _alns(11)
    leaves = [n for n in port.genome_names() if port.tree.is_leaf(n)]
    for ref in (leaves[0], port.root_name):
        scope, root = compute_scope(port, ref)
        for kw in ({}, dict(no_dupes=True), dict(only_orthologs=True)):
            got = ct.build_programs(port, ref, scope, root, **kw)
            want = jc.build_programs(ref_aln, ref, scope, root, **kw)
            assert got.keys() == want.keys()
            for t in want:
                assert [(s.target, s.ordinal, s.ops) for s in got[t]] == \
                    [(s.target, s.ordinal, s.ops) for s in want[t]]
            mains = [s for s in got[ref] if not s.ops]
            assert len(mains) == 1 and mains[0].ordinal == 0


def test_native_assembler_byte_equal():
    """Device fragments -> the native C++ assembler (two windows through
    one exporter) equal the native DFS engine's bytes, through the port's
    column_native binding."""
    from hal_tpu_torch.ops.column_native import NativeMafExporter, available

    if not available():
        pytest.skip("native column engine not built")
    for seed in (11, 77):
        port, _ = _alns(seed)
        for ref in _refs(port):
            ge = int(port.open_genome(ref).length)
            ex1 = NativeMafExporter(port, ref)
            want = ex1.export(0, ge) + ex1.finish()
            ex1.close()
            eng = ct.DeviceColumnEngine(port, ref, device="cpu")
            ex2 = NativeMafExporter(port, ref)
            got = eng.export_native(ex2, 0, ge // 2)
            got += eng.export_native(ex2, ge // 2, ge) + ex2.finish()
            ex2.close()
            assert got == want and got, (seed, ref)


def test_device_engine_nodupes_onlyorthologs():
    for seed in (11, 77):
        port, ref_aln = _alns(seed)
        for ref in _refs(port):
            ge = int(port.open_genome(ref).length)
            for kw in (dict(no_dupes=True), dict(only_orthologs=True)):
                eng = ct.DeviceColumnEngine(port, ref, device="cpu", **kw)
                assert _export(port, ref, eng.window_slices(0, ge)) == \
                    _want(ref_aln, ref, ge, **kw), (seed, ref, kw)


def _multi_sequence(pkg):
    """tests/test_column_jax.py's two-genome, two-sequence alignment, built
    with either package's classes."""
    import importlib

    Alignment = importlib.import_module(pkg + ".alignment").Alignment
    genome = importlib.import_module(pkg + ".genome")
    aln = Alignment()
    aln.add_root_genome("Anc", [genome.SequenceInfo("sA", 12, 0, 3),
                                genome.SequenceInfo("sB", 8, 0, 2)])
    aln.tree.add_child("Anc", "X", 0.1)
    anc = aln.open_genome("Anc")
    anc.bot_start[:-1] = [0, 4, 8, 12, 16]
    anc.bot_child = np.array([[0], [1], [3], [2], [4]], np.int64)
    anc.bot_child_reversed = np.array([[0], [0], [1], [0], [0]], np.uint8)
    x = genome.GenomeArrays.create("X", [genome.SequenceInfo("x1", 12, 3, 0),
                                         genome.SequenceInfo("x2", 8, 2, 0)],
                                   num_children=0)
    x.top_start[:-1] = [0, 4, 8, 12, 16]
    x.top_parent = np.array([0, 1, 3, 2, 4], np.int64)
    x.top_parent_reversed = np.array([0, 0, 0, 1, 0], np.uint8)
    aln.set_genome(x)
    rng = np.random.default_rng(1)
    dna = np.frombuffer(b"ACGT", dtype=np.uint8)
    anc.set_dna(0, dna[rng.integers(0, 4, 20)])
    out = np.empty(20, np.uint8)
    for i in range(5):
        p = int(x.top_parent[i])
        out[i * 4:(i + 1) * 4] = anc.get_dna(
            p * 4, 4, reversed_=bool(x.top_parent_reversed[i]))
    x.set_dna(0, out)
    return aln


def test_device_engine_multi_sequence():
    """Several sequences per genome: per-sequence entry keys, sequence
    boundary cuts, also at --maxBlockLen 3."""
    from hal_tpu.ops.validate import validate_alignment

    port = _multi_sequence("hal_tpu_torch")
    ref_aln = _multi_sequence("hal_tpu")
    validate_alignment(ref_aln)
    for ref in ("Anc", "X"):
        ge = int(port.open_genome(ref).length)
        eng = ct.DeviceColumnEngine(port, ref, device="cpu")
        for mbl in (None, 3):
            kw = {} if mbl is None else dict(max_block_len=mbl)
            got = _export(port, ref, eng.window_slices(0, ge), **kw)
            assert got == _want(ref_aln, ref, ge, **kw) and got, (ref, mbl)


# --------------------------------------------------------------- hal2maf

@pytest.fixture(scope="module")
def halz(tmp_path_factory):
    aln = jax_random_alignment(seed=5, max_genomes=6, min_genomes=5,
                               mean_degree=1.4, min_segments=8,
                               max_segments=40, min_segment_length=4,
                               max_segment_length=20)
    d = tmp_path_factory.mktemp("port_hal2maf")
    path = str(d / "aln.halz")
    save_alignment(aln, path, fmt="halz")
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    return path, aln, leaves, d


@pytest.mark.parametrize("flags", [
    [], ["--noDupes"], ["--noAncestors"], ["--onlyOrthologs"],
    ["--targets"], ["--refSequence"], ["--maxRefGap", "4"], ["--unique"],
    ["--maxBlockLen", "7"], ["--global"]],
    ids=["default", "noDupes", "noAncestors", "onlyOrthologs", "targets",
         "refSequence", "maxRefGap", "unique", "maxBlockLen", "global"])
def test_hal2maf_cli_equals_jax(halz, flags, capsys):
    """The port's hal2maf --device cpu bytes equal hal_tpu's hal2maf with
    --device (its column engine) and without (the native DFS engine); flags
    outside the engine's surface take the host engines with the original's
    stderr line."""
    from hal_tpu.tools import hal2maf as jax_cli
    from hal_tpu_torch.tools import hal2maf as port_cli

    path, aln, leaves, d = halz
    ref = leaves[0]
    if flags == ["--targets"]:
        flags = ["--targetGenomes", ",".join([ref] + leaves[-2:])]
    elif flags == ["--refSequence"]:
        g = aln.open_genome(ref)
        flags = ["--refSequence", g.seq_names[-1], "--start", "2"]
    name = "_".join(f.strip("-") for f in flags) or "default"
    base = [path, "--refGenome", ref] + flags
    outs, errs = [], []
    for k, (cli, extra) in enumerate(((port_cli, ["--device", "cpu"]),
                                      (jax_cli, ["--device"]),
                                      (jax_cli, []))):
        out = str(d / ("maf_%s_%d.maf" % (name, k)))
        cli.run([base[0], out] + base[1:] + extra)
        outs.append(open(out, "rb").read())
        errs.append(capsys.readouterr().err)
    assert outs[0] and outs[0] == outs[1] == outs[2]
    assert errs[0] == errs[1]
    host = bool({"--maxRefGap", "--unique", "--global"} & set(flags))
    assert ("engine=device" in errs[0]) != host
    assert ("does not cover this flag set" in errs[0]) == host


def test_hal2maf_cli_key_space_fallback(halz, monkeypatch, capsys):
    """A request whose DFS key space the engine refuses falls back to the
    native engine with the original's message; the bytes stay equal."""
    from hal_tpu.tools import hal2maf as jax_cli
    from hal_tpu_torch.tools import hal2maf as port_cli

    path, _aln, leaves, d = halz
    monkeypatch.setattr(ct.ColumnHostSim, "key_space", lambda self, s: 2 ** 62)
    a, b = str(d / "ks_port.maf"), str(d / "ks_jax.maf")
    port_cli.run([path, a, "--refGenome", leaves[0], "--device", "cpu"])
    err = capsys.readouterr().err
    assert "device engine unavailable (DFS key space" in err
    assert "engine=device" not in err
    jax_cli.run([path, b, "--refGenome", leaves[0]])
    assert open(a, "rb").read() == open(b, "rb").read()


def test_hal2maf_cli_device_failure_raises(halz, monkeypatch):
    """Any other failure of the device engine raises; nothing falls back."""
    from hal_tpu_torch.tools import hal2maf as port_cli

    path, _aln, leaves, d = halz

    def broken(*a, **k):
        raise RuntimeError("CUDA launch failed")

    monkeypatch.setattr(ct.DeviceColumnEngine, "__init__", broken)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        port_cli.run([path, str(d / "never.maf"), "--refGenome", leaves[0],
                      "--device", "cpu"])

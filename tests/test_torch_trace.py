"""The port's tracer (hal_tpu_torch.tracing) and the spans and counters of
the MAF path on the CPU: a window exported as hal2maf's device path
exports a region (DeviceColumnEngine.export_native into a new
NativeMafExporter, then finish and close).  Off, it records nothing; on,
it records each named step of the window once, inside the call that runs
it (the dispatch and its wait twice, with the re-size between, where the
capacities overflow; the assembler's plan and write inside its entry
machine), counts the programs' fragments and those the post-split cuts
or leaves as they are, and the columns the assembler wrote directly or
left staged in the open block, and leaves the MAF bytes and the device
reads of the window as they are."""

import numpy as np

import pytest
import torch

from hal_tpu_torch import tracing
from hal_tpu_torch.ops import column_native
from hal_tpu_torch.ops import column_torch as ct
from hal_tpu_torch.randgen import create_random_alignment
from test_torch_postsplit import star

SEEDS = (11, 42, 77)
COLUMN = ("column.dispatch", "column.sync", "column.drain", "column.collect",
          "column.postsplit")
ASSEMBLY = ("assembly.gather", "assembly.sort", "assembly.entry_machine",
            "assembly.plan", "assembly.write")
EXPORTER = ("assembly.init", "assembly.close")
COUNTERS = ("column.frag_cols", "column.drain_cols",
            "column.postsplit_frags", "column.postsplit_skipped",
            "assembly.direct_cols", "assembly.staged_cols")

_ENGINES: dict = {}


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _engine(seed):
    """(alignment, reference leaf, engine warmed on the whole leaf), built
    once a seed."""
    if not column_native.available():
        pytest.skip("native column engine not built")
    if seed not in _ENGINES:
        aln = create_random_alignment(
            seed=seed, max_genomes=7, min_genomes=5, min_segments=6,
            max_segments=30, min_segment_length=3, max_segment_length=12)
        ref = [n for n in aln.genome_names() if aln.tree.is_leaf(n)
               and aln.open_genome(n).length][0]
        eng = ct.DeviceColumnEngine(aln, ref, device="cpu")
        _ENGINES[seed] = (aln, ref, eng)
        _window(seed)
    return _ENGINES[seed]


def _window(seed):
    aln, ref, eng = _ENGINES[seed]
    ex = column_native.NativeMafExporter(aln, ref)
    try:
        return eng.export_native(ex, 0, int(aln.open_genome(ref).length)) \
            + ex.finish()
    finally:
        ex.close()


@pytest.mark.parametrize("seed", SEEDS)
def test_tracing_off_records_nothing(seed):
    _engine(seed)
    assert _window(seed)
    assert tracing.take() == ([], {})


@pytest.mark.parametrize("seed", SEEDS)
def test_each_step_is_recorded_once_inside_its_call(seed, monkeypatch):
    _engine(seed)
    calls = {}

    def timed(cls, attr):
        orig = getattr(cls, attr)

        def wrapped(*a, **kw):
            t0 = tracing.clock()
            try:
                return orig(*a, **kw)
            finally:
                calls.setdefault(attr, []).append((t0, tracing.clock()))
        monkeypatch.setattr(cls, attr, wrapped)

    timed(ct.DeviceColumnEngine, "window_frags")
    timed(column_native.NativeMafExporter, "export_frags")
    tracing.enable()
    _window(seed)
    spans, counts = tracing.take()
    assert sorted(n for n, _s, _e in spans) == \
        sorted(COLUMN + ASSEMBLY + EXPORTER)
    assert sorted(counts) == sorted(COUNTERS)
    (w0, w1), = calls["window_frags"]
    (x0, x1), = calls["export_frags"]
    at = {n: (s, e) for n, s, e in spans}
    for name in COLUMN:
        assert w0 <= at[name][0] <= at[name][1] <= w1, name
    for name in ASSEMBLY:
        assert x0 <= at[name][0] <= at[name][1] <= x1, name
    m0, m1 = at["assembly.entry_machine"]
    assert m0 <= at["assembly.plan"][0] <= at["assembly.plan"][1] \
        <= at["assembly.write"][0] <= at["assembly.write"][1] <= m1
    assert at["assembly.init"][1] <= w0 and at["assembly.close"][0] >= x1


@pytest.mark.parametrize("seed", SEEDS)
def test_frag_cols_counts_the_programs_fragments(seed, monkeypatch):
    aln, ref, eng = _engine(seed)
    seen = []
    orig = ct.DeviceColumnEngine._postsplit

    def postsplit(self, frags):
        seen.append(sum(len(st_.s_lo) for parts in frags.values()
                        for _o, st_ in parts))
        return orig(self, frags)
    monkeypatch.setattr(ct.DeviceColumnEngine, "_postsplit", postsplit)
    tracing.enable()
    _window(seed)
    _spans, counts = tracing.take()
    identity = sum(1 for spec in eng.programs.get(ref, []) if not spec.ops)
    assert seen and counts["column.frag_cols"] == seen[0] - identity
    assert counts["column.frag_cols"] <= counts["column.drain_cols"]


@pytest.mark.parametrize("seed", SEEDS)
def test_direct_and_staged_cols_are_the_assembled_columns(seed, monkeypatch):
    """assembly.direct_cols + assembly.staged_cols are the columns of the
    window that some fragment covers; staged_cols the width of the block
    left open, which finish() prints."""
    aln, ref, eng = _engine(seed)
    seen = []
    orig = column_native.NativeMafExporter.export_frags

    def export_frags(self, gs, ge, frags, **kw):
        seen.append((gs, ge, frags))
        return orig(self, gs, ge, frags, **kw)
    monkeypatch.setattr(column_native.NativeMafExporter, "export_frags",
                        export_frags)
    ge = int(aln.open_genome(ref).length)
    ex = column_native.NativeMafExporter(aln, ref)
    tracing.enable()
    try:
        eng.export_native(ex, 0, ge)
        counts = tracing.take()[1]
        tail = ex.finish()
    finally:
        ex.close()
    (gs, ge, frags), = seen
    covered = np.zeros(ge - gs, bool)
    for parts in frags.values():
        for _o, st_ in parts:
            for s, n in zip(st_.s_lo, st_.ln):
                covered[max(s, gs) - gs:min(s + n, ge) - gs] = True
    assert counts["assembly.direct_cols"] + counts["assembly.staged_cols"] \
        == covered.sum() > 0
    last = tail.decode().split("\n")[1].split("\t")[-1]
    assert counts["assembly.staged_cols"] == len(last) > 0


def _received(monkeypatch):
    """{(target, ordinal): fragments} of each call of _postsplit."""
    seen = []
    orig = ct.DeviceColumnEngine._postsplit

    def postsplit(self, frags):
        seen.append({(t, o): len(st_.s_lo) for t, parts in frags.items()
                     for o, st_ in parts})
        return orig(self, frags)
    monkeypatch.setattr(ct.DeviceColumnEngine, "_postsplit", postsplit)
    return seen


@pytest.mark.parametrize("seed", SEEDS)
def test_postsplit_counters_add_up_to_what_it_received(seed, monkeypatch):
    """column.postsplit_frags counts the fragments of the programs whose
    split plan keeps a grid (on these deeper trees, ancestors reached by
    down and the identity row), column.postsplit_skipped the rest."""
    _aln, _ref, eng = _engine(seed)
    seen = _received(monkeypatch)
    tracing.enable()
    _window(seed)
    _spans, counts = tracing.take()
    (got,) = seen
    cut = sum(n for k, n in got.items() if eng.plan[k])
    assert counts["column.postsplit_frags"] == cut > 0
    assert counts["column.postsplit_skipped"] == sum(got.values()) - cut > 0


def test_star_tree_counts_all_but_the_identity_row_as_skipped(monkeypatch):
    """On the benchmark's star tree the plan cuts the identity row alone,
    one fragment; off, nothing is recorded."""
    aln, ref = star(3100000001)
    eng = ct.DeviceColumnEngine(aln, ref, device="cpu")
    ge = int(aln.open_genome(ref).length)
    seen = _received(monkeypatch)
    eng.window_frags(0, ge)
    assert tracing.take() == ([], {})
    tracing.enable()
    eng.window_frags(0, ge)
    _spans, counts = tracing.take()
    n = sum(seen[-1].values())
    assert counts["column.postsplit_frags"] == 1
    assert counts["column.postsplit_skipped"] == n - 1 > 1000


@pytest.mark.parametrize("seed", SEEDS)
def test_maf_bytes_are_the_same_with_tracing_on(seed):
    _engine(seed)
    off = _window(seed)
    tracing.enable()
    on = _window(seed)
    assert on == off and on


@pytest.mark.parametrize("seed", SEEDS)
def test_device_reads_are_the_same_with_tracing_on(seed, monkeypatch):
    _engine(seed)
    reads = {"item": 0, "cpu": 0}
    for attr in reads:
        orig = getattr(torch.Tensor, attr)

        def counted(self, *a, _orig=orig, _attr=attr, **kw):
            reads[_attr] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, attr, counted)
    _window(seed)
    off = dict(reads)
    tracing.enable()
    _window(seed)
    on = {k: reads[k] - off[k] for k in reads}
    assert on == off and off["item"] >= 1 and off["cpu"] >= 2


@pytest.mark.parametrize("seed", SEEDS)
def test_an_overflowing_window_records_its_resize(seed):
    aln, ref, eng = _engine(seed)
    off = _window(seed)
    width = int(aln.open_genome(ref).length)
    for ji in range(len(eng.jobs)):
        caps, _oc = eng._caps[(ji, width)]
        eng._caps[(ji, width)] = (tuple(
            (1, 1) if isinstance(c, tuple) else 1 for c in caps), 1)
    tracing.enable()
    on = _window(seed)
    names = [n for n, _s, _e in tracing.take()[0]]
    assert on == off
    assert sorted(names) == sorted(COLUMN + ASSEMBLY + EXPORTER + (
        "column.dispatch", "column.sync", "column.resize"))


def test_a_span_whose_body_raises_is_closed():
    tracing.enable()
    with pytest.raises(KeyError):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise KeyError("x")
    spans, _counts = tracing.take()
    assert [n for n, _s, _e in spans] == ["inner", "outer"]
    (_, i0, i1), (_, o0, o1) = spans
    assert o0 <= i0 <= i1 <= o1


def test_off_span_is_one_shared_context_and_count_is_dropped():
    assert tracing.span("a") is tracing.span("b")
    tracing.count("c", 3)
    tracing.enable()
    tracing.count("c", 3)
    tracing.count("c", 4)
    assert tracing.span("a") is not tracing.span("a")
    assert tracing.take() == ([], {"c": 7})
    assert tracing.take() == ([], {})

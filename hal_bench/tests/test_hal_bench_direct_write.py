"""maf.plan_ms, maf.write_ms and maf.direct_write_pct, the readers of the
native assembler's plan and write spans and its direct and staged column
counters: their arithmetic on planted spans and counters, nothing where
the port records none of them, and a traced run of maf.window-4m at its
CPU test size, where only each window's last block is left staged."""

import pytest

from hal_bench import harness
from hal_bench.harness import Run
from hal_tpu_torch import tracing
from small import run_small

NAMES = ("maf.plan_ms", "maf.write_ms", "maf.direct_write_pct")


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    tracing.disable()
    tracing.take()


def _read(monkeypatch, spans, counts):
    """Each reader's value over two requests in [0, 10)."""
    monkeypatch.setattr(tracing, "take", lambda: (list(spans), dict(counts)))
    readers = {n: harness.load_module("layers", n) for n in NAMES}
    run = Run(setup_s=1.0, w0=0.0, w1=10.0,
              records=[(0, 0.0, 4.5, 100), (1, 4.5, 10.0, 100)])
    return {n: r.read(run) for n, r in readers.items()}


SPANS = [("assembly.entry_machine", 3.0, 4.0), ("assembly.plan", 3.1, 3.4),
         ("assembly.write", 3.4, 3.9), ("assembly.entry_machine", 8.0, 9.5),
         ("assembly.plan", 8.0, 8.5), ("assembly.write", 8.5, 9.5),
         ("assembly.write", 9.8, 10.6)]


@pytest.mark.parametrize("counts,want", [
    ({"assembly.direct_cols": 999, "assembly.staged_cols": 1}, 99.9),
    ({"assembly.direct_cols": 0, "assembly.staged_cols": 7}, 0.0),
    ({"assembly.direct_cols": 5, "assembly.staged_cols": 0}, 100.0),
    ({"assembly.direct_cols": 0, "assembly.staged_cols": 0}, None),
    ({"column.frag_cols": 300, "column.drain_cols": 400}, None),
])
def test_readers_on_planted_spans_and_counters(monkeypatch, counts, want):
    got = _read(monkeypatch, SPANS, counts)
    assert got["maf.plan_ms"] == pytest.approx(1e3 * (0.3 + 0.5) / 2)
    assert got["maf.write_ms"] == pytest.approx(1e3 * (0.5 + 1.0 + 0.2) / 2)
    pct = got["maf.direct_write_pct"]
    assert pct == (None if want is None else pytest.approx(want))


def test_a_port_without_the_spans_reads_nothing(monkeypatch):
    old = [n for n in SPANS if n[0] == "assembly.entry_machine"]
    assert _read(monkeypatch, old, {}) == dict.fromkeys(NAMES)


def test_traced_run_reads_the_plan_the_write_and_the_direct_share():
    r = run_small("maf.window-4m", 2 ** 31 + 47, trace=True)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["maf.plan_ms"]["value"] > 0 and m["maf.write_ms"]["value"] > 0
    assert m["maf.plan_ms"]["value"] + m["maf.write_ms"]["value"] <= \
        m["maf.entry_machine_ms"]["value"]
    assert 95 <= m["maf.direct_write_pct"]["value"] < 100

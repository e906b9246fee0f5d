"""maf.postsplit_skip_pct, the reader of the column engine's post-split
counters: its arithmetic on planted counters, nothing where the port
records no such counters, and a traced run of maf.window-4m at its CPU
test size, where only the identity row of each window is cut."""

import pytest

from hal_bench import harness
from hal_bench.harness import Run
from hal_tpu_torch import tracing
from small import run_small

NAME = "maf.postsplit_skip_pct"


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    tracing.disable()
    tracing.take()


def _read(monkeypatch, counts):
    monkeypatch.setattr(tracing, "take", lambda: ([], dict(counts)))
    reader = harness.load_module("layers", NAME)
    return reader.read(Run(setup_s=1.0, w0=0.0, w1=10.0,
                           records=[(0, 0.0, 10.0, 100)]))


@pytest.mark.parametrize("counts,want", [
    ({"column.postsplit_skipped": 999, "column.postsplit_frags": 1}, 99.9),
    ({"column.postsplit_skipped": 0, "column.postsplit_frags": 7}, 0.0),
    ({"column.postsplit_skipped": 5, "column.postsplit_frags": 0}, 100.0),
    ({"column.postsplit_skipped": 0, "column.postsplit_frags": 0}, None),
    ({"column.frag_cols": 300, "column.drain_cols": 400}, None),
])
def test_reader_on_planted_counters(monkeypatch, counts, want):
    got = _read(monkeypatch, counts)
    assert got == (None if want is None else pytest.approx(want))


def test_traced_run_reads_every_fragment_but_the_identity_row():
    r = run_small("maf.window-4m", 2 ** 31 + 43, trace=True)
    assert r["correct"], r["checks"]
    assert 99.9 <= r["metrics"][NAME]["value"] < 100

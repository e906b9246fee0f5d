"""The readers of the port's own spans and counters (hal_bench.program_trace
and the maf.* step metrics): their arithmetic on a made-up run, the idle
time named by the innermost step inside the port, a traced run at a tiny
size on the CPU, and an untraced run that never turns the tracer on.  On a
card: a span ends after the kernel it waits for, on the device trace's
clock."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from hal_bench import harness, program_trace
from hal_bench.harness import Run
from hal_tpu_torch import tracing
from small import run_small

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent

STEPS = ("maf.dispatch_ms", "maf.sync_wait_ms", "maf.drain_ms",
         "maf.drain_used_pct", "maf.collect_ms", "maf.postsplit_ms",
         "maf.exporter_ms", "maf.gather_ms", "maf.sort_ms",
         "maf.entry_machine_ms")
NEW = STEPS + ("maf.launch_us",)

# two windows in [0, 10): each step's span, and one span of the first
# window that starts before the run's window and one that ends after it
SPANS = [("assembly.init", -0.5, 0.5), ("column.dispatch", 0.5, 1.0),
         ("column.sync", 1.0, 1.5), ("column.drain", 1.5, 1.7),
         ("column.collect", 1.7, 2.0), ("column.postsplit", 2.0, 2.6),
         ("assembly.gather", 2.6, 2.8), ("assembly.sort", 2.8, 3.1),
         ("assembly.entry_machine", 3.1, 4.0), ("assembly.close", 4.0, 4.1),
         ("assembly.init", 5.0, 5.2), ("column.dispatch", 5.2, 5.9),
         ("column.sync", 5.9, 6.0), ("column.drain", 6.0, 6.4),
         ("column.collect", 6.4, 6.5), ("column.postsplit", 6.5, 7.0),
         ("assembly.gather", 7.0, 7.6), ("assembly.sort", 7.6, 8.0),
         ("assembly.entry_machine", 8.0, 9.5), ("assembly.close", 9.5, 10.4),
         ("column.sync", 11.0, 12.0)]
COUNTS = {"column.frag_cols": 300, "column.drain_cols": 400}
WANT = {"maf.dispatch_ms": 600.0, "maf.sync_wait_ms": 300.0,
        "maf.drain_ms": 300.0, "maf.drain_used_pct": 75.0,
        "maf.collect_ms": 200.0, "maf.postsplit_ms": 550.0,
        "maf.exporter_ms": 1e3 * (0.5 + 0.1 + 0.2 + 0.5) / 2,
        "maf.gather_ms": 400.0, "maf.sort_ms": 350.0,
        "maf.entry_machine_ms": 1200.0}


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    tracing.disable()
    tracing.take()


def _run(monkeypatch, spans=SPANS, counts=COUNTS):
    """Two requests over [0, 10) with the harness's span of each window's
    engine call; the port's tracer hands over `spans` and `counts`."""
    monkeypatch.setattr(tracing, "take", lambda: (list(spans), dict(counts)))
    r = Run(setup_s=1.0, w0=0.0, w1=10.0,
            records=[(0, 0.0, 4.5, 100), (1, 4.5, 10.0, 100)])
    r.spans = [("DeviceColumnEngine.window_frags", 0.4, 2.6),
               ("DeviceColumnEngine.window_frags", 5.1, 7.0)]
    return r


def _read(names, run):
    """Each reader's value, the readers loaded first as a traced run loads
    them."""
    readers = {n: harness.load_module("layers", n) for n in names}
    return {n: r.read(run) for n, r in readers.items()}


def test_each_reader_on_planted_spans_and_counters(monkeypatch):
    r = _run(monkeypatch)
    got = _read(NEW, r)
    assert got.pop("maf.launch_us") is None  # no device trace
    assert got == pytest.approx(WANT)
    assert not tracing.on


def test_launch_us_divides_dispatch_by_the_windows_kernels(monkeypatch):
    r = _run(monkeypatch)
    r.device = [("k1", 0.6, 0.7), ("k2", 0.8, 0.9), ("k1", 5.3, 5.4),
                ("Memcpy DtoH (Device -> Pageable)", 1.5, 1.6),
                ("Memset (Device)", 5.5, 5.6), ("k3", 5.6, 5.8)]
    got = _read(["maf.launch_us"], r)["maf.launch_us"]
    assert got == pytest.approx(1e6 * 1.2 / 4)


def test_harvest_clips_to_the_window_and_runs_once(monkeypatch):
    r = _run(monkeypatch)
    spans, counts = program_trace.harvest(r)
    assert ("assembly.init", 0.0, 0.5) in spans
    assert ("assembly.close", 9.5, 10.0) in spans
    assert not [s for s in spans if s[0] == "column.sync" and s[1] >= 10]
    assert counts == COUNTS and len(r.spans) == 2 + len(spans)
    assert program_trace.harvest(r) == (spans, counts)
    assert len(r.spans) == 2 + len(spans)


def test_breakdown_names_the_innermost_step_in_the_port(monkeypatch):
    r = _run(monkeypatch)
    r.device = [("k", 0.0, 0.5), ("k", 2.0, 2.6), ("k", 4.5, 10.0)]
    program_trace.harvest(r)
    gaps = dict(map(tuple, r.breakdown()["idle_gaps"]))
    assert gaps == pytest.approx({
        "column.dispatch": 0.5, "column.sync": 0.5, "column.drain": 0.2,
        "column.collect": 0.3, "assembly.gather": 0.2, "assembly.sort": 0.3,
        "assembly.entry_machine": 0.9, "assembly.close": 0.1,
        "harness loop": 0.4})
    assert "DeviceColumnEngine.window_frags" not in gaps


def test_a_port_without_the_tracer_reads_nothing(monkeypatch):
    r = _run(monkeypatch)
    monkeypatch.setattr(program_trace, "tracing", None)
    r.device = [("k", 0.0, 0.5)]
    assert _read(NEW, r) == dict.fromkeys(NEW)
    assert len(r.spans) == 2


def test_traced_run_reports_every_step_metric():
    r = run_small("maf.window-4m", 2 ** 31 + 41, trace=True)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert set(STEPS) <= set(m) and "maf.launch_us" not in m
    assert 0 < m["maf.drain_used_pct"]["value"] <= 100
    assert all(m[k]["value"] > 0 for k in STEPS)
    assert not tracing.on


UNTRACED = """
import json, sys
sys.path[:0] = [%r, %r]
from small import run_small
r = run_small("maf.window-4m", 5, seconds=0.2)
from hal_tpu_torch import tracing
print(json.dumps({"correct": r["correct"], "on": tracing.on,
                  "spans": len(tracing.take()[0]),
                  "imported": "hal_bench.program_trace" in sys.modules}))
"""


def test_untraced_run_never_turns_the_tracer_on():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", UNTRACED % (str(ROOT),
                                                            str(HERE))],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "correct": True, "on": False, "spans": 0, "imported": False}


@pytest.mark.cuda
def test_span_encloses_the_end_of_its_kernel_on_the_device_clock():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(4096, 4096, device="cuda")
    (x @ x).sum().item()
    prof = harness.Profile("cuda")
    prof.start()
    tracing.enable()
    with tracing.span("matmul"):
        y = x @ x
        torch.cuda.synchronize()
    prof.stop()
    (_name, t0, t1), = tracing.take()[0]
    del y
    kernels = [(s, e) for n, s, e in prof.events()
               if "Memcpy" not in n and "Memset" not in n]
    assert kernels
    _s, e = max(kernels, key=lambda k: k[1] - k[0])
    assert t0 - 1e-4 <= e <= t1 + 1e-4, (t0, t1, e)

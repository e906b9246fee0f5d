"""The benchmark's shared machinery: finding a cell's files by name, the
closed request loop and its clock, the spans and the profiler of a traced
run, the correctness check and the result line.

A cell is an entry of BENCHMARK.json's `workloads`.  Its files:

    hal_bench/configs/<config>.json    the alignment deployment (gen.py)
    hal_bench/traffic/<traffic>.json   the traffic mix; names its driver
    hal_bench/drivers/<driver>.py      the adapter to the entry it drives
    hal_bench/end_to_end/<metric>.py   one reader per end-to-end metric
    hal_bench/layers/<metric>.py       one reader per per-layer metric

A driver module defines `Driver(model, traffic, seed, device, control)`
with setup(), inputs(k), units(inputs), submit(inputs) -> handle,
complete(handle) -> output, release(), check(inputs, output) -> {name:
count}, and LIMITS {name: limit}.  PIPELINE requests are in flight at
once (2: request k+1 is submitted before request k completes).

A metric reader defines read(run) -> number or None; a per-layer reader
may also list WRAPS, (module, attribute path[, recorder]) of the port's
public methods or module functions that the traced run wraps in spans,
or whose calls it records (the recorder gives a number per call).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np

from hal_bench import gen, traffic as traffic_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the measured process must not hold once the
# window has closed: JAX, the JAX package, and its benchmark and smoke
# scripts
FORBIDDEN = ("jax", "jaxlib", "flax", "hal_tpu", "bench", "chip_smoke")
# reported device operations and idle gaps in a traced run's breakdown
BREAKDOWN_ROWS = 10


def clock() -> float:
    return time.perf_counter()


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def catalog() -> dict:
    """BENCHMARK.json with the held cells of hal_bench/held.json added:
    cells, configurations and metrics that run.py runs by name but the
    benchmark does not list."""
    m = manifest()
    held = json.loads((HERE / "held.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        m[key] = m[key] + held.get(key, [])
    return m


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / (name + ".json")).read_text())


def load_module(kind: str, name: str):
    path = HERE / kind / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "hal_bench_%s_%s" % (kind, name.replace(".", "_").replace("-", "_")),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------------ spans

class _Forward:
    """A module function's stand-in: calls `call`, and reads and writes
    every attribute on the original (the kernels' launch counters)."""

    def __init__(self, fn, call):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_call", call)

    def __call__(self, *a, **kw):
        return self._call(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


class Spans:
    """Host spans (name, start, end) and per-call records of a traced run,
    by wrapping attributes of the port's modules."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []
        self.calls: dict[str, list[float]] = {}
        self._undo = []

    def span(self, name: str, fn):
        spans = self.spans

        def wrapped(*a, **kw):
            t0 = clock()
            try:
                return fn(*a, **kw)
            finally:
                spans.append((name, t0, clock()))
        return wrapped

    def record(self, name: str, fn, recorder):
        rows = self.calls.setdefault(name, [])

        def wrapped(*a, **kw):
            rows.append(float(recorder(*a, **kw)))
            return fn(*a, **kw)
        return wrapped

    def install(self, wraps) -> None:
        seen = set()
        for w in wraps:
            module, path = w[0], w[1]
            if (module, path) in seen:
                continue
            seen.add((module, path))
            owner = importlib.import_module(module)
            parts = path.split(".")
            for p in parts[:-1]:
                owner = getattr(owner, p)
            orig = getattr(owner, parts[-1])
            new = (self.record(path, orig, w[2]) if len(w) > 2
                   else self.span(path, orig))
            if not isinstance(owner, type):
                new = _Forward(orig, new)
            setattr(owner, parts[-1], new)
            self._undo.append((owner, parts[-1], orig))

    def remove(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


# --------------------------------------------------------------- profiler

def _device_events(prof):
    """(name, start s, end s) of every device activity in the profile, on
    the profiler's clock."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns() / 1e9
            out.append((e.name(), s, s + e.duration_ns() / 1e9))
    return out


class Profile:
    """torch.profiler over a window, CUDA activity only, with a marker
    kernel that ties the device clock to the host's (clock()): the first
    int16 fill after a synchronize starts a few microseconds after the host
    time taken before its launch."""

    MARKER = "FillFunctor<short>"

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        self.marker = torch.zeros(1, dtype=torch.int16, device=device)
        self.prof = None
        self.t_mark = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self.t_mark = clock()
        self.marker.fill_(1)
        torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        self.torch.cuda.synchronize(self.device)
        self.prof.stop()

    def events(self):
        """Device activities (name, start, end) on the host clock."""
        ev = _device_events(self.prof)
        marks = [e for e in ev if self.MARKER in e[0]]
        if not marks:
            raise RuntimeError("the profile holds no marker kernel: device "
                               "times cannot be placed on the host clock")
        shift = min(m[1] for m in marks) - self.t_mark
        return [(n, s - shift, e - shift) for n, s, e in ev
                if self.MARKER not in n]


def _union(intervals):
    total = 0.0
    end = -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


# ------------------------------------------------------------------ trace

class Run:
    """What one run measured: the readers' input."""

    def __init__(self, setup_s, w0, w1, records):
        self.setup_s = setup_s
        self.w0, self.w1 = w0, w1
        self.records = records          # (k, submitted, completed, units)
        self.spans = []
        self.calls = {}
        self.device = None              # (name, start, end) clipped to window

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    @property
    def n_requests(self) -> int:
        return len(self.records)

    @property
    def units(self) -> int:
        return sum(r[3] for r in self.records)

    def latencies_s(self) -> np.ndarray:
        return np.array([r[2] - r[1] for r in self.records])

    def request_time_s(self) -> float:
        return float(self.latencies_s().sum())

    def span_s(self, name: str) -> float:
        """Seconds spent in span `name` inside the window."""
        return sum(max(0.0, min(e, self.w1) - max(s, self.w0))
                   for n, s, e in self.spans if n == name)

    def per_request_ms(self, seconds: float) -> float:
        return 1e3 * seconds / self.n_requests

    def device_s(self, match=None) -> float | None:
        """Summed device time of activities whose name contains `match`
        (all when None); None without a device trace."""
        if self.device is None:
            return None
        return sum(e - s for n, s, e in self.device
                   if match is None or match in n)

    def busy_s(self) -> float | None:
        if self.device is None:
            return None
        return _union((s, e) for _n, s, e in self.device)

    def idle_pct(self) -> float | None:
        busy = self.busy_s()
        if busy is None:
            return None
        return 100.0 * (1.0 - busy / self.window_s)

    def idle_intervals(self):
        """The window's stretches with no device activity, in order."""
        out = []
        end = self.w0
        for s, e in sorted((s, e) for _n, s, e in self.device):
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.w1 > end:
            out.append((end, self.w1))
        return out

    def host_timeline(self):
        """The window cut into stretches, each named by the innermost host
        span open in it ("harness loop" where none is); spans of the one
        host thread nest, so a stack of open spans gives the innermost."""
        events = sorted([(s, 1, n) for n, s, _e in self.spans]
                        + [(e, 0, n) for n, _s, e in self.spans],
                        key=lambda x: (x[0], x[1]))
        out = []
        stack = []
        t = self.w0
        for when, opens, name in events:
            when = min(max(when, self.w0), self.w1)
            if when > t:
                out.append((t, when, stack[-1] if stack else "harness loop"))
                t = when
            if opens:
                stack.append(name)
            else:
                stack.reverse()
                stack.remove(name)
                stack.reverse()
        if self.w1 > t:
            out.append((t, self.w1, stack[-1] if stack else "harness loop"))
        return out

    def breakdown(self) -> dict | None:
        """The device operations that took most time, and the device's idle
        time by the innermost host span open while it was idle."""
        if self.device is None:
            return None
        ops: dict[str, float] = {}
        for n, s, e in self.device:
            ops[n] = ops.get(n, 0.0) + (e - s)
        gaps: dict[str, float] = {}
        idle = self.idle_intervals()
        i = 0
        for a, b, name in self.host_timeline():
            while i < len(idle) and idle[i][1] <= a:
                i += 1
            j = i
            while j < len(idle) and idle[j][0] < b:
                o = min(b, idle[j][1]) - max(a, idle[j][0])
                if o > 0:
                    gaps[name] = gaps.get(name, 0.0) + o
                j += 1

        def top(d):
            return [[k[:160], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ROWS]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


# ------------------------------------------------------------------- loop

class Reservoir:
    """A uniform sample of `size` completed requests, drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = traffic_mod.sample_rng(seed)
        self.items = []
        self.seen = 0

    def offer(self, k, output) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append((k, output))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.items[j] = (k, output)


def _loop(driver, depth: int, seconds: float, spans: Spans | None,
          reservoir: Reservoir):
    """Closed loop, one client, `depth` requests in flight, from request 0
    until the first completion at or after `seconds`; the requests still in
    flight then are drained and not counted."""
    inputs, submit, complete = driver.inputs, driver.submit, driver.complete
    if spans is not None:
        inputs = spans.span("driver.inputs", inputs)
        submit = spans.span("driver.submit", submit)
        complete = spans.span("driver.complete", complete)
    records = []
    inflight = deque()
    k = 0
    t0 = clock()
    while True:
        while len(inflight) < depth:
            inp = inputs(k)
            inflight.append((k, clock(), driver.units(inp), submit(inp)))
            k += 1
        kk, ts, units, h = inflight.popleft()
        out = complete(h)
        td = clock()
        records.append((kk, ts, td, units))
        reservoir.offer(kk, out)
        if td - t0 >= seconds:
            break
    while inflight:
        complete(inflight.popleft()[3])
    return t0, td, records


def cell_entry(cell: str) -> dict:
    for w in catalog()["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError("no workload %r in BENCHMARK.json" % cell)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", control: bool = False,
             config_patch: dict | None = None,
             traffic_patch: dict | None = None) -> dict:
    """One run of a cell; returns the result line's object.  device "cpu"
    (the tests) runs the port's plain versions and reads no device trace;
    config_patch / traffic_patch shrink a cell for them.  control: the
    driver breaks a guarantee the configuration states (see drivers)."""
    import torch

    entry = cell_entry(cell)
    m = catalog()
    config = {**load_json("configs", entry["config"]), **(config_patch or {})}
    traffic = {**load_json("traffic", entry["traffic"]),
               **(traffic_patch or {})}
    mod = load_module("drivers", traffic["driver"])
    on_gpu = device == "cuda"

    model = gen.from_config(config, seed, device)
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    driver = mod.Driver(model, traffic, seed, device, control)
    driver.setup()
    for k in range(-int(traffic.get("warmup", 1)), 0):
        driver.complete(driver.submit(driver.inputs(k)))
    if on_gpu:
        torch.cuda.synchronize()

    metrics = [x for x in (m["per_layer"] if trace else m["end_to_end"])
               if _applies(x, cell)]
    readers = {x["name"]: load_module(
        "layers" if trace else "end_to_end", x["name"]) for x in metrics}
    spans = None
    prof = None
    if trace:
        spans = Spans()
        spans.install(w for r in readers.values()
                      for w in getattr(r, "WRAPS", ()))
        if on_gpu:
            prof = Profile(device)
            prof.start()
    reservoir = Reservoir(int(traffic.get("check_requests", 1)), seed)
    setup_s = clock() - t_start
    try:
        w0, w1, records = _loop(driver, int(getattr(mod, "PIPELINE", 1)),
                                seconds, spans, reservoir)
    finally:
        if prof is not None:
            prof.stop()
        if spans is not None:
            spans.remove()
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0

    run = Run(setup_s, w0, w1, records)
    if trace:
        run.spans, run.calls = spans.spans, spans.calls
        if prof is not None:
            run.device = [(n, max(s, w0), min(e, w1))
                          for n, s, e in prof.events() if e > w0 and s < w1]
    values = {}
    for x in metrics:
        v = readers[x["name"]].read(run)
        if v is not None:
            values[x["name"]] = {"value": float(v), "unit": x["unit"]}

    # the program's state and the profile are freed before the reference
    driver.release()
    del prof
    if on_gpu:
        torch.cuda.empty_cache()
    checks = {name: 0 for name in mod.Driver.LIMITS}
    for k, out in reservoir.items:
        got = driver.check(driver.inputs(k), out)
        for name, v in got.items():
            checks[name] += int(v)
    correct = all(checks[n] <= lim for n, lim in mod.Driver.LIMITS.items())

    dev = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
           "count": int(entry.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    if trace and run.device is not None:
        dev["busy_s"] = run.busy_s()
        dev["window_s"] = run.window_s
    out = {"correct": bool(correct), "attempted": run.n_requests,
           "failed": 0, "metrics": values, "device": dev,
           "latencies_ms": [1e3 * x for x in run.latencies_s()]}
    if trace and run.device is not None:
        out["breakdown"] = run.breakdown()
    out["checks"] = {n: {"value": checks[n], "limit": lim,
                         "requests": len(reservoir.items)}
                     for n, lim in mod.Driver.LIMITS.items()}
    return out

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (hal_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught), each
printing its seconds:
  1. build the CUDA kernels from hal_tpu_torch/csrc with nvcc (sm_90a), and
     load the port's native host bindings, which build their libraries from
     native/ with g++ (no -march=native: hal_tpu_torch.ops._native_build)
     into hal_tpu_torch/build/ at first use, as every port CLI does;
  2. each kernel against its plain PyTorch version on the card, exact
     integer equality (searchsorted at grids around its sector, fence
     and tree-level edges up to its grid limit, with duplicates, misaligned
     views, uint32-range int64 queries and a second stream; the scans also at
     their tile edges, on wrapping sums, INT32_MIN/MAX, reused state, a
     second stream and in place, and cumsum at the depth engine's lengths
     2^26 + 1 and 2^27 + 1), each timed in turns against its plain
     version and one PyTorch library call at the main path's shapes;
  3. the batched liftover path at bench scale (bench.py's fixture: 10
     genomes of >= 2^20 segments, 2.3-2.6 Gb, 2^20 intervals of 1-199 bp):
     map-only and map + runs + wire + decode rates over 10 batches, the
     fragment count against the host sizing, 2,048 sampled owners' runs
     against the host extract_runs, every kernel launched (searchsorted
     included), and the map and one level's lookup timed with the
     searchsorted kernel against the paged binary search;
  4. the main path through its entry points, with every kernel's launch
     count set to 0 first: bulk_runs_device at bench scale, then the
     halLiftover CLI (--device cuda --batchSize 16384) on a ~100 Mb
     alignment; the CLI's bytes must equal the same CLI's on --device cpu
     (the plain kernel versions), and every kernel must have launched;
  5. the alignment-depth engine on phase 3's fixture: DepthEngine over the
     first 2^27 columns of the source genome against every genome, in both
     count modes; run_device_only and run_runs timed, the profiler's device
     ms per genome, and the whole 2^27-column vector equal to the host
     depth_counts; then the halAlignmentDepth and halWiggleLiftover
     (its default --batchSize, 16384 runs a call) CLIs on the CLI
     alignment, --device cuda bytes equal to --device cpu;
  6. the device column engine (hal2maf) on bench.py's MAF fixture (seed
     11, 10 genomes of 2^20 segments of 128-129 bp, DNA): the first
     2^21-column window through the native assembler byte-equal to the
     native DFS engine, then six windows timed (device phase and end to
     end), and the hal2maf CLI on a smaller DNA alignment, --device cuda
     bytes equal to --device cpu.
Phases 4-6 each drive a path with the launch counts set to 0 just before
and read just after; every kernel must launch on every path.

Everything runs on hal_tpu_torch alone: its host modules (randgen,
storage, segmap_host, liftover) make the fixtures and the host oracle.

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

N_GENOMES = 10
N_BOT = 1 << 20
SEG_LEN = 2200
N_INTERVALS = 1 << 20
MAX_IVLEN = 200
TIMED_ITERS = 10
N_SAMPLE_OWNERS = 2048
CLI_LINES = 1 << 16
CLI_BATCH = 16384
DEPTH_WINDOW = 1 << 27
DEPTH_CLI_COLUMNS = 1 << 22
WIG_BLOCKS = 400
MAF_SEGMENTS = 1 << 20
MAF_WINDOW = 1 << 21
MAF_TIMED_WINDOWS = 6

# H100 SXM data sheet: HBM bytes/s; 32-bit non-tensor operations/s (the
# float32 rate, the table's rate for 32-bit ALU work)
HBM_BYTES_PER_S = 3.35e12
ALU32_OPS_PER_S = 67e12

REPLACES = {
    "searchsorted_right": "hal_tpu/ops/pallas_kernels.py:52",
    "cumsum_i32": "hal_tpu/ops/pallas_kernels.py:186",
    "cummax_i32": "hal_tpu/ops/pallas_kernels.py:185",
}
SOURCES = {
    "searchsorted_right": "hal_tpu_torch/csrc/searchsorted.cu",
    "cumsum_i32": "hal_tpu_torch/csrc/scan.cu",
    "cummax_i32": "hal_tpu_torch/csrc/scan.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean time of fn() over iters back-to-back calls on the device's
    timeline (CUDA events): kernel time plus any gaps the host leaves."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, stats: dict | None = None):
    """Device time of fn() per call from torch.profiler: the sum over the
    CUDA kernels and copies it ran, and those per name, largest first.
    stats, if given, receives "launches": the device kernels and copies
    per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile now and then comes back without events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("Activity Buffer")]
        rows = sorted(((e.key, e.self_device_time_total / 1e3 / iters)
                       for e in events), key=lambda r: -r[1])
        if rows:
            if stats is not None:
                stats["launches"] = sum(e.count for e in events) / iters
            return sum(ms for _, ms in rows), rows
    raise AssertionError("torch.profiler recorded no device time")


def timed_turns(kernel_fn, plain_fn, library_fn) -> dict:
    """{"kernel" | "plain" | "library": (device ms, event ms)} per call:
    device ms from the profiler, event ms on the device timeline incl. host
    launch gaps, each side timed in turns plain, kernel, library, library,
    kernel, plain and averaged over its two turns."""
    fns = {"plain": plain_fn, "kernel": kernel_fn, "library": library_fn}
    order = ("plain", "kernel", "library", "library", "kernel", "plain")
    dev = {k: 0.0 for k in fns}
    ev = {k: 0.0 for k in fns}
    for k in order:
        dev[k] += device_ms(fns[k])[0] / 2
    for k in order:
        ev[k] += time_ms(fns[k]) / 2
    return {k: (dev[k], ev[k]) for k in fns}


def phase_build() -> None:
    from hal_tpu_torch.ops import _build, _native_build

    found = _build.library_path().exists()
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log("phase 1 build: %s %s in %.2fs"
        % (os.path.relpath(so, REPO),
           "found, not rebuilt" if found else "built with nvcc",
           time.perf_counter() - t0))
    # the native host libraries, built for this machine's CPU by their
    # bindings at first load (the tracked native/*.so are built with
    # -march=native elsewhere)
    from hal_tpu_torch import native
    from hal_tpu_torch.ops import column_native

    for what, mod, source in (("column engine", column_native,
                               "column_engine.cpp"),
                              ("runtime", native, "haltpu.cpp")):
        want = str(_native_build.library_path(source))
        t0 = time.perf_counter()
        lib = mod._load()
        if lib is None or lib._name != want:
            raise AssertionError("native %s: %s not loaded (got %s)"
                                 % (what, want,
                                    None if lib is None else lib._name))
        log("  native %s: native/%s built and loaded from %s in %.2fs"
            % (what, source, os.path.relpath(lib._name, REPO),
               time.perf_counter() - t0))


def phase_kernels(dev) -> dict:
    """Kernel == plain on the card, exactly; returns per-kernel records."""
    import torch

    from hal_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(1)
    err = {"searchsorted_right": 0, "cumsum_i32": 0, "cummax_i32": 0}

    def check(name, got, want, what):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError("%s %s: dtype/shape %s %s vs %s %s"
                                 % (name, what, got.dtype, tuple(got.shape),
                                    want.dtype, tuple(want.shape)))
        d = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
        err[name] = max(err[name], d)
        if d != 0:
            raise AssertionError("%s %s: kernel != plain (max abs diff %d)"
                                 % (name, what, d))
        log("  %s %s: equal to plain" % (name, what))

    searchsorted_edge_cases(K, dev, rng, check)

    tile = K._scan_binding()[1]
    # the tile's edges; 33 tiles and more behind a late tile slide the
    # look-back window more than once
    for n in (1, 1000, 65537, tile - 1, tile, tile + 1, 2 * tile + 1,
              33 * tile + 5, 1310720, (1 << 24) + 3):
        x = rng.integers(0, 8, n).astype(np.int32)
        x[::7] = rng.integers(-1000, 1000, len(x[::7]))
        x_t = torch.from_numpy(x).to(dev)
        check("cumsum_i32", K.cumsum_i32(x_t), K.cumsum_i32_plain(x_t),
              "length %d" % n)
        y = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int64)
        y = y.astype(np.int32)
        y_t = torch.from_numpy(y).to(dev)
        check("cummax_i32", K.cummax_i32(y_t), K.cummax_i32_plain(y_t),
              "length %d" % n)
        if not np.array_equal(K.cumsum_i32(x_t).cpu().numpy(),
                              np.cumsum(x, dtype=np.int32)):
            raise AssertionError("cumsum_i32 != numpy at length %d" % n)
        if not np.array_equal(K.cummax_i32(y_t).cpu().numpy(),
                              np.maximum.accumulate(y)):
            raise AssertionError("cummax_i32 != numpy at length %d" % n)

    scan_edge_cases(K, dev, rng, check)

    # the depth engine's lengths: the diff-cumsum (window + 1) and the
    # RLE run ids of a window's counts
    for n in ((1 << 26) + 1, (1 << 27) + 1):
        x = rng.integers(-2, 3, n).astype(np.int32)
        x_t = torch.from_numpy(x).to(dev)
        got = K.cumsum_i32(x_t)
        check("cumsum_i32", got, K.cumsum_i32_plain(x_t), "length %d" % n)
        if not np.array_equal(got.cpu().numpy(), np.cumsum(x, dtype=np.int32)):
            raise AssertionError("cumsum_i32 != numpy at length %d" % n)
        del x_t, got

    # times at the main path's shapes.  cap = one query per slot of a
    # bench-scale level capacity.  searchsorted: a bench-scale uint32-range
    # level (1,179,648 segments) with int64 queries, as phase 3 runs it (the
    # record's shape); a 65,536-entry int32 grid (the old kernel limit); the
    # CLI cell's ~60k-segment grids with one 16,384-line batch.  Scans: cap.
    cap = 1310720
    g32 = torch.from_numpy(np.sort(rng.integers(0, 1 << 30, 65536))
                           .astype(np.int32)).to(dev)
    q32 = torch.from_numpy(rng.integers(0, 1 << 30, cap)
                           .astype(np.int32)).to(dev)
    f32 = K.search_tables(g32)
    gcli = torch.from_numpy(np.sort(rng.integers(0, 120_000_000, 60000))
                            .astype(np.int32)).to(dev)
    qcli = torch.from_numpy(rng.integers(0, 120_000_000, CLI_BATCH)
                            .astype(np.int32)).to(dev)
    fcli = K.search_tables(gcli)
    g64 = torch.from_numpy(np.sort(rng.integers(0, 2_600_000_000,
                                                1179648))).to(dev)
    q64 = torch.from_numpy(rng.integers(0, 2_600_000_000, cap)).to(dev)
    gb = K.bias_u32(g64)
    fb = K.search_tables(gb)
    counts = torch.from_numpy(rng.integers(0, 3, cap).astype(np.int32)).to(dev)
    marks = torch.from_numpy(np.where(rng.random(cap) < 0.8, 0,
                                      np.arange(cap)).astype(np.int32)).to(dev)
    n27 = DEPTH_WINDOW + 1  # the depth engine's diff-cumsum length
    diff27 = torch.from_numpy(rng.integers(-1, 2, n27).astype(np.int32)).to(dev)

    def ss_bytes(g, q):  # grid read once, queries in, results out
        return g.numel() * 4 + 2 * q.numel() * q.element_size()

    def ss_ops(g, q):  # one compare per level of a binary search
        return q.numel() * int(g.numel()).bit_length()

    rec = {}
    for name, kfn, pfn, lfn, nbytes, ops, shape in (
            ("searchsorted_right",
             lambda: K.searchsorted_right_u32(gb, q64, fb),
             lambda: K.searchsorted_right_u32_plain(gb, q64),
             lambda: torch.searchsorted(g64, q64, right=True),
             ss_bytes(gb, q64), ss_ops(gb, q64),
             "u32 grid 1179648, %d int64 queries" % cap),
            ("searchsorted_right", lambda: K.searchsorted_right(g32, q32, f32),
             lambda: K.searchsorted_right_plain(g32, q32),
             lambda: torch.searchsorted(g32, q32, right=True, out_int32=True),
             ss_bytes(g32, q32), ss_ops(g32, q32),
             "grid 65536, %d int32 queries" % cap),
            ("searchsorted_right",
             lambda: K.searchsorted_right(gcli, qcli, fcli),
             lambda: K.searchsorted_right_plain(gcli, qcli),
             lambda: torch.searchsorted(gcli, qcli, right=True,
                                        out_int32=True),
             ss_bytes(gcli, qcli), ss_ops(gcli, qcli),
             "CLI grid 60000, %d int32 queries" % CLI_BATCH),
            ("cumsum_i32", lambda: K.cumsum_i32(counts),
             lambda: K.cumsum_i32_plain(counts),
             lambda: torch.cumsum(counts, 0, dtype=torch.int32),
             8 * cap, cap, "length %d" % cap),
            ("cumsum_i32", lambda: K.cumsum_i32(diff27),
             lambda: K.cumsum_i32_plain(diff27),
             lambda: torch.cumsum(diff27, 0, dtype=torch.int32),
             8 * n27, n27, "length %d (a depth window's diff-cumsum)" % n27),
            ("cummax_i32", lambda: K.cummax_i32(marks),
             lambda: K.cummax_i32_plain(marks),
             lambda: torch.cummax(marks, 0), 8 * cap, cap,
             "length %d" % cap)):
        t = timed_turns(kfn, pfn, lfn)
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = ops / ALU32_OPS_PER_S * 1e3
        bound = max(b_bytes, b_ops)
        log("  time %s (%s): device kernel %.4f ms, plain %.4f ms, library "
            "%.4f ms; event-timed incl. launch gaps kernel %.4f ms, plain "
            "%.4f ms, library %.4f ms; bound %.4f ms (%s), kernel at %.0f%% "
            "of it" % (name, shape, t["kernel"][0], t["plain"][0],
                       t["library"][0], t["kernel"][1], t["plain"][1],
                       t["library"][1], bound,
                       "bytes" if b_bytes >= b_ops else "operations",
                       100 * bound / t["kernel"][0]))
        if name in rec:
            continue  # the first shape of each kernel is its record's
        rec[name] = {"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "max_abs_err": err[name],
                     "ms": t["kernel"][0], "plain_ms": t["plain"][0],
                     "bound_ms": bound,
                     "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                     "library_ms": t["library"][0], "shape": shape}
    log("phase 2 kernels: all equal to their plain versions")
    return rec


def searchsorted_edge_cases(K, dev, rng, check) -> None:
    """The sector B-tree kernel against its plain version (and numpy) at
    grids around its sector (8) and fence (64) edges, past the old 65,536
    limit, where the staged tree moves from fences8 to fences64, at a
    bench-scale grid and at the kernel's grid limit; duplicates across
    sector and fence edges, exact hits, INT32_MIN, queries below and above
    the grid, a misaligned view of grid and queries, uint32-range int64
    queries (out-of-range ones included: masked slots carry them) and a
    second stream."""
    import torch

    nq = (1 << 18) + 3
    side = torch.cuda.Stream(dev)
    i32 = np.iinfo(np.int32)
    for n in (1, 7, 8, 9, 63, 64, 65, 3000, 65536, 65537, 262136, 262137,
              1179648, K.SEARCH_GRID_LIMIT):
        grid = np.sort(rng.integers(-(1 << 30), 1 << 30, n))
        gu = np.sort(rng.integers(0, (1 << 32) - 2, n))
        for e in (8, 64, 512, 4096, n // 2):  # duplicate runs across edges
            if 3 <= e and e + 5 < n:
                grid[e - 3:e + 5] = grid[e - 3]
                gu[e - 3:e + 5] = gu[e - 3]
        grid = grid.astype(np.int32)
        lo_, hi_ = int(grid[0]), int(grid[-1])
        q = rng.integers(lo_ - 1000, hi_ + 1000, nq).astype(np.int32)
        q[:6] = [lo_ - 1, lo_, hi_, hi_ + 1, i32.min, i32.max - 1]
        k = min(n, 4096)
        q[6:6 + k] = grid[:k]  # exact hits, duplicates included
        g_t = torch.from_numpy(grid).to(dev)
        q_t = torch.from_numpy(q).to(dev)
        what = "grid %d x %d queries" % (n, nq)
        out = K.searchsorted_right(g_t, q_t)
        check("searchsorted_right", out, K.searchsorted_right_plain(g_t, q_t),
              what)
        if not np.array_equal(out.cpu().numpy(),
                              np.searchsorted(grid, q, side="right")):
            raise AssertionError("searchsorted_right != numpy, " + what)
        if n > 1:
            check("searchsorted_right", K.searchsorted_right(g_t[1:], q_t[1:]),
                  K.searchsorted_right_plain(g_t[1:], q_t[1:]),
                  "misaligned views, " + what)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            got = K.searchsorted_right(g_t, q_t)
        torch.cuda.current_stream(dev).wait_stream(side)
        check("searchsorted_right", got, out, "second stream, " + what)

        qu = rng.integers(-(1 << 33), 1 << 33, nq)
        qu[:6] = [-1, 0, (1 << 32) - 1, 1 << 32, gu[0], gu[-1]]
        qu[6:6 + k] = gu[:k]
        gb = K.bias_u32(torch.from_numpy(gu).to(dev))
        qu_t = torch.from_numpy(qu).to(dev)
        out = K.searchsorted_right_u32(gb, qu_t)
        check("searchsorted_right", out,
              K.searchsorted_right_u32_plain(gb, qu_t),
              "uint32 range, int64 queries, " + what)
        want = np.searchsorted(gu, np.clip(qu, 0, (1 << 32) - 1), side="right")
        if not np.array_equal(out.cpu().numpy(), want):
            raise AssertionError("searchsorted_right_u32 != numpy, " + what)


def scan_edge_cases(K, dev, rng, check) -> None:
    """The single-pass scan at its edges: sums that wrap past +-2^31,
    INT32_MIN / INT32_MAX, a random int32 input at the tile's edges, a
    misaligned input, 200 back-to-back calls on reused status state, an
    epoch wrap, a second stream and in-place calls; each result equal to
    the plain version (and numpy where stated)."""
    import torch

    def both(x):
        x_t = torch.from_numpy(x).to(dev)
        return x_t, K.cumsum_i32_plain(x_t), K.cummax_i32_plain(x_t)

    n = 1310720
    wrap = np.full(n, 1 << 30, np.int32)  # crosses +-2^31 every 2-4 items
    wrap[::3] = -(1 << 30) - 7
    w_t, w_sum, _ = both(wrap)
    check("cumsum_i32", K.cumsum_i32(w_t), w_sum, "wrap-around length %d" % n)
    if not np.array_equal(K.cumsum_i32(w_t).cpu().numpy(),
                          np.cumsum(wrap, dtype=np.int32)):
        raise AssertionError("cumsum_i32 wrap-around != numpy")
    ext = rng.integers(-5, 5, n).astype(np.int32)
    ext[rng.random(n) < 0.01] = np.iinfo(np.int32).min
    ext[:3] = np.iinfo(np.int32).min
    ext[n // 2] = np.iinfo(np.int32).max
    e_t, _, e_max = both(ext)
    check("cummax_i32", K.cummax_i32(e_t), e_max, "INT32_MIN/MAX length %d" % n)
    if not np.array_equal(K.cummax_i32(e_t).cpu().numpy(),
                          np.maximum.accumulate(ext)):
        raise AssertionError("cummax_i32 INT32_MIN/MAX != numpy")

    t = K._scan_binding()[1]
    for m in (t - 1, t, t + 1, 2 * t + 1):
        x_t, c, mx = both(rng.integers(-1 << 31, 1 << 31, m,
                                       dtype=np.int64).astype(np.int32))
        check("cumsum_i32", K.cumsum_i32(x_t), c, "int32 range, length %d" % m)
        check("cummax_i32", K.cummax_i32(x_t), mx, "int32 range, length %d" % m)
    x_t, c, mx = both(rng.integers(-9, 9, 65537).astype(np.int32))
    check("cumsum_i32", K.cumsum_i32(x_t[1:]), K.cumsum_i32_plain(x_t[1:]),
          "misaligned")
    check("cummax_i32", K.cummax_i32(x_t[1:]), K.cummax_i32_plain(x_t[1:]),
          "misaligned")

    cases = [both(rng.integers(-1000, 1000, m).astype(np.int32))
             for m in (1, 777, 5000, 65536, 1310720)]
    for i in range(200):  # reused state: a stale epoch or counter shows here
        x_t, c, mx = cases[i % len(cases)]
        if i % 2:
            got, want, name = K.cumsum_i32(x_t), c, "cumsum_i32"
        else:
            got, want, name = K.cummax_i32(x_t), mx, "cummax_i32"
        if not torch.equal(got, want):
            raise AssertionError("%s call %d of 200 on reused state, length "
                                 "%d: kernel != plain" % (name, i, len(x_t)))
    log("  cumsum_i32 / cummax_i32 200 back-to-back calls: equal to plain")
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    K._scan_states[key][2] = K._EPOCH_END - 3
    for i in range(6):  # crosses the epoch limit: the state is re-zeroed
        x_t, c, mx = cases[i % len(cases)]
        check("cumsum_i32", K.cumsum_i32(x_t), c, "epoch wrap %d" % i)

    side = torch.cuda.Stream(dev)
    x_t, c, mx = cases[-1]
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = [(K.cumsum_i32(x_t), K.cummax_i32(x_t)) for _ in range(3)]
    main = K.cumsum_i32(x_t)
    torch.cuda.current_stream(dev).wait_stream(side)
    for gs, gm in got:
        check("cumsum_i32", gs, c, "second stream")
        check("cummax_i32", gm, mx, "second stream")
    check("cumsum_i32", main, c, "default stream beside the second")

    for name, want in (("cumsum_i32", c), ("cummax_i32", mx)):
        y = x_t.clone()
        if K._scan_cuda(name, y, out=y).data_ptr() != y.data_ptr():
            raise AssertionError("%s in place: wrote elsewhere" % name)
        check(name, y, want, "in place, length %d" % len(y))


def build_bench_alignment():
    from hal_tpu_torch.randgen import create_random_alignment

    return create_random_alignment(
        seed=7, max_genomes=N_GENOMES, min_genomes=N_GENOMES - 1,
        mean_degree=1.5, max_branch_length=0.2,
        min_segment_length=SEG_LEN, max_segment_length=SEG_LEN + 20,
        min_segments=N_BOT, max_segments=N_BOT + N_BOT // 8,
        store_dna=False)


def pick_pair(aln):
    """Deepest leaf-to-leaf pair (longest traversal path)."""
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)
              and aln.open_genome(n).length > 0]
    best = (0, leaves[0], leaves[0])
    for a in leaves:
        for b in leaves:
            if a != b:
                d = len(aln.tree.path(a, b))
                if d > best[0]:
                    best = (d, a, b)
    return best[1], best[2]


def host_runs(aln, src, tgt, lo, hi, owners, seq_of):
    """Per sampled owner, the host's (s_lo, s_hi, t_lo, t_hi, rev) runs:
    map_source + atomize + extract_runs, the reference merge semantics."""
    from hal_tpu_torch.ops import segmap_host as sm
    from hal_tpu_torch.ops.liftover import extract_runs

    out = {}
    for o in owners:
        fr = sm.atomize(sm.map_source(aln, src, lo[o:o + 1], hi[o:o + 1],
                                      tgt, do_dupes=True))
        out[int(o)] = sorted(
            (min(f.src_lo for f in run), max(f.src_hi for f in run),
             run[0].tgt_lo, run[-1].tgt_hi, int(run[0].rev))
            for run in extract_runs(fr, seq_of))
    return out


def decoded_runs(o, s_lo, s_hi, t_lo, t_hi, rev, own, dupes, seq_of):
    """Owner o's runs from the decoded wire, dupe-flagged owners merged on
    host exactly as bench.py's honesty check does."""
    from hal_tpu_torch.ops import segmap_host as sm
    from hal_tpu_torch.ops.liftover import extract_runs

    m = own == o
    if not dupes[o]:
        return sorted((int(s_lo[i]), int(s_hi[i]), int(t_lo[i]),
                       int(t_hi[i]), int(rev[i])) for i in np.flatnonzero(m))
    rows = np.unique(np.stack([s_lo[m], s_hi[m], t_lo[m], t_hi[m], rev[m]],
                              axis=1), axis=0)
    fr = sm.atomize(sm.Fragments(rows[:, 0], rows[:, 1], rows[:, 2],
                                 rows[:, 3], rows[:, 4].astype(np.uint8)))
    return sorted((min(f.src_lo for f in run), max(f.src_hi for f in run),
                   run[0].tgt_lo, run[-1].tgt_hi, int(run[0].rev))
                  for run in extract_runs(fr, seq_of))


def lookup_vs_paged(st, path, lo_d, hi_d, own_d, caps, F) -> None:
    """The first level's lookup and the whole map with the searchsorted
    kernel against the paged binary search that served these levels before
    (the kernel limit set back to the page limit): device time in turns,
    and the paged run's fragments equal to the kernel run's."""
    import torch

    lv = path.levels[0]
    if lv.page_tab is None or lv.search_tree is None:
        raise AssertionError("bench-scale level 0 lacks its page table or "
                             "its search tables")
    got = st._lookup(lv, lo_d)
    if not torch.equal(got, st._paged_searchsorted(lv.grid, lo_d, lv.page_tab,
                                                   lv.page_shift)):
        raise AssertionError("bench-scale lookup: kernel != paged search")
    t = timed_turns(
        lambda: st._lookup(lv, lo_d),
        lambda: st._paged_searchsorted(lv.grid, lo_d, lv.page_tab,
                                       lv.page_shift),
        lambda: torch.searchsorted(lv.grid, lo_d, right=True))
    log("  lookup, level 0 (grid %d, %d int64 queries): device kernel %.4f "
        "ms, paged chain %.4f ms, torch.searchsorted %.4f ms; event-timed "
        "kernel %.4f ms, paged chain %.4f ms"
        % (lv.grid.numel(), lo_d.numel(), t["kernel"][0], t["plain"][0],
           t["library"][0], t["kernel"][1], t["plain"][1]))

    limit = st._KERNEL_GRID_LIMIT

    def run_paged():
        st._KERNEL_GRID_LIMIT = st._PAGE_GRID_LIMIT
        try:
            return st._run_path(path, lo_d, hi_d, own_d, caps)
        finally:
            st._KERNEL_GRID_LIMIT = limit

    Fp = run_paged()[0]
    v = F[st.C_VALID] > 0
    if not (torch.equal(Fp[st.C_VALID] > 0, v) and torch.equal(Fp[:, v],
                                                               F[:, v])):
        raise AssertionError("map with the paged search != map with the "
                             "searchsorted kernel")
    runs = {"paged": run_paged,
            "kernel": lambda: st._run_path(path, lo_d, hi_d, own_d, caps)}
    ms = {"paged": [], "kernel": []}
    for k in ("paged", "kernel", "kernel", "paged"):
        total, rows = device_ms(runs[k], iters=3)
        ms[k].append(total)
        log("  profile map, lookups by %s: %.3f ms device/batch; top: %s"
            % (k, total, "; ".join("%s %.3f" % (n[:50], m)
                                   for n, m in rows[:5])))
    log("  map device ms/batch, in turns paged, kernel, kernel, paged: %s; "
        "paged chain %.3f -> searchsorted kernel %.3f"
        % ([round(x, 4) for x in ms["paged"][:1] + ms["kernel"]
            + ms["paged"][1:]], sum(ms["paged"]) / 2, sum(ms["kernel"]) / 2))


def phase_bench_scale(dev):
    import torch

    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.ops import segmap_torch as st
    from hal_tpu_torch.ops import tables

    t0 = time.perf_counter()
    aln = build_bench_alignment()
    src, tgt = pick_pair(aln)
    g = aln.open_genome(src)
    tg = aln.open_genome(tgt)
    log("phase 3 fixture: %d genomes, %.2f Gb max, pair %s -> %s (path %d) "
        "in %.1fs" % (aln.num_genomes,
                      max(aln.open_genome(n).length
                          for n in aln.genome_names()) / 1e9,
                      src, tgt, len(aln.tree.path(src, tgt)),
                      time.perf_counter() - t0))
    rng = np.random.default_rng(0)
    lo = rng.integers(0, g.length - MAX_IVLEN, N_INTERVALS).astype(np.int64)
    hi = lo + rng.integers(1, MAX_IVLEN, N_INTERVALS)

    t0 = time.perf_counter()
    path = st.PathData.build(aln, src, tgt, device=dev)
    log("  path tables: %.1fs, coordinates %s (%s), pages %s"
        % (time.perf_counter() - t0, path.coord_kind, path.dtype,
           [lv.page_shift if lv.page_tab is not None else 0
            for lv in path.levels]))
    t0 = time.perf_counter()
    totals, final = tables.host_path_totals(aln, src, tgt, lo, hi)
    caps = tables.caps_from_totals(path, totals)
    log("  host sizing: %.1fs, totals %s -> caps %s, final %d"
        % (time.perf_counter() - t0, totals, caps, final))
    lo_d = st.coords(path, lo)
    hi_d = st.coords(path, hi)
    own_d = torch.arange(N_INTERVALS, dtype=path.dtype, device=dev)
    seq_grid = st.target_seq_grid(tg, device=dev)
    out_cols = tables._bucket_cap(final)

    K.reset_launches()
    F, bound, ovf, lt = st._run_path(path, lo_d, hi_d, own_d, caps)
    if bool(ovf.item()):
        raise AssertionError("capacity overflow on host-sized caps")
    n_frag = int((F[st.C_VALID] > 0).sum().item())
    if n_frag != final:
        raise AssertionError("fragments %d != host_path_totals final %d"
                             % (n_frag, final))
    if [tuple(r) for r in lt.tolist()] != [tuple(t) for t in totals]:
        raise AssertionError("level totals %s != host %s" % (lt.tolist(), totals))
    wire, total, rovf = st.runs_packed(F, lo_d, seq_grid, out_cols, 8)
    if bool(rovf.item()):
        raise AssertionError("runs_packed overflow")
    dec = tables.decode_runs_packed(st.wire_to_host(wire), int(total.item()),
                                    lo, out_cols, 8)
    torch.cuda.synchronize()
    counts = K.launches()
    log("  first run: %d fragments == host final, %d runs, launches %s"
        % (n_frag, int(total.item()), counts))
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError("kernel %s not launched at bench scale: %s"
                                 % (name, counts))
    lookup_vs_paged(st, path, lo_d, hi_d, own_d, caps, F)

    def seq_of(p):
        return int(np.searchsorted(tg.seq_start, p, side="right")) - 1

    sample = np.arange(0, N_INTERVALS, N_INTERVALS // N_SAMPLE_OWNERS)
    t0 = time.perf_counter()
    want = host_runs(aln, src, tgt, lo, hi, sample, seq_of)
    for o in sample:
        got = decoded_runs(o, *dec, seq_of)
        if got != want[int(o)]:
            raise AssertionError("owner %d: device runs %s != host %s"
                                 % (o, got, want[int(o)]))
    log("  run-merge honesty: %d sampled owners equal host extract_runs "
        "(%d dupe-flagged of %d owners) in %.1fs"
        % (len(sample), int(dec[6].sum()), N_INTERVALS,
           time.perf_counter() - t0))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        F, bound, ovf, lt = st._run_path(path, lo_d, hi_d, own_d, caps)
    torch.cuda.synchronize()
    map_s = (time.perf_counter() - t0) / TIMED_ITERS
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        F, bound, ovf, lt = st._run_path(path, lo_d, hi_d, own_d, caps)
        wire, total, rovf = st.runs_packed(F, lo_d, seq_grid, out_cols, 8)
        tables.decode_runs_packed(st.wire_to_host(wire), int(total.item()),
                                  lo, out_cols, 8)
    e2e_s = (time.perf_counter() - t0) / TIMED_ITERS
    if bool((ovf | rovf).item()):
        raise AssertionError("overflow in the timed loop")
    log("  map only: %.4fs/batch -> %.0f intervals/s" % (map_s, N_INTERVALS / map_s))
    log("  map + runs + wire + decode: %.4fs/batch -> %.0f intervals/s "
        "(%.1f MB wire/batch)" % (e2e_s, N_INTERVALS / e2e_s,
                                  wire.numel() * 4 / 1e6))
    # where the time goes: device time per stage, host decode alone
    for what, fn in (
            ("map", lambda: st._run_path(path, lo_d, hi_d, own_d, caps)),
            ("runs_packed", lambda: st.runs_packed(F, lo_d, seq_grid,
                                                   out_cols, 8))):
        dev_ms, rows = device_ms(fn, iters=3)
        log("  profile %s: %.3f ms device/batch; top: %s"
            % (what, dev_ms, "; ".join("%s %.3f" % (k[:60], ms)
                                       for k, ms in rows[:4])))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wire_h = st.wire_to_host(wire)
    t1 = time.perf_counter()
    tables.decode_runs_packed(wire_h, int(total.item()), lo, out_cols, 8)
    log("  wire D2H copy: %.4fs/batch; host decode_runs_packed: %.4fs/batch"
        % (t1 - t0, time.perf_counter() - t1))
    return {"aln": aln, "src": src, "tgt": tgt, "lo": lo, "hi": hi,
            "sample": sample, "want": want}


def cli_fixture(tmp: str):
    """~100 Mb genomes of 40-60k ~2 kb segments (int32 coordinates, grids
    within the old 65,536 kernel limit, as before) saved as halz, and a
    BED3 file of CLI_LINES sorted, disjoint 1-199 bp intervals."""
    from hal_tpu_torch.randgen import create_random_alignment
    from hal_tpu_torch.storage import save_alignment

    aln = create_random_alignment(
        seed=11, max_genomes=10, min_genomes=8, mean_degree=1.5,
        max_branch_length=0.2, min_segment_length=1900,
        max_segment_length=2100, min_segments=40000, max_segments=60000,
        store_dna=False)
    src, tgt = pick_pair(aln)
    for n in aln.tree.path(src, tgt):
        gn = aln.open_genome(n)
        if max(gn.num_top_segments, gn.num_bottom_segments) >= 65536:
            raise AssertionError("CLI fixture grid of %s exceeds 65,536" % n)
    hal = os.path.join(tmp, "cli.halz")
    save_alignment(aln, hal, fmt="halz")
    g = aln.open_genome(src)
    rng = np.random.default_rng(2)
    slen = g.seq_length(0)
    step = slen // CLI_LINES
    starts = np.arange(CLI_LINES, dtype=np.int64) * step + rng.integers(
        0, step - MAX_IVLEN, CLI_LINES)
    ends = starts + rng.integers(1, MAX_IVLEN, CLI_LINES)
    bed = os.path.join(tmp, "in.bed")
    with open(bed, "w") as f:
        name = g.seq_names[0]
        f.writelines("%s\t%d\t%d\n" % (name, s, e) for s, e in zip(starts, ends))
    return hal, src, tgt, bed


def phase_main_path(dev, bench, tmp, cli) -> dict:
    import torch

    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.ops.liftover_bulk import bulk_runs_device
    from hal_tpu_torch.tools import halLiftover as port_cli

    hal, src2, tgt2, bed = cli
    out_port = os.path.join(tmp, "port.bed")
    aln = bench["aln"]

    K.reset_launches()
    t0 = time.perf_counter()
    res = bulk_runs_device(aln, bench["src"], bench["tgt"], bench["lo"],
                           bench["hi"], aln.open_genome(bench["tgt"]),
                           device=dev)
    torch.cuda.synchronize()
    t_bulk = time.perf_counter() - t0
    bulk_counts = K.launches()
    t0 = time.perf_counter()
    port_cli.run([hal, src2, bed, tgt2, out_port, "--batchSize",
                  str(CLI_BATCH), "--device", "cuda"])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    counts = K.launches()
    log("phase 4 main path: bulk_runs_device %.1fs, halLiftover --device "
        "cuda %.1fs; launches %s (bulk_runs_device %s, the CLI %s)"
        % (t_bulk, t_cli, counts, bulk_counts,
           {k: c - bulk_counts[k] for k, c in counts.items()}))
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError("kernel %s was not launched on the main "
                                 "path" % name)

    if res is None:
        raise AssertionError("bulk_runs_device fell off the wire path")
    ro, rl, rh, rs, rr = res
    for o in bench["sample"]:
        m = ro == o
        got = sorted(zip(rs[m].tolist(), rl[m].tolist(), rh[m].tolist(),
                         rr[m].astype(int).tolist()))
        want = sorted((r[0], r[2], r[3], r[4]) for r in bench["want"][int(o)])
        if got != want:
            raise AssertionError("bulk_runs_device owner %d: %s != host %s"
                                 % (o, got, want))
    log("  bulk_runs_device: %d runs; %d sampled owners equal host "
        "extract_runs" % (len(ro), len(bench["sample"])))

    # the reference bytes: the same CLI on the CPU (the kernels' plain
    # versions; the CPU tests hold that run byte-equal to hal_tpu's CLI)
    out_cpu = os.path.join(tmp, "cpu.bed")
    t0 = time.perf_counter()
    port_cli.run([hal, src2, bed, tgt2, out_cpu, "--batchSize",
                  str(CLI_BATCH), "--device", "cpu"])
    t_cpu = time.perf_counter() - t0
    if K.launches() != counts:
        raise AssertionError("the --device cpu run launched a kernel")
    a = open(out_port, "rb").read()
    b = open(out_cpu, "rb").read()
    if not a or a != b:
        raise AssertionError("CLI output on --device cuda differs from "
                             "--device cpu (%d vs %d bytes)"
                             % (len(a), len(b)))
    log("  halLiftover %s -> %s: %d lines in, %d bytes out, byte-equal to "
        "the same CLI on --device cpu (%.1fs)"
        % (src2, tgt2, CLI_LINES, len(a), t_cpu))
    return counts


def host_profile(fn, top: int = 10) -> str:
    """Where the host's time goes in one call of fn (after a warm call):
    cProfile's functions by own time, as 'name own-ms/calls'."""
    import cProfile
    import pstats

    import torch

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(((v[2], k, v[1]) for k, v in st.stats.items()),
                  reverse=True)[:top]
    return "; ".join("%s:%s %.2f/%d" % (os.path.basename(k[0]), k[2],
                                         1e3 * t, n) for t, k, n in rows)


def profile_categories(rows) -> dict:
    """Device ms of a profile's rows by kind: the hand kernels, the
    scatters (index_add / scatter / index_copy) and everything else."""
    out = {"kernels": 0.0, "scatter": 0.0, "other": 0.0}
    for name, ms in rows:
        if "scan_kernel" in name or "searchsorted_right_kernel" in name:
            out["kernels"] += ms
        elif "index" in name.lower() or "scatter" in name.lower():
            out["scatter"] += ms
        else:
            out["other"] += ms
    return out


def check_launched(counts: dict, path: str) -> None:
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError("kernel %s was not launched on the %s path: "
                                 "%s" % (name, path, counts))


def cli_bytes_equal(run, argv, out_cuda, out_cpu, what) -> tuple:
    """Run a CLI on --device cuda, then on --device cpu; the two outputs
    must be equal bytes, every kernel must launch on the cuda run and none
    on the cpu run.  Returns (bytes, cuda s, cpu s, launches)."""
    import torch

    from hal_tpu_torch.ops import kernels as K

    K.reset_launches()
    t0 = time.perf_counter()
    run(argv(out_cuda) + ["--device", "cuda"])
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    counts = K.launches()
    check_launched(counts, what + " --device cuda")
    t0 = time.perf_counter()
    run(argv(out_cpu) + ["--device", "cpu"])
    t_cpu = time.perf_counter() - t0
    if K.launches() != counts:
        raise AssertionError("%s --device cpu launched a kernel" % what)
    a = open(out_cuda, "rb").read()
    b = open(out_cpu, "rb").read()
    if not a or a != b:
        raise AssertionError("%s: --device cuda output differs from --device "
                             "cpu (%d vs %d bytes)" % (what, len(a), len(b)))
    return len(a), t_cuda, t_cpu, counts


def wiggle_fixture(aln, genome: str, path: str) -> int:
    """A wiggle over the genome's first sequence from a seeded generator:
    WIG_BLOCKS fixedStep blocks of 100-2,000 positions and one variableStep
    block of 20,000 scattered positions (span 1).  Returns its positions."""
    g = aln.open_genome(genome)
    rng = np.random.default_rng(4)
    name = g.seq_names[0]
    slen = g.seq_length(0)
    n = 0
    with open(path, "w") as f:
        for a in np.sort(rng.integers(0, slen - 2000, WIG_BLOCKS)):
            k = int(rng.integers(100, 2000))
            f.write("fixedStep chrom=%s start=%d step=1\n" % (name, a + 1))
            f.write("".join("%g\n" % v for v in
                            np.round(rng.normal(size=k), 3)))
            n += k
        pos = np.sort(rng.choice(slen, 20000, replace=False))
        f.write("variableStep chrom=%s\n" % name)
        f.writelines("%d %g\n" % (p + 1, v) for p, v in
                     zip(pos, np.round(rng.random(20000), 2)))
    return n + 20000


def phase_depth(dev, bench, tmp, cli) -> dict:
    """The alignment-depth engine at bench scale, then its CLIs.  Returns
    the kernels' launches on one depth window (the unique-count run_runs
    drain of the 2^27-column window)."""
    import torch

    from hal_tpu_torch.ops import depth
    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.ops import tables
    from hal_tpu_torch.ops.column import compute_scope

    t_phase = time.perf_counter()
    aln, src = bench["aln"], bench["src"]
    scope, root = compute_scope(aln, src)
    window = min(DEPTH_WINDOW, int(aln.open_genome(src).length))
    log("phase 5 depth: %s, %d genomes in scope (root %s), window [0, %d)"
        % (src, len(scope), root, window))
    launches = None
    for count_dupes in (False, True):
        mode = "countDupes" if count_dupes else "unique"
        t0 = time.perf_counter()
        eng = depth.DepthEngine(aln, src, 0, window, scope, root,
                                count_dupes=count_dupes, device=dev)
        prep_s = time.perf_counter() - t0
        eng.run_device_only()  # warm: allocator and first launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, cols, total = eng.run_device_only()
        dev_s = time.perf_counter() - t0
        # bench.py's columns_per_s also times the sum of the window-sized
        # host dupe-count vector, which the port does once in host prep
        t0 = time.perf_counter()
        float(eng._host_base.sum())
        sum_s = time.perf_counter() - t0
        K.reset_launches()
        t0 = time.perf_counter()
        starts, vals, _w = eng.run_runs()
        runs_s = time.perf_counter() - t0
        if launches is None:
            launches = K.launches()
            check_launched(launches, "depth")
        drain_mb = 2 * 4 * tables._bucket_cap(len(starts)) / 1e6
        log("  %s: host prep %.2fs (%d device genomes, %d on the host); "
            "run_device_only %.4fs -> %.4g columns/s (mean depth %.4f); "
            "with the host-base sum bench.py's span also times (%.4fs) "
            "%.4g columns/s; run_runs %.4fs (device + RLE drain of %d "
            "runs, %.2f MB wire vs %.0f MB dense); launches per window %s"
            % (mode, prep_s, len(eng.jobs), len(scope) - len(eng.jobs),
               dev_s, cols / dev_s, mean, sum_s, cols / (dev_s + sum_s),
               runs_s, len(starts), drain_mb, 4 * window / 1e6,
               K.launches()))
        # where the time goes: device ms of the window, and per genome
        stats = {}
        dev_ms, rows = device_ms(eng._dispatch, iters=2, stats=stats)
        cat = profile_categories(rows)
        log("  %s profile: %.3f ms device/window (hand kernels %.3f, "
            "scatters %.3f, other %.3f) in %d device launches, against "
            "%.3f ms host clock (run_device_only): device idle %.0f%%, "
            "%.1f us of host per launch; top: %s"
            % (mode, dev_ms, cat["kernels"], cat["scatter"], cat["other"],
               stats["launches"], 1e3 * dev_s,
               100 * (1 - dev_ms / (1e3 * dev_s)),
               1e6 * dev_s / stats["launches"],
               "; ".join("%s %.3f" % (k[:40], ms) for k, ms in rows[:5])))
        log("  %s host profile of a window (own ms/calls): %s"
            % (mode, host_profile(eng.run_device_only)))
        for g, (path, lo, hi, caps) in zip(eng.genomes, eng.jobs):
            ms, grows = device_ms(
                lambda: depth._depth_one(path, lo, hi, caps, window,
                                         count_dupes), iters=2)
            c = profile_categories(grows)
            log("    %s: %.3f ms device (kernels %.3f, scatters %.3f, "
                "other %.3f), %d levels"
                % (g, ms, c["kernels"], c["scatter"], c["other"],
                   len(path.levels) + sum(1 + len(d) for _u, d in path.para)))
        # the whole window against the host engine
        t0 = time.perf_counter()
        want = depth.depth_counts(aln, src, 0, window, scope, root,
                                  count_dupes)
        host_s = time.perf_counter() - t0
        got = depth.rle_decode(starts, vals, window)
        dense = total.cpu().numpy().astype(np.int64) + eng._host_base - 1
        if not (np.array_equal(got, want) and np.array_equal(dense, want)):
            bad = np.flatnonzero((got != want) | (dense != want))
            raise AssertionError("depth %s: device counts != host depth_counts "
                                 "at %d of %d columns (first %d)"
                                 % (mode, len(bad), window, bad[0]))
        log("  %s: all %d columns (RLE drain and dense drain) equal host "
            "depth_counts (host %.1fs)" % (mode, window, host_s))
        del eng, total, got, want, dense
    torch.cuda.empty_cache()

    from hal_tpu_torch.tools import halAlignmentDepth, halWiggleLiftover

    hal, src2, tgt2, _bed = cli
    n, t_cuda, t_cpu, c = cli_bytes_equal(
        halAlignmentDepth.run,
        lambda out: [hal, src2, "--outWiggle", out, "--length",
                     str(DEPTH_CLI_COLUMNS)],
        os.path.join(tmp, "depth_cuda.wig"),
        os.path.join(tmp, "depth_cpu.wig"), "halAlignmentDepth")
    log("  halAlignmentDepth %s (%d columns): %d bytes, --device cuda %.1fs "
        "equal to --device cpu %.1fs; launches %s"
        % (src2, DEPTH_CLI_COLUMNS, n, t_cuda, t_cpu, c))
    from hal_tpu_torch.storage import open_alignment

    wig = os.path.join(tmp, "in.wig")
    n_pos = wiggle_fixture(open_alignment(hal), src2, wig)
    n, t_cuda, t_cpu, c = cli_bytes_equal(
        halWiggleLiftover.run,
        lambda out: [hal, src2, wig, tgt2, out],
        os.path.join(tmp, "wig_cuda.wig"), os.path.join(tmp, "wig_cpu.wig"),
        "halWiggleLiftover")
    log("  halWiggleLiftover %s -> %s (%d positions): %d bytes, --device "
        "cuda %.1fs equal to --device cpu %.1fs; launches %s"
        % (src2, tgt2, n_pos, n, t_cuda, t_cpu, c))
    log("phase 5 passed in %.1fs" % (time.perf_counter() - t_phase))
    return launches


def build_maf_alignment(n_segments: int, seed: int = 11):
    """bench.py's MAF fixture (bench_hal2maf): 10 genomes of n_segments
    segments of 128-129 bp, with DNA."""
    from hal_tpu_torch.randgen import create_random_alignment

    return create_random_alignment(
        seed=seed, max_genomes=N_GENOMES, min_genomes=N_GENOMES - 1,
        mean_degree=1.5, max_branch_length=0.2, min_segment_length=128,
        max_segment_length=129, min_segments=n_segments,
        max_segments=n_segments + 100, fast_dna=True)


def phase_maf(dev, tmp) -> dict:
    """The device column engine at bench scale through the native
    assembler, then the hal2maf CLI.  Returns the kernels' launches on the
    first MAF window."""
    import torch

    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.ops.column_native import NativeMafExporter
    from hal_tpu_torch.ops.column_torch import DeviceColumnEngine, run_program

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    aln = build_maf_alignment(MAF_SEGMENTS)
    # bench.py's reference: the first leaf of at least 100 Mb
    min_len = min(100 * 10 ** 6, 96 * MAF_SEGMENTS)
    ref = [n for n in aln.genome_names() if aln.tree.is_leaf(n)
           and aln.open_genome(n).length >= min_len][0]
    glen = int(aln.open_genome(ref).length)
    log("phase 6 device MAF fixture: %d genomes of %d segments, ref %s "
        "%.1f Mb, in %.1fs" % (aln.num_genomes, MAF_SEGMENTS, ref, glen / 1e6,
                               time.perf_counter() - t0))
    t0 = time.perf_counter()
    eng = DeviceColumnEngine(aln, ref, device=dev)
    log("  engine: %d programs, %d distinct levels (%d program levels), "
        "dtype %s, in %.1fs"
        % (len(eng.jobs), len(eng.levels),
           sum(len(j[1].ops) for j in eng.jobs), eng.dtype.name,
           time.perf_counter() - t0))
    W = MAF_WINDOW
    if glen < (MAF_TIMED_WINDOWS + 1) * W:
        raise AssertionError("reference too short for %d windows"
                             % (MAF_TIMED_WINDOWS + 1))
    t0 = time.perf_counter()
    ex_dfs = NativeMafExporter(aln, ref)
    want = ex_dfs.export(0, W) + ex_dfs.finish()
    ex_dfs.close()
    t_dfs = time.perf_counter() - t0
    ex = NativeMafExporter(aln, ref)
    K.reset_launches()
    t0 = time.perf_counter()
    got = eng.export_native(ex, 0, W) + ex.finish()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = K.launches()
    check_launched(launches, "device MAF")
    ex.close()
    if got != want:
        raise AssertionError("device MAF != native DFS MAF on [0, %d) (%d vs "
                             "%d bytes)" % (W, len(got), len(want)))
    log("  window [0, %d): %.1f MB MAF byte-equal to the native DFS engine "
        "(DFS %.2fs; device engine, first window incl. host sizing, %.2fs); "
        "launches per window %s" % (W, len(want) / 1e6, t_dfs, t_first,
                                    launches))

    # e2e: dispatch, drain, host decode and native assembly per window
    ex = NativeMafExporter(aln, ref)
    stages = {"size+dispatch": 0.0, "device wait": 0.0, "drain": 0.0,
              "decode": 0.0, "assemble": 0.0}
    nbytes = 0
    windows = [(k * W, (k + 1) * W) for k in range(1, MAF_TIMED_WINDOWS + 1)]
    torch.cuda.synchronize()
    t_e2e = time.perf_counter()
    for gs, ge in windows:
        t0 = time.perf_counter()
        big, tots, ovf, oc_all = eng.dispatch_window_packed(gs, ge)
        t1 = time.perf_counter()
        if bool(ovf.item()):  # beyond the first window's caps: exact re-size
            for ji in range(len(eng.jobs)):
                eng._caps[(ji, ge - gs)] = eng._size(ji, gs, ge, slack=1.0)
            big, tots, ovf, oc_all = eng.dispatch_window_packed(gs, ge)
            if bool(ovf.item()):
                raise AssertionError("MAF window overflow under exact sizing")
        t2 = time.perf_counter()
        big_np, tots_np = big.cpu().numpy(), tots.cpu().numpy()
        t3 = time.perf_counter()
        frags = eng.collect_packed(big_np, tots_np, oc_all, gs, ge)
        t4 = time.perf_counter()
        nbytes += len(ex.export_frags(gs, ge, frags))
        t5 = time.perf_counter()
        for k, a, b in (("size+dispatch", t0, t1), ("device wait", t1, t2),
                        ("drain", t2, t3), ("decode", t3, t4),
                        ("assemble", t4, t5)):
            stages[k] += b - a
    nbytes += len(ex.finish())
    e2e_s = time.perf_counter() - t_e2e
    ex.close()
    cols = MAF_TIMED_WINDOWS * W
    # device phase: dispatch + one scalar sync per window (sized already)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for gs, ge in windows:
        _big, _tots, ovf, _oc = eng.dispatch_window_packed(gs, ge)
        if bool(ovf.item()):
            raise AssertionError("MAF window overflow in the device phase")
    dev_s = time.perf_counter() - t0
    log("  %d windows of %d columns: e2e %.3fs -> %.4g columns/s (%.1f MB "
        "MAF); device phase %.3fs -> %.4g columns/s; e2e stages (s): %s"
        % (MAF_TIMED_WINDOWS, W, e2e_s, cols / e2e_s, nbytes / 1e6, dev_s,
           cols / dev_s, {k: round(v, 4) for k, v in stages.items()}))
    gs, ge = windows[0]
    stats = {}
    dev_ms, rows = device_ms(lambda: eng.dispatch_window_packed(gs, ge),
                             iters=2, stats=stats)
    cat = profile_categories(rows)
    win_s = dev_s / MAF_TIMED_WINDOWS
    log("  profile window: %.3f ms device (hand kernels %.3f, scatters %.3f, "
        "other %.3f) in %d device launches, against %.3f ms host clock per "
        "window in the device phase: device idle %.0f%%, %.1f us of host "
        "per launch; top: %s"
        % (dev_ms, cat["kernels"], cat["scatter"], cat["other"],
           stats["launches"], 1e3 * win_s, 100 * (1 - dev_ms / (1e3 * win_s)),
           1e6 * win_s / stats["launches"],
           "; ".join("%s %.3f" % (k[:40], ms) for k, ms in rows[:5])))
    log("  host profile of a window's dispatch (own ms/calls): %s"
        % host_profile(lambda: eng.dispatch_window_packed(gs, ge)[2].item()))
    lo, hi = eng._window(gs, ge)
    per = []
    for ji, (t, spec, levels, meta) in enumerate(eng.jobs):
        caps, oc = eng._caps[(ji, ge - gs)]
        ms, _rows = device_ms(lambda: run_program(levels, lo, hi, caps,
                                                  meta, oc), iters=2)
        per.append((ms, t, spec.ordinal, len(spec.ops)))
    per.sort(reverse=True)
    log("  device ms per program (largest first; target, ordinal, levels): "
        "%s; sum %.3f ms"
        % ("; ".join("%.3f %s/%d/%d" % p for p in per[:8]),
           sum(p[0] for p in per)))
    del eng, aln
    torch.cuda.empty_cache()

    from hal_tpu_torch.storage import save_alignment
    from hal_tpu_torch.tools import hal2maf

    small = build_maf_alignment(1 << 14, seed=12)
    hal = os.path.join(tmp, "maf.halz")
    save_alignment(small, hal, fmt="halz")
    ref2 = [n for n in small.genome_names() if small.tree.is_leaf(n)][0]
    n, t_cuda, t_cpu, c = cli_bytes_equal(
        hal2maf.run, lambda out: [hal, out, "--refGenome", ref2],
        os.path.join(tmp, "cuda.maf"), os.path.join(tmp, "cpu.maf"),
        "hal2maf")
    log("  hal2maf --refGenome %s (%.1f Mb, %d genomes): %d bytes, --device "
        "cuda %.1fs equal to --device cpu %.1fs; launches %s"
        % (ref2, small.open_genome(ref2).length / 1e6, small.num_genomes, n,
           t_cuda, t_cpu, c))
    log("phase 6 passed in %.1fs" % (time.perf_counter() - t_phase))
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "hal_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(hal_tpu_torch/ not found beside this script)")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))
    phase_build()
    t0 = time.perf_counter()
    rec = phase_kernels(dev)
    log("phase 2 passed in %.1fs" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    bench = phase_bench_scale(dev)
    log("phase 3 passed in %.1fs" % (time.perf_counter() - t0))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli = cli_fixture(tmp)
        counts = phase_main_path(dev, bench, tmp, cli)
        log("phase 4 passed in %.1fs" % (time.perf_counter() - t0))
        paths = {"liftover": counts,
                 "depth": phase_depth(dev, bench, tmp, cli)}
        del bench
        paths["maf"] = phase_maf(dev, tmp)
    for name, c in counts.items():
        rec[name]["launches"] = c
        rec[name]["launches_by_path"] = {p: n[name] for p, n in paths.items()}
    log("all phases passed in %.1fs" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": [rec[k] for k in ("searchsorted_right",
                                                   "cumsum_i32",
                                                   "cummax_i32")]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

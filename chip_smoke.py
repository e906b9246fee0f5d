#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (hal_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. build the CUDA kernels from hal_tpu_torch/csrc with nvcc (sm_90a);
  2. each kernel against its plain PyTorch version on the card, exact
     integer equality (searchsorted at grids around its sector, fence
     and tree-level edges up to its grid limit, with duplicates, misaligned
     views, uint32-range int64 queries and a second stream; the scans also at
     their tile edges, on wrapping sums, INT32_MIN/MAX, reused state, a
     second stream and in place), each timed in turns against its plain
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
     (the plain kernel versions), and every kernel must have launched.

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


def device_ms(fn, iters: int = 20):
    """Device time of fn() per call from torch.profiler: the sum over the
    CUDA kernels and copies it ran, and those per name, largest first."""
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
        rows = sorted(((e.key, e.self_device_time_total / 1e3 / iters)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not e.key.startswith("Activity Buffer")),
                      key=lambda r: -r[1])
        if rows:
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
    from hal_tpu_torch.ops import _build

    found = _build.library_path().exists()
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log("phase 1 build: %s %s in %.2fs"
        % (os.path.relpath(so, REPO),
           "found, not rebuilt" if found else "built with nvcc",
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


def phase_main_path(dev, bench, tmp) -> dict:
    import torch

    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.ops.liftover_bulk import bulk_runs_device
    from hal_tpu_torch.tools import halLiftover as port_cli

    hal, src2, tgt2, bed = cli_fixture(tmp)
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
    rec = phase_kernels(dev)
    bench = phase_bench_scale(dev)
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_main_path(dev, bench, tmp)
    for name, c in counts.items():
        rec[name]["launches"] = c
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

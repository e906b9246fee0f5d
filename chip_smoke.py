#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (hal_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --hub-only [--hub-segments N]   # phases 1 and 8
    python3 chip_smoke.py --analysis-only [--analysis-segments N]  # 1 and 9
    python3 chip_smoke.py --regions-only [--analysis-segments N]   # 1 and 10
    python3 chip_smoke.py --editing-only [--analysis-segments N]   # 1 and 11

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
     included), the map and one level's lookup timed with the
     searchsorted kernel against the paged binary search, and the
     compaction programs (compact, compact_packed, compact_u32_fixed with
     decode_u32_fixed) on the first run's fragment matrix against plain
     torch selections of the same rows, each timed;
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
  5b. the sharded steps (hal_tpu_torch.parallel) on phase 3's fixture,
     over an NCCL process group of world size 1 with 4 local shards on the
     card: the replicated step at mesh (2, 2) and the table-sharded step
     at D = 4 on exact per-shard host caps, each with its valid fragments
     (as sorted rows) equal to the single-device _run_path's and its
     histogram equal to an int64 histogram of them; the ring-sharded step
     at D = 4 held to the single-device path by the mapped bases per owner,
     the target coverage of the first 2^27 columns and 2,048 sampled
     owners' base pairs against the host mapper; distributed_coverage of
     the first 2^27 target columns against the single-device coverage;
     merge_sorted_blocks of the 2^20 lo values against np.sort.  Each step
     timed by CUDA events over 10 calls, with the profiler's device ms and
     the share of it in NCCL kernels;
  6. the device column engine (hal2maf) on bench.py's MAF fixture (seed
     11, 10 genomes of 2^20 segments of 128-129 bp, DNA): the first
     2^21-column window through the native assembler byte-equal to the
     native DFS engine, the sharded column step at 4 local shards over the
     same window byte-equal to it too, then six windows timed (device phase
     and end to end), and the hal2maf CLI on a smaller DNA alignment,
     --device cuda bytes equal to --device cpu.
  6b. remote alignments: the directory of phases 4-6 served over HTTP with
     byte ranges by a process this script starts (HAL_TPU_UDC_DIR under
     it), and the halLiftover, halAlignmentDepth and hal2maf runs of
     phases 4-6 repeated on --device cuda with the URL in place of the
     path, each with a fresh block cache: the bytes equal to the local
     run's, with seconds, HTTP requests and bytes fetched beside the
     local run's seconds and the halz's bytes; one 25 bp interval mapped
     by the host map_source over the URL fetches under 5% of the remote
     arrays' bytes; then hal_tpu_torch.tools.benchOverlap --device cuda
     twice in a subprocess (its defaults, and the liftover's shape: a
     6.8 MB wire, 2048^2 matmuls x 8), each checking its drained wires.
  7. the phyloP fit: phylop_lnl against lnl_plain in float64 (max
     relative error 1e-5; the float32 plain version's own error printed
     beside it), both launch shapes of phylop_fit bit-identical at 2^14
     patterns, and the 241-leaf CONACC fit of 2^20 simulated patterns,
     kernel (three calls, equal outputs) against the plain version (once),
     scored on a 2^14 subsample and against the float64 numpy fit on 1,024
     (the float32 tolerance of tests/test_phylop_jax.py), the other modes
     and the subtree fit on a 16-leaf tree, each timed with its bound; then
     PhyloPScorer(device="cuda") over two 2^20-column windows of phase 6's
     MAF fixture, against device="cpu" on [0, 2^16), the fit timed at that
     path's shape (its model, one window's new patterns), and the halPhyloP
     CLI on 2^18 columns of phase 6's CLI alignment, --device cuda against
     --device cpu.
  8. the assembly hub: hal2assemblyHub --lod --gcContent --rmsk
     --alignability --numProc 4 on --device cuda over every leaf of a DNA
     alignment (bench.py's MAF fixture shape, seed 13, HUB_SEGMENTS
     segments a genome), and on --device cpu over one leaf: that leaf's
     FASTA, chrom.sizes, GC, repeat-mask and alignability wiggles and
     bigWig/bigBed files, hub.txt, groups.txt, lod.txt and every LOD file
     byte-equal, its trackDb.txt equal up to the hubs' genome lists; the
     conservation hub (--genomes, --conservation) of phase 6's CLI
     alignment under phase 7's model against halPhyloP --device cpu
     (headers equal, the first 2^16 values of each sequence within the
     float32 tolerance); halLodBenchmark --steps 2,4 --doMaf --format halz,
     cuda against cpu (MAF line counts equal); hal2mafMP --sliceSize 2^20
     --numProc 4, cuda against cpu (bytes equal), a host path (each slice
     runs hal2maf --unique, outside the device engine).  The jobs run in
     subprocesses, each appending its argv, seconds and launches to the
     port's HAL_TPU_TORCH_LAUNCH_LOG; each job's seconds are printed.
  9. the comparative-analysis tools on phase 4's CLI alignment shape with
     DNA (seed 11, 2^12-1.5 x 2^12 segments of ~2 kb a genome):
     halValidate; halSynteny on the deepest leaf pair, whole genome;
     halLiftoverStatus of 2^14 BED12 genes; syntenyRates of 2^12 sorted
     genes; the neutral-indel pipeline (halTreeMutations,
     halTreeNIBackground, halTreeNIConservation, then
     halTreeNITurnover); runDotplot of one sequence.  Each lifting tool
     runs with --device cuda in this process, under the profiler (its
     seconds and the card's device time; runDotplot in a subprocess, its
     halLiftover job in the launch log), and with --device cpu in a
     subprocess beside it: every file it writes, its stdout and its
     stderr equal between the two.
  10. the region and SNP tools on phase 9's alignment (made here under
     --regions-only): halSnps --tsv of the whole source genome against
     three leaves, with dupes and with --noDupes; halContiguousRegions of
     every source sequence; halSingleCopyRegionsExtract of the whole
     source against every leaf; findRegionsExclusivelyInGroup with a
     two-leaf ingroup; hal4dExtract --conserved of 2^10 of phase 9's
     BED12 genes; each on --device cuda in this process under the
     profiler and on --device cpu in a subprocess beside it, files,
     stdout and stderr equal between the two.
  11. the editing, import and generation tools.  ancestorsML of the root
     of phase 6's MAF fixture (made here under --editing-only; its root
     over 9 leaves, ~134 Mb a genome), saved as mmap: --device cuda in
     this process under the profiler and alone on the host, timed (open,
     likelihood pass, save) with its device ms and peak memory, then
     --device cpu on a copy in a subprocess; the segment map of every
     child (rows and reversal per position, through cummax_i32) equal to
     the plain scan's at every position; the root's new DNA equal under
     the tie rule (a differing base must be one where the cpu pass's two
     largest posteriors lie within 1e-12, or its largest within 1e-12 of
     --thresholdN), every other genome and table unchanged, stderr
     equal.  ancestorsMLMP on copies of phase 9's alignment, cuda against
     cpu, every ancestor's DNA equal under the tie rule.  halSetMetadata,
     halRenameGenomes, halRenameSequences, halUpdateBranchLengths,
     halWriteNucleotides, halRemoveGenome, halRemoveSubtree, halExtract
     (a subtree), halAppendSubtree (it back) and halReplaceGenome (an
     identical donor) on copies of phase 9's alignment, each result
     validated and a halLiftover across the edit, cuda in this process
     against cpu in a subprocess, bytes equal; hal2maf of one sequence,
     maf2hal of it, halValidate, and hal2maf of the import, cuda against
     cpu; halRandGen, halExtract to mmap and halTestGen files valid,
     benchMark --formats halz,mmap, runAndGetResources around halValidate,
     and halPhyloPTrain exiting 1 with the reference's phast message.
Phases 4-11 (6b included) each drive a path with the launch counts set to
0 just before and read just after; the three Pallas kernels' ports must
launch on every path (on the "sharded" path, on each step's first call:
the four steps of phase 5b and the sharded column step of phase 6; on the
"hub" path in every card job: each alignability job, the conservation
job and halLodBenchmark's hal2maf runs, whose counts start at 0 in their
own processes; on the "analysis" path in every card run of a lifting
tool, runDotplot's halLiftover job included; on the "regions" path in
every card run; on the "editing" path in every card lift and hal2maf run
of phase 11), phylop_fit on the phyloP path and in the conservation job,
cummax_i32 in every card run of ancestorsML (the "ancestors" path: phase
11's in-process run and each ancestorsML job of ancestorsMLMP), and no
kernel in a --device cpu job.

Everything runs on hal_tpu_torch alone: its host modules (randgen,
storage, segmap_host, liftover) make the fixtures and the host oracle.

The last lines are the four kernels' JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
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
SHARDS = 4                   # local shards on the one card
SHARDED_BINS = 1024          # the replicated step's histogram bins
PHYLOP_LEAVES = 241          # the 241-mammal phyloP runs on Cactus alignments
PHYLOP_PATTERNS = 1 << 20    # one window of columns, nearly all unique
PHYLOP_SCORED = 1 << 14
PHYLOP_EXACT = 1024
PHYLOP_SMALL_LEAVES = 16
PHYLOP_SMALL_PATTERNS = 1 << 14
PHYLOP_WINDOW = 1 << 20      # halPhyloP's WINDOW
PHYLOP_CPU_COLUMNS = 1 << 16
PHYLOP_CLI_COLUMNS = 1 << 18
# phase 8: the assembly hub's DNA alignment (bench.py's MAF fixture shape),
# cut from 2^18 segments a genome to 2^10 to fit the phase in ~150 s: the
# hub's serial Python track writing grows ~21 s on the card's host per
# 2^10 segments (PERF.md section 4, "reduced")
HUB_SEGMENTS = 1 << 10
HUB_SEED = 13
HUB_PROCS = 4                # the hub's --numProc, hal2mafMP's too
HUB_LOD_STEPS = "2,4"        # halLodBenchmark --steps
HUB_PHYLOP_CPU_COLUMNS = 1 << 16
MAFMP_SLICE = 1 << 20        # hal2mafMP --sliceSize
# phase 9: the analysis tools on phase 4's CLI alignment shape (seed 11,
# 1900-2100 bp segments) with DNA, which their PSL output reads, cut from
# 40,000-60,000 segments a genome to 2^12-1.5 x 2^12 (~10 Mb genomes):
# halSynteny's chaining visits every block once a path it extracts, so
# its host time grows with the square of the genome (PERF.md section 4,
# "reduced")
ANALYSIS_SEGMENTS = 1 << 12
ANALYSIS_STATUS_GENES = 1 << 14
ANALYSIS_RATE_GENES = 1 << 12
# halTreeNIConservation's p-value and cut: the fixture's indels are rare
# (~3 a Mb), so the defaults (0.05, 0.5) call no conserved interval and
# halTreeNITurnover would lift nothing
ANALYSIS_NI_FLAGS = ("--pval", "0.5", "--cutoff", "0.1")
# phase 10: the region and SNP tools on phase 9's alignment, whole genome
REGIONS_SNP_TARGETS = 3      # halSnps' leaves
REGIONS_INGROUP = 2          # findRegionsExclusivelyInGroup's ingroup leaves
REGIONS_GENES = 1 << 10      # hal4dExtract --conserved: analysis_genes' BED12
# phase 11: ancestorsML on phase 6's MAF fixture (its root over 9 leaves,
# ~134 Mb a genome), ancestorsMLMP and the editing tools on phase 9's
# alignment
EDIT_LIFT_LINES = 1 << 12    # BED intervals of each lift across an edit
ML_THRESHOLD = 0.9           # ancestorsML's default --thresholdN
ML_TIE = 1e-12               # the tie rule: a posterior gap or distance
PHAST_MESSAGE = ("hal exception caught: halPhyloPTrain requires the phast "
                 "package (phyloFit not found on PATH; reference gates this "
                 "behind ENABLE_PHYLOP)\n")
# The subtree fit's 4 alternating rounds stop short of convergence on a
# ridge of (scale, subtree scale), so its float32 result depends on
# rounding: the JAX package's float32 program and the port's plain float32
# fit put up to 1% of a 16-leaf tree's patterns outside the float32
# tolerance (tests/test_torch_phylop.py::test_f32_subtree_fit_agrees_with_jax_f32).
SUBTREE_F32_SHARE = 0.01

# H100 SXM data sheet: HBM bytes/s; 32-bit non-tensor operations/s (the
# float32 rate, the table's rate for 32-bit ALU work)
HBM_BYTES_PER_S = 3.35e12
ALU32_OPS_PER_S = 67e12
# special-function results (exp, log): 16 a clock per SM (NVIDIA's
# arithmetic throughput table for compute capability 9.0) x 132 SMs x
# 1.98 GHz, the SM clock nvidia-smi reports as its maximum
SM_CLOCK_HZ = 1.98e9
SFU_OPS_PER_S = 16 * 132 * SM_CLOCK_HZ

# the three Pallas kernels' ports, required on every path
PALLAS_PORTS = ("searchsorted_right", "cumsum_i32", "cummax_i32")

REPLACES = {
    "searchsorted_right": "hal_tpu/ops/pallas_kernels.py:52",
    "cumsum_i32": "hal_tpu/ops/pallas_kernels.py:186",
    "cummax_i32": "hal_tpu/ops/pallas_kernels.py:185",
    "phylop_fit": "hal_tpu/phylop_jax.py:166",
}
SOURCES = {
    "searchsorted_right": "hal_tpu_torch/csrc/searchsorted.cu",
    "cumsum_i32": "hal_tpu_torch/csrc/scan.cu",
    "cummax_i32": "hal_tpu_torch/csrc/scan.cu",
    "phylop_fit": "hal_tpu_torch/csrc/phylop_fit.cu",
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
    per call, and "mesh": the device ms per call under the mesh's
    collective ranges (mesh.psum, mesh.all_gather, mesh.all_to_all)."""
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
                stats["mesh"] = sum(e.device_time_total / 1e3 / iters
                                    for e in prof.key_averages()
                                    if e.key.startswith("mesh."))
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
           "found, not rebuilt" if found else
           "built with one nvcc per source, in parallel",
           time.perf_counter() - t0))
    for line in _build.BUILD_LOG:
        log("  " + line)
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


def compaction_checks(st, F, out_cols: int, final: int) -> None:
    """segmap_torch's compaction programs (compact, compact_packed,
    compact_u32_fixed at the host-sized out_cols and 8 length bits, and
    decode_u32_fixed) on phase 3's fragment matrix, each against its plain
    torch version (a boolean-mask selection of the same rows), exactly;
    each timed (CUDA events) beside its plain version."""
    import torch

    valid = F[st.C_VALID] > 0
    Fl = F.to(torch.int64)
    ln = Fl[st.C_SHI] - Fl[st.C_SLO]
    u32 = torch.stack([Fl[st.C_SLO], Fl[st.C_TLO], (Fl[st.C_OWN] << 9)
                       | (ln << 1) | Fl[st.C_REV]])

    def plain_u32():
        rows = u32[:, valid]
        return torch.where(rows >= 1 << 31, rows - (1 << 32), rows).to(
            torch.int32)

    # name: (program, its plain version, the program's row matrices and
    # count of its result)
    programs = {
        "compact": (lambda: st.compact(F), lambda: (F[:6][:, valid],),
                    lambda r: (r[:1], r[1])),
        "compact_packed": (
            lambda: st.compact_packed(F),
            lambda: (F[[st.C_SLO, st.C_TLO]][:, valid],
                     torch.stack([ln, Fl[st.C_REV], Fl[st.C_OWN]])[:, valid]
                     .to(torch.int32)),
            lambda r: (r[:2], r[2])),
        "compact_u32_fixed": (lambda: st.compact_u32_fixed(F, out_cols, 8),
                              lambda: (plain_u32(),),
                              lambda r: (r[:1], r[1])),
    }
    times = []
    for name, (prog, plain, rows_of) in programs.items():
        res = prog()
        got, count = rows_of(res)
        k = int(count.item())
        if k != final:
            raise AssertionError("%s: count %d != %d" % (name, k, final))
        for a, b in zip(got, plain()):
            if not (torch.equal(a[:, :k], b) and not a[:, k:].any()):
                raise AssertionError("%s differs from its plain version"
                                     % name)
        if name == "compact_u32_fixed":
            if bool(res[2].item()):
                raise AssertionError("compact_u32_fixed flagged overflow")
            dec = st.decode_u32_fixed(st.wire_to_host(res[0]), k, 8)
            M = F[:, valid].cpu().numpy().astype(np.int64)
            for x, r in zip(dec, (st.C_SLO, st.C_SHI, st.C_TLO, st.C_THI,
                                  st.C_REV, st.C_OWN)):
                if not np.array_equal(x, M[r]):
                    raise AssertionError("decode_u32_fixed row %d" % r)
        times.append("%s %.3f ms (plain %.3f ms)"
                     % (name, time_ms(prog), time_ms(plain)))
    log("  compaction programs on this F (%d of %d columns valid) equal "
        "their plain versions: %s" % (final, F.shape[1], "; ".join(times)))


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
    check_launched(counts, "bench-scale liftover")
    lookup_vs_paged(st, path, lo_d, hi_d, own_d, caps, F)
    compaction_checks(st, F, out_cols, final)

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
            "sample": sample, "want": want, "path": path, "caps": caps,
            "totals": totals}


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


def phase_main_path(dev, bench, tmp, cli, runs) -> dict:
    """The liftover main path; records its CLI run in runs (the remote
    phase repeats it on a URL)."""
    import torch

    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.ops.liftover_bulk import bulk_runs_device
    from hal_tpu_torch.tools import halLiftover as port_cli

    hal, src2, tgt2, bed = cli
    out_port = os.path.join(tmp, "port.bed")

    def argv(h, out):
        return [h, src2, bed, tgt2, out, "--batchSize", str(CLI_BATCH)]

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
    port_cli.run(argv(hal, out_port) + ["--device", "cuda"])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    counts = K.launches()
    log("phase 4 main path: bulk_runs_device %.1fs, halLiftover --device "
        "cuda %.1fs; launches %s (bulk_runs_device %s, the CLI %s)"
        % (t_bulk, t_cli, counts, bulk_counts,
           {k: c - bulk_counts[k] for k, c in counts.items()}))
    check_launched(counts, "liftover main")

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
    port_cli.run(argv(hal, out_cpu) + ["--device", "cpu"])
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
    runs["halLiftover"] = dict(run=port_cli.run, argv=argv, hal=hal,
                               out=out_port, seconds=t_cli)
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


def check_launched(counts: dict, path: str, names=PALLAS_PORTS) -> None:
    """Every kernel of the path (names) launched at least once."""
    for name in names:
        if counts[name] <= 0:
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


def phase_depth(dev, bench, tmp, cli, runs) -> dict:
    """The alignment-depth engine at bench scale, then its CLIs (the
    halAlignmentDepth run recorded in runs).  Returns the kernels' launches
    on one depth window (the unique-count run_runs drain of the
    2^27-column window)."""
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

    def depth_argv(h, out):
        return [h, src2, "--outWiggle", out, "--length",
                str(DEPTH_CLI_COLUMNS)]

    out = os.path.join(tmp, "depth_cuda.wig")
    n, t_cuda, t_cpu, c = cli_bytes_equal(
        halAlignmentDepth.run, lambda o: depth_argv(hal, o), out,
        os.path.join(tmp, "depth_cpu.wig"), "halAlignmentDepth")
    runs["halAlignmentDepth"] = dict(run=halAlignmentDepth.run,
                                     argv=depth_argv, hal=hal, out=out,
                                     seconds=t_cuda)
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


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sorted_columns(F):
    """F's valid columns (int64), sorted as rows over all 8 fields: the
    fragment multiset, whatever the slot layout."""
    import torch

    M = F[:, F[6] > 0].to(torch.int64)
    for r in range(M.shape[0] - 1, -1, -1):
        M = M[:, torch.sort(M[r], stable=True).indices]
    return M


def window_coverage(F, width: int):
    """Per-position target coverage of F's valid fragments over [0, width)
    (int64 diff + cumsum on the device)."""
    import torch

    valid = (F[6] > 0).to(torch.int64)
    d = torch.zeros(width + 1, dtype=torch.int64, device=F.device)
    d.index_add_(0, torch.clamp(F[2].to(torch.int64), 0, width), valid)
    d.index_add_(0, torch.clamp(F[3].to(torch.int64), 0, width), -valid)
    return torch.cumsum(d, 0)[:width]


def host_histogram(F, tgt_len: int, n_bins: int) -> np.ndarray:
    """int64 numpy histogram of F's valid fragments' target bases, binned
    by t_lo (the replicated step's binning, computed on the host)."""
    M = F[:, F[6] > 0].cpu().numpy().astype(np.int64)
    h = np.zeros(n_bins, np.int64)
    np.add.at(h, np.clip(M[2] * n_bins // tgt_len, 0, n_bins - 1),
              M[3] - M[2])
    return h


def owner_pairs(s_lo, s_hi, t_lo, t_hi, rev, own):
    """(owner, src base, tgt base, rev) rows of fragments, deduplicated."""
    ln = (s_hi - s_lo).astype(np.int64)
    rep = np.repeat(np.arange(len(ln)), ln)
    k = np.arange(int(ln.sum())) - (np.cumsum(ln) - ln)[rep]
    tgt = np.where(rev[rep] > 0, t_hi[rep] - 1 - k, t_lo[rep] + k)
    return np.unique(np.stack([own[rep], s_lo[rep] + k, tgt, rev[rep]],
                              axis=1), axis=0)


def time_step(name: str, fn, counts: dict) -> dict:
    """A sharded step's CUDA-event ms over 10 calls, the profiler's device
    ms per call, and the share of it in its collectives (the mesh's
    ranges: local copies and NCCL alike) and in NCCL kernels; counts are
    its launches from 0 on its first call."""
    ev = time_ms(fn, iters=TIMED_ITERS)
    stats = {}
    dev_ms, rows = device_ms(fn, iters=2, stats=stats)
    nccl = sum(ms for k, ms in rows if "nccl" in k.lower())
    log("  %s: %.3f ms a call (CUDA events, %d calls), %.3f ms device "
        "(profiler) in %d launches: collectives %.4f ms (%.1f%%), of which "
        "NCCL kernels %.4f ms; launches %s; top: %s"
        % (name, ev, TIMED_ITERS, dev_ms, stats["launches"], stats["mesh"],
           100 * stats["mesh"] / dev_ms, nccl, counts,
           "; ".join("%s %.3f" % (k[:40], ms) for k, ms in rows[:4])))
    return {"event_ms": ev, "device_ms": dev_ms, "mesh_ms": stats["mesh"],
            "nccl_ms": nccl}


def phase_sharded(dev, bench, group) -> dict:
    """The sharded steps on phase 3's fixture, over the NCCL group of world
    size 1 with SHARDS local shards on the card, each held to the
    single-device path.  Returns the kernels' launches summed over the
    steps' first calls (each from 0), and each step's times."""
    import torch

    from hal_tpu_torch.graft_entry import per_shard_caps
    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.ops import segmap_torch as st
    from hal_tpu_torch.ops import tables
    from hal_tpu_torch.parallel import distributed as dist
    from hal_tpu_torch.parallel import ring_sharded as pr
    from hal_tpu_torch.parallel import sharded as ps

    t_phase = time.perf_counter()
    aln, src, tgt = bench["aln"], bench["src"], bench["tgt"]
    lo, hi, path = bench["lo"], bench["hi"], bench["path"]
    n = len(lo)
    owner = np.arange(n, dtype=np.int64)
    tgt_len = int(aln.open_genome(tgt).length)
    log("phase 5b sharded: %s -> %s, %d intervals, NCCL group of world "
        "size %d, %d local shards on %s"
        % (src, tgt, n, torch.distributed.get_world_size(group), SHARDS,
           torch.cuda.get_device_name(dev)))
    lo_d, hi_d, own_d = (st.coords(path, x) for x in (lo, hi, owner))
    F_ref = st._run_path(path, lo_d, hi_d, own_d, bench["caps"])[0]
    ref_cols = sorted_columns(F_ref)
    launched = {k: 0 for k in K.launches()}
    timings = {}

    def first_call(name, fn):
        K.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = K.launches()
        check_launched(counts, "sharded (%s)" % name)
        for k, c in counts.items():
            launched[k] += c
        return out, counts

    def same_fragments(F, what):
        got = sorted_columns(F)
        if not torch.equal(got, ref_cols):
            raise AssertionError("%s: %d valid fragments != the single-device "
                                 "path's %d (or their rows differ)"
                                 % (what, got.shape[1], ref_cols.shape[1]))

    # 1. replicated tables, mesh (2, 2), exact per-shard host caps
    t0 = time.perf_counter()
    sim = tables._HostSim(aln, do_dupes=True)
    caps1 = per_shard_caps(aln, src, tgt, path, lo, hi, SHARDS // 2, sim)
    caps4 = per_shard_caps(aln, src, tgt, path, lo, hi, SHARDS, sim)
    log("  host caps per shard: %.1fs; mesh (2, 2) %s, D = %d %s"
        % (time.perf_counter() - t0, caps1, SHARDS, caps4))
    grid = ps.make_mesh(SHARDS // 2, 2, device=dev, group=group)
    args1 = ps.shard_batch(grid, lo, hi, owner)
    step1 = ps.make_sharded_step(path, caps1, tgt_len, SHARDED_BINS, grid)
    (F1, cov1), c = first_call("replicated", lambda: step1(*args1))
    same_fragments(F1, "replicated step")
    cov1 = cov1.cpu().numpy()
    if not np.array_equal(cov1, host_histogram(F1, tgt_len, SHARDED_BINS)):
        raise AssertionError("replicated step histogram != int64 host "
                             "histogram of its fragments")
    log("  replicated step (mesh (2, 2)): %d fragments equal the "
        "single-device path's; %d-bin histogram (sum %d) equal to an int64 "
        "histogram of them" % (ref_cols.shape[1], SHARDED_BINS, cov1.sum()))
    timings["replicated"] = time_step("replicated step",
                                      lambda: step1(*args1), c)
    del F1

    # 2. table-sharded, D = SHARDS
    mesh = ps.make_mesh(SHARDS, 1, device=dev, group=group)
    args = ps.shard_batch(mesh, lo, hi, owner)
    path_sh = ps.shard_path_tables(path, mesh)
    step2 = ps.make_table_sharded_step(path_sh, caps4, mesh)
    (F2, ovf2), c = first_call("table-sharded", lambda: step2(*args))
    if bool(ovf2.any().item()):
        raise AssertionError("table-sharded step overflow on exact caps")
    same_fragments(F2, "table-sharded step")
    if not np.array_equal(host_histogram(F2, tgt_len, SHARDED_BINS), cov1):
        raise AssertionError("table-sharded histogram != the replicated "
                             "step's")
    log("  table-sharded step (D = %d, tables at rest %s per shard): "
        "fragments and histogram equal" % (SHARDS, [tuple(lv.grid.shape)
                                                    for lv in path_sh.levels]))
    timings["table"] = time_step("table-sharded step", lambda: step2(*args), c)
    del F2

    # 3. ring-sharded, D = SHARDS: caps from the host totals with slack,
    # doubled on overflow (generous caps + retry, as the original).  A
    # near-collinear alignment routes most of a shard's fragments to one
    # shard, so a send bucket gets a shard's whole share, not 1/D of it.
    rls = pr.build_ring_path(path, SHARDS)
    fin = [n] + [sv + rv for sv, rv in bench["totals"]]

    def ring_caps(mult):
        return tuple(tuple(tables._bucket_cap(mult * x) for x in (
            fin[i] // SHARDS + 4096, fin[i] // SHARDS + 4096,
            sv // SHARDS + 4096, (rv // SHARDS + 4096) if rv else 0))
            for i, (sv, rv) in enumerate(bench["totals"]))

    mult = 1.5
    while True:
        caps3 = ring_caps(mult)
        step3 = pr.make_ring_sharded_step(rls, caps3, mesh)
        (F3, ovf3), c = first_call("ring-sharded", lambda: step3(*args))
        if not bool(ovf3.any().item()):
            break
        log("  ring caps %s overflowed: doubling" % (caps3,))
        mult *= 2
        if mult > 48:
            raise AssertionError("ring-sharded step: capacity blowup")
    bases = [torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, F[5].long().clamp(0, n - 1),
        torch.where(F[6] > 0, F[1] - F[0], 0).to(torch.int64))
        for F in (F_ref, F3)]
    if not torch.equal(bases[0], bases[1]):
        raise AssertionError("ring-sharded step: mapped bases per owner "
                             "differ from the single-device path")
    W = min(DEPTH_WINDOW, tgt_len)
    cov_ref = window_coverage(F_ref, W)
    if not torch.equal(window_coverage(F3, W), cov_ref):
        raise AssertionError("ring-sharded step: target coverage over "
                             "[0, %d) differs" % W)
    M = F3[:, F3[6] > 0].cpu().numpy().astype(np.int64)
    sample = bench["sample"]
    M = M[:, np.isin(M[5], sample)]
    got = owner_pairs(M[0], M[1], M[2], M[3], M[4], M[5])
    runs = np.array([(o,) + r for o in sample for r in bench["want"][int(o)]],
                    np.int64)
    want = owner_pairs(runs[:, 1], runs[:, 2], runs[:, 3], runs[:, 4],
                       runs[:, 5], runs[:, 0])
    if not np.array_equal(got, want):
        raise AssertionError("ring-sharded step: sampled owners' base pairs "
                             "differ from the host mapper")
    log("  ring-sharded step (D = %d, caps %s): %d valid fragments; bases "
        "per owner and coverage of [0, %d) equal the single-device path's; "
        "%d sampled owners' %d base pairs equal the host mapper's"
        % (SHARDS, caps3, int((F3[6] > 0).sum().item()), W, len(sample),
           len(want)))
    timings["ring"] = time_step("ring-sharded step", lambda: step3(*args), c)
    del F3, bases, M

    # 4. distributed_coverage over the first 2^27 target columns
    cov, c = first_call("distributed_coverage",
                        lambda: dist.distributed_coverage(path, caps4, W, mesh,
                                                          *args))
    if not np.array_equal(cov, cov_ref.cpu().numpy()):
        raise AssertionError("distributed_coverage != the single-device "
                             "path's coverage of [0, %d)" % W)
    log("  distributed_coverage of [0, %d): equal to the single-device "
        "path's (%d covered columns)" % (W, int((cov > 0).sum())))
    timings["coverage"] = time_step(
        "distributed_coverage",
        lambda: dist.distributed_coverage(path, caps4, W, mesh, *args), c)
    del cov, cov_ref

    # 5. merge_sorted_blocks of the lo values
    t0 = time.perf_counter()
    merged = dist.merge_sorted_blocks(np.sort(lo), device=dev, group=group)
    if not np.array_equal(merged, np.sort(lo)):
        raise AssertionError("merge_sorted_blocks != np.sort")
    log("  merge_sorted_blocks of %d lo values equal np.sort (%.2fs)"
        % (n, time.perf_counter() - t0))
    del F_ref, ref_cols, path_sh
    torch.cuda.empty_cache()
    log("phase 5b passed in %.1fs; launches over the steps' first calls %s"
        % (time.perf_counter() - t_phase, launched))
    return launched, timings


def build_maf_alignment(n_segments: int, seed: int = 11):
    """bench.py's MAF fixture (bench_hal2maf): 10 genomes of n_segments
    segments of 128-129 bp, with DNA."""
    from hal_tpu_torch.randgen import create_random_alignment

    return create_random_alignment(
        seed=seed, max_genomes=N_GENOMES, min_genomes=N_GENOMES - 1,
        mean_degree=1.5, max_branch_length=0.2, min_segment_length=128,
        max_segment_length=129, min_segments=n_segments,
        max_segments=n_segments + 100, fast_dna=True)


def sharded_column_window(dev, group, aln, ref, eng, want: bytes, W: int):
    """The sharded column step at SHARDS local shards over [0, W): the
    native assembler's bytes from collect_sharded must equal `want`.
    Returns the kernels' launches on its first call and its times."""
    import torch

    from hal_tpu_torch.ops import column_torch as ct
    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.ops.column_native import NativeMafExporter
    from hal_tpu_torch.parallel.sharded import make_mesh

    t0 = time.perf_counter()
    edges = np.linspace(0, W, SHARDS + 1).astype(np.int64)
    caps_all, oc_all = ct.size_sharded_caps(eng, edges)
    t_size = time.perf_counter() - t0
    mesh = make_mesh(SHARDS, 1, device=dev, group=group)
    step = ct.make_sharded_column_step(eng, caps_all, oc_all, mesh)
    lo, hi = (torch.from_numpy(e.copy()).to(dev) for e in (edges[:-1],
                                                         edges[1:]))
    K.reset_launches()
    outs = step(lo, hi)
    torch.cuda.synchronize()
    counts = K.launches()
    check_launched(counts, "sharded (column step)")
    ex = NativeMafExporter(aln, ref)
    got = ex.export_frags(0, W, ct.collect_sharded(eng, outs, edges)) + \
        ex.finish()
    ex.close()
    if got != want:
        raise AssertionError("sharded column step MAF != native DFS MAF on "
                             "[0, %d) (%d vs %d bytes)"
                             % (W, len(got), len(want)))
    log("  sharded column step (D = %d local shards, edges %s): MAF bytes "
        "equal to the native DFS engine's; per-shard host sizing %.2fs"
        % (SHARDS, edges.tolist(), t_size))
    return counts, time_step("sharded column step", lambda: step(lo, hi),
                             counts)


def phase_maf(dev, tmp, group, runs) -> tuple:
    """The device column engine at bench scale through the native
    assembler (and the sharded column step on the first window), then the
    hal2maf CLI (recorded in runs).  Returns the kernels' launches on the
    first MAF window, the sharded column step's launches and times, and
    (the MAF fixture, its reference, the CLI's halz, its reference) for
    phase 7."""
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
    sharded = sharded_column_window(dev, group, aln, ref, eng, want, W)

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
    del eng
    torch.cuda.empty_cache()

    from hal_tpu_torch.storage import save_alignment
    from hal_tpu_torch.tools import hal2maf

    small = build_maf_alignment(1 << 14, seed=12)
    hal = os.path.join(tmp, "maf.halz")
    save_alignment(small, hal, fmt="halz")
    ref2 = [n for n in small.genome_names() if small.tree.is_leaf(n)][0]

    def maf_argv(h, out):
        return [h, out, "--refGenome", ref2]

    out = os.path.join(tmp, "cuda.maf")
    n, t_cuda, t_cpu, c = cli_bytes_equal(
        hal2maf.run, lambda o: maf_argv(hal, o), out,
        os.path.join(tmp, "cpu.maf"), "hal2maf")
    runs["hal2maf"] = dict(run=hal2maf.run, argv=maf_argv, hal=hal, out=out,
                           seconds=t_cuda)
    log("  hal2maf --refGenome %s (%.1f Mb, %d genomes): %d bytes, --device "
        "cuda %.1fs equal to --device cpu %.1fs; launches %s"
        % (ref2, small.open_genome(ref2).length / 1e6, small.num_genomes, n,
           t_cuda, t_cpu, c))
    log("phase 6 passed in %.1fs" % (time.perf_counter() - t_phase))
    return launches, sharded, (aln, ref, hal, ref2)


def serve_directory(directory: str, conn, counts) -> None:
    """The remote phase's HTTP server, run in a process of its own (a
    thread of this process would contend with the client for the GIL):
    GET with byte ranges, answered 206 with Content-Range as hub servers
    do (http.server's SimpleHTTPRequestHandler ignores Range, and
    BlockFile would take whole bodies), each answer counted in counts
    (shared int64s: requests, body bytes)."""
    import http.server
    import urllib.parse

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            rel = urllib.parse.unquote(urllib.parse.urlsplit(self.path).path)
            parts = [p for p in rel.split("/") if p not in ("", ".", "..")]
            try:
                f = open(os.path.join(directory, *parts), "rb")
            except OSError:
                self.send_error(404)
                return
            with f:
                size = os.fstat(f.fileno()).st_size
                rng = self.headers.get("Range", "")
                if rng.startswith("bytes="):
                    a, b = rng[6:].split("-")
                    a = int(a)
                    b = min(int(b), size - 1) if b else size - 1
                    f.seek(a)
                    body = f.read(max(b - a + 1, 0))
                    self.send_response(206)
                    self.send_header("Content-Range",
                                     "bytes %d-%d/%d" % (a, b, size))
                else:
                    body = f.read()
                    self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            with counts.get_lock():
                counts[0] += 1
                counts[1] += len(body)

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    conn.send(srv.server_address[1])
    conn.close()
    srv.serve_forever()


@contextlib.contextmanager
def served(directory: str):
    """directory served over HTTP by serve_directory in a spawned process
    on 127.0.0.1; yields (base URL, counts).  The process is stopped on
    exit."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    counts = ctx.Array("q", 2)
    reader, writer = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=serve_directory, args=(directory, writer, counts),
                       daemon=True)
    proc.start()
    try:
        if not reader.poll(120):
            raise AssertionError("the HTTP server did not start")
        yield "http://127.0.0.1:%d" % reader.recv(), counts
    finally:
        proc.terminate()
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()
        reader.close()


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _s, files in os.walk(path) for f in files)


def remote_laziness(base: str, cli) -> str:
    """One 25 bp interval mapped by the host map_source over the URL of
    the CLI alignment equals the local map and fetches under 5% of the
    remote arrays' bytes (tests/test_remote.py's block-granular check)."""
    from hal_tpu_torch.ops import segmap_host
    from hal_tpu_torch.storage import open_alignment
    from hal_tpu_torch.storage.remote import RemoteArray

    hal, src, tgt, _bed = cli
    RemoteArray._bf_cache.clear()
    remote = open_alignment(base + "/" + os.path.basename(hal))
    g = remote.open_genome(src)
    lo = np.array([g.length // 3], np.int64)
    hi = lo + 25
    got = segmap_host.map_source(remote, src, lo, hi, tgt, do_dupes=True)
    want = segmap_host.map_source(open_alignment(hal), src, lo, hi, tgt,
                                  do_dupes=True)
    for f in ("src_lo", "src_hi", "tgt_lo", "tgt_hi", "rev"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError("remote map_source differs from the local "
                                 "map in %s" % f)
    ras = remote.remote_arrays
    total = sum(ra.nbytes for (_n, _a, ra) in ras)
    bfs = {id(ra.bf): ra.bf for (_n, _a, ra) in ras}.values()
    fetched = sum(bf.bytes_fetched for bf in bfs)
    if not ras or fetched >= total / 20:
        raise AssertionError("one interval over the URL fetched %d of %d "
                             "remote array bytes" % (fetched, total))
    return ("one %d bp interval %s -> %s (%d fragments) by the host "
            "map_source over the URL: %d of %d remote array bytes fetched "
            "(%.2f%%) in %d requests, over %d arrays"
            % (int(hi[0] - lo[0]), src, tgt, len(got.tgt_lo), fetched, total,
               100.0 * fetched / total, sum(bf.requests for bf in bfs),
               len(ras)))


def bench_overlap(args) -> None:
    """python -m hal_tpu_torch.tools.benchOverlap --device cuda in a
    subprocess: it must exit 0, check every schedule's first wire and
    print its JSON line last."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "hal_tpu_torch.tools.benchOverlap", "--device",
                        "cuda"] + args, cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError("benchOverlap %s exited %d: %s"
                             % (args, r.returncode, r.stderr[-3000:]))
    if "wires checked" not in r.stderr:
        raise AssertionError("benchOverlap %s did not check its wires" % args)
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    log("  benchOverlap %s (%.1fs):" % (" ".join(args) or "(defaults)",
                                        time.perf_counter() - t0))
    for line in r.stderr.strip().splitlines():
        log("    " + line)
    log("    " + json.dumps(rec))


def phase_remote(tmp, cli, runs) -> dict:
    """The CLIs of phases 4-6 on --device cuda over HTTP: tmp served by a
    process of this script's own, HAL_TPU_UDC_DIR under tmp, each CLI's
    block cache fresh (as in a new process) and its output byte-equal to
    the local run's; the laziness check; then benchOverlap twice.  Returns
    the kernels' launches over the three CLIs."""
    import torch

    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.storage.remote import RemoteArray

    t_phase = time.perf_counter()
    old_udc = os.environ.get("HAL_TPU_UDC_DIR")
    os.environ["HAL_TPU_UDC_DIR"] = os.path.join(tmp, "udc")
    try:
        with served(tmp) as (base, served_counts):
            log("phase 6b remote: %s served by a separate process "
                "(HTTP Range)" % base)
            K.reset_launches()
            for tool, rec in runs.items():
                hal = rec["hal"]
                url = base + "/" + os.path.basename(hal)
                out = os.path.join(tmp, "remote_" + os.path.basename(
                    rec["out"]))
                RemoteArray._bf_cache.clear()
                n0, b0 = served_counts[:]
                t0 = time.perf_counter()
                rec["run"](rec["argv"](url, out) + ["--device", "cuda"])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                n1, b1 = served_counts[:]
                a = open(out, "rb").read()
                b = open(rec["out"], "rb").read()
                if not a or a != b:
                    raise AssertionError(
                        "%s --device cuda on %s differs from the local run "
                        "(%d vs %d bytes)" % (tool, url, len(a), len(b)))
                size = dir_bytes(hal)
                log("  %s --device cuda on %s: %d bytes, byte-equal to the "
                    "local run; %.1fs on the URL against %.1fs local; %d HTTP "
                    "requests, %d bytes fetched of the halz's %d (%.1f%%)"
                    % (tool, url, len(a), dt, rec["seconds"], n1 - n0,
                       b1 - b0, size, 100.0 * (b1 - b0) / size))
            counts = K.launches()
            check_launched(counts, "remote")
            log("  launches over the three CLIs %s" % counts)
            log("  " + remote_laziness(base, cli))
    finally:
        RemoteArray._bf_cache.clear()
        if old_udc is None:
            os.environ.pop("HAL_TPU_UDC_DIR", None)
        else:
            os.environ["HAL_TPU_UDC_DIR"] = old_udc
    bench_overlap([])
    bench_overlap(["--mb", "6.8", "--matmul", "2048", "--chains", "8"])
    log("phase 6b passed in %.1fs" % (time.perf_counter() - t_phase))
    return counts


def seeded_model(n_leaves: int, seed: int):
    """A seeded binary tree of n_leaves leaves (random joins of two
    subtrees, branch lengths ~ Exp(0.05) + 0.005) under a seeded GTR rate
    matrix, as the port's NeutralModel."""
    from hal_tpu_torch.tree import Tree

    rng = np.random.default_rng(seed)
    nodes = ["S%03d:%.4f" % (k, 0.005 + rng.exponential(0.05))
             for k in range(n_leaves)]
    k = 0
    while len(nodes) > 1:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        b, a = nodes.pop(j), nodes.pop(i)
        bl = "" if len(nodes) == 0 else ":%.4f" % (0.005 + rng.exponential(0.05))
        nodes.append("(%s,%s)N%03d%s" % (a, b, k, bl))
        k += 1
    tree = Tree.from_newick(nodes[0] + ";")
    return gtr_model(tree, rng)


def gtr_model(tree, rng):
    """The port's NeutralModel of a seeded GTR matrix (Dirichlet(8)
    background, exchangeabilities U(0.5, 3), one expected substitution per
    unit time) on tree."""
    from hal_tpu_torch.phylop import NeutralModel

    bg = rng.dirichlet(np.full(4, 8.0))
    S = np.zeros((4, 4))
    S[np.triu_indices(4, 1)] = rng.uniform(0.5, 3.0, 6)
    S = S + S.T
    Q = S * bg[None, :]
    np.fill_diagonal(Q, -Q.sum(axis=1))
    Q = Q / -(np.diag(Q) * bg).sum()
    bl = {n: tree.branch_length(n) for n in tree.names()
          if tree.parent(n) is not None}
    mod = NeutralModel(background=bg, rate_matrix=Q, tree=tree,
                       branch_length=bl)
    mod._decompose()
    return mod


def mod_text(mod) -> str:
    rows = "\n".join("  " + " ".join("%.12f" % v for v in r)
                     for r in mod.rate_matrix)
    return ("ALPHABET: A C G T \nORDER: 0\nSUBST_MOD: REV\n"
            "BACKGROUND: %s \nRATE_MAT:\n%s\nTREE: %s\n"
            % (" ".join("%.12f" % b for b in mod.background), rows,
               mod.tree.to_newick()))


def simulate_codes(dev_fit, npat: int, seed: int, device):
    """(nleaf, npat) uint8 codes in the fit's leaf order, simulated down the
    tree on the card: the root state from the background, each branch by
    P(bl * scale) with per-column scales U(0.1, 3); then the last eighth
    replaced by uniform codes (saturated columns) and ~20% of all codes
    set to 4 (missing)."""
    import torch

    mod = dev_fit.model
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    kw = dict(dtype=torch.float64, device=device)
    U = torch.as_tensor(mod._U, **kw)
    Uinv = torch.as_tensor(mod._Uinv, **kw)
    lam = torch.as_tensor(mod._lam, **kw)
    scale = 0.1 + 2.9 * torch.rand(npat, generator=g, **kw)
    cum = torch.cumsum(torch.as_tensor(mod.background, **kw), 0)
    state = {mod.tree.root: torch.searchsorted(
        cum, torch.rand(npat, generator=g, **kw)).clamp(max=3)}
    for name in mod.tree.preorder():
        for c in mod.tree.children(name):
            t = mod.branch_length[c] * scale
            e = torch.exp(t[:, None] * lam[None, :])
            row = (U[state[name]] * e) @ Uinv       # P(t)[parent, :]
            u = torch.rand(npat, 1, generator=g, **kw)
            state[c] = (torch.cumsum(row.clamp(min=0), 1) < u).sum(1).clamp(max=3)
        if mod.tree.children(name):
            del state[name]
    codes = torch.stack([state[n] for n in dev_fit._leaves]).to(torch.uint8)
    sat = npat - npat // 8
    codes[:, sat:] = torch.randint(0, 4, (codes.shape[0], npat - sat),
                                   generator=g, device=device,
                                   dtype=torch.uint8)
    miss = torch.rand(codes.shape, generator=g, device=device) < 0.2
    codes[miss] = 4
    return codes.contiguous()


def phylop_work(prog, subtree: bool) -> tuple:
    """(FP32 operations, special-function results) that one fit needs per
    pattern, an FMA counted as 2, from the program.  Per edge: the
    exponents of the three states that are not the unit state (3: lam * bl
    folded on the host, times the scale; the scale times the subtree scale
    once an evaluation) and their exps (3 SFU; the unit state's exp is
    exactly 1), Uinv @ L of an internal child over those states (12 FMA =
    24; a leaf's is a table entry), their product with the exps (3), L + U
    @ that (12 FMA = 24), the clip (4) and the product into the parent (4,
    not for its first child).  Per node: its max (3) and the four exact
    power-of-two scalings (4; the scale's exponent sum is integer work).
    At the root: the dot with bg (7), the clamp (1), k ln 2 (4) and one log.
    8 per golden iteration.  A fit is 100 evaluations, 900 with a
    subtree."""
    flops = sfu = 0
    for _slot, kids in prog.nodes:
        for k, (leaf, _i, _bl, _in_sub) in enumerate(kids):
            flops += 3 + (0 if leaf else 24) + 3 + 24 + 4 + (4 if k else 0)
            sfu += 3
        flops += 7
    flops += 12 + (1 if subtree else 0)
    sfu += 1
    evals, iters = (900, 450) if subtree else (100, 50)
    return evals * flops + 8 * iters, evals * sfu


def jax_work(prog, subtree: bool) -> tuple:
    """(FP32 operations, special-function results) of one fit per pattern
    as the JAX program does it (phylop_jax._lnl), the count of PR 5's bound,
    kept so that shares compare with it: per edge the branch time (1, or 2
    on a subtree branch), lam * t (4), the exps (4 SFU), their product (4),
    Uinv @ L for an internal child (16 FMA = 32), U @ w (32), the clip (4)
    and the product into the parent (4, not for its first child); per node
    its max (3), guard (1), the four divisions (4) and the log-scale sum
    (1), its log on the SFU; the root's dot (7), clamp (1) and sum (1) and
    log; 8 per golden iteration."""
    flops = sfu = 0
    for _slot, kids in prog.nodes:
        for k, (leaf, _i, _bl, in_sub) in enumerate(kids):
            flops += (2 if in_sub else 1) + 4 + 4 + (0 if leaf else 32) \
                + 32 + 4 + (4 if k else 0)
            sfu += 4
        flops += 9
        sfu += 1
    flops += 9
    sfu += 1
    evals, iters = (900, 450) if subtree else (100, 50)
    return evals * flops + 8 * iters, evals * sfu


def scores_agree(got, want, mode, what, max_share: float = 0.0) -> float:
    """The float32 tolerance of tests/test_phylop_jax.py: off the CON/ACC
    point mass (both |score| <= 0.32) |d| < 2e-2, and a CONACC sign flips
    only where |score| < 0.05.  max_share is the share of patterns allowed
    outside it: 0, except for the subtree fit, whose float32 result depends
    on rounding (SUBTREE_F32_SHARE).  Returns the largest |d| of the
    patterns inside it, off the point mass."""
    d = np.abs(got - want)
    point = np.zeros(len(d), bool)
    if mode in ("CON", "ACC"):
        point = (np.abs(want) <= 0.32) & (np.abs(got) <= 0.32)
    flip = (np.sign(got) != np.sign(want)) & ~point
    bad = np.where(flip, np.abs(want) >= 0.05, d >= 2e-2) & ~point
    share = float(bad.mean()) if len(d) else 0.0
    worst = float(d[~point & ~flip & ~bad].max(initial=0.0))
    msg = ("%s: %d scores, max |d| %.2e off the CON/ACC point mass (%d "
           "there), %d CONACC sign flips; %d (%.3f%%) outside the float32 "
           "tolerance (%.1f%% allowed; largest |d| %.3g, flips up to "
           "|score| %.3g)"
           % (what, len(d), worst, int(point.sum()), int(flip.sum()),
              int(bad.sum()), 100 * share, 100 * max_share,
              float(d[bad].max(initial=0.0)),
              float(np.abs(want[flip]).max(initial=0.0))))
    if share > max_share:
        raise AssertionError(msg)
    log("  " + msg)
    return worst


def event_s(fn) -> tuple:
    """(seconds on the device timeline between CUDA events around fn,
    fn's result)."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / 1e3, out


def fit_bound(codes, prog, subtree: bool) -> tuple:
    """(bound s, how it is set, the same bound of JAX's count) of one
    phylop_fit call on codes: the larger of the FP32 operations the fit
    needs over 67 T/s, its special-function results over the SFU rate
    (phylop_work) and the call's bytes over the HBM rate.  The third is
    that bound with the JAX program's work (jax_work), PR 5's bound."""
    npat = codes.shape[1]
    nbytes = codes.numel() + 12 * npat + prog.edges.numel() * 4

    def parts(work):
        flops, sfu = work(prog, subtree)
        return {"bytes": nbytes / HBM_BYTES_PER_S,
                "FP32 operations": npat * flops / ALU32_OPS_PER_S,
                "SFU operations": npat * sfu / SFU_OPS_PER_S}

    need, jax = parts(phylop_work), parts(jax_work)
    by = max(need, key=need.get)
    return need[by], ("%s (FP32 %.4f ms, SFU %.4f ms, bytes %.4f ms; JAX's "
                      "count: FP32 %.4f ms, SFU %.4f ms)"
                      % (by, 1e3 * need["FP32 operations"],
                         1e3 * need["SFU operations"], 1e3 * need["bytes"],
                         1e3 * jax["FP32 operations"],
                         1e3 * jax["SFU operations"])), max(jax.values())


def lnl_checks(pf, codes, s, ss, prog, prog64, what: str,
               baseline=None) -> tuple:
    """phylop_lnl on the card against lnl_plain in float64 (relative 1e-5,
    the float32 plain version's own error printed beside it: it rounds
    JAX's U (e * Uinv @ L) form, which loses ~1e-7 / t of a short branch's
    small entries).  baseline: a function giving an earlier kernel's lnl at
    the same inputs, whose float64 error the kernel's must not exceed.
    Returns (max abs err, max rel err) of the kernel against float64 and
    the baseline's max abs err (None without one)."""
    import torch

    got = pf.phylop_lnl(codes, s, ss, prog)
    want = pf.lnl_plain(codes, s.double(), ss.double(), prog64)
    b_abs = None
    if baseline is not None:
        b_abs = float((baseline().double() - want).abs().max())
    plain = pf.lnl_plain(codes, s, ss, prog).double()
    scale = want.abs().clamp(min=1)
    k_abs = float((got.double() - want).abs().max())
    k_rel = float(((got.double() - want).abs() / scale).max())
    if not (bool(torch.isfinite(got).all()) and k_rel <= 1e-5):
        raise AssertionError("%s: phylop_lnl vs float64 lnl_plain: max rel "
                             "err %.3g" % (what, k_rel))
    if b_abs is not None and not k_abs <= b_abs:
        raise AssertionError("%s: phylop_lnl's float64 error %.3g exceeds "
                             "the baseline's %.3g" % (what, k_abs, b_abs))
    log("  %s: phylop_lnl vs float64 lnl_plain (%d patterns): max abs err "
        "%.3g, max rel err %.3g; float32 lnl_plain vs float64: %.3g, %.3g; "
        "kernel vs float32 lnl_plain: max rel %.3g (lnl %.1f .. %.1f)%s"
        % (what, codes.shape[1], k_abs, k_rel,
           float((plain - want).abs().max()),
           float(((plain - want).abs() / scale).max()),
           float(((got.double() - plain).abs() / plain.abs().clamp(min=1)).max()),
           float(want.min()), float(want.max()),
           "; baseline max abs err %.3g" % b_abs if b_abs is not None else ""))
    return k_abs, k_rel, b_abs


def shapes_identical(pf, codes, prog, mode, subtree, what: str) -> None:
    """phylop_fit's two launch shapes (one thread a pattern, two lanes a
    pattern) give the same bits, and a repeated call too."""
    import torch

    one = pf._fit_kernel(codes, prog, mode, subtree, False)
    two = pf._fit_kernel(codes, prog, mode, subtree, True)
    again = pf._fit_kernel(codes, prog, mode, subtree, False)
    if not all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(one, two, again)):
        raise AssertionError("%s: phylop_fit's launch shapes or repeated "
                             "calls differ" % what)
    log("  %s: both launch shapes and a repeated call bit-identical (%d "
        "patterns)" % (what, codes.shape[1]))


def phylop_kernel_checks(dev) -> dict:
    """phylop_fit and phylop_lnl against the plain version on the card: the
    241-leaf CONACC fit at 2^20 patterns timed, its scores on a 2^14
    subsample and the float64 numpy fit on 1,024; the other modes and the
    subtree fit on a 16-leaf tree, each timed with its bound.  Returns
    phylop_fit's record."""
    import torch

    from hal_tpu_torch.ops import phylop_fit as pf
    from hal_tpu_torch.phylop import score_patterns
    from hal_tpu_torch.phylop_torch import DevicePhyloP

    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    mod = seeded_model(PHYLOP_LEAVES, 71)
    leaves = [n for n in mod.tree.postorder() if mod.tree.is_leaf(n)]
    li = {n: i for i, n in enumerate(leaves)}
    fit = DevicePhyloP(mod, li, "CONACC", device=dev)
    prog = fit.program()
    prog64 = DevicePhyloP(mod, li, "CONACC", dtype=torch.float64,
                          device=dev).program()
    n = PHYLOP_PATTERNS
    codes = simulate_codes(fit, n, 72, dev)
    log("phase 7 phyloP kernel: %d-leaf seeded tree (%d edges, %d slots), "
        "%d simulated patterns (%d unique of the first 2^16)"
        % (len(leaves), prog.edges.shape[0], prog.n_slots, n,
           len(np.unique(codes[:, :1 << 16].t().cpu().numpy(), axis=0))))

    # the likelihood function itself, at seeded scales
    rng = np.random.default_rng(73)
    s = torch.from_numpy(rng.uniform(0.1, 3.0, n)).float().to(dev)
    ss = torch.from_numpy(rng.uniform(0.5, 2.0, n)).float().to(dev)
    lnl_abs, lnl_rel, _ = lnl_checks(pf, codes, s, ss, prog, prog64,
                                     "%d leaves" % len(leaves))
    del prog64
    shapes_identical(pf, codes[:, :PHYLOP_SMALL_PATTERNS].contiguous(), prog,
                     "CONACC", False, "%d leaves" % len(leaves))

    # the fit: kernel, plain (once), kernel, kernel
    k_s = []
    t, fk = event_s(lambda: pf.phylop_fit(codes, prog, "CONACC"))
    k_s.append(t)
    t_plain, fp = event_s(lambda: pf.fit_plain(codes, prog, "CONACC", False))
    for _ in range(2):
        t, out = event_s(lambda: pf.phylop_fit(codes, prog, "CONACC"))
        k_s.append(t)
        if not all(torch.equal(a, b) for a, b in zip(out, fk)):
            raise AssertionError("phylop_fit is not deterministic")
    bound, how, jax_bound = fit_bound(codes, prog, False)
    ms = 1e3 * float(np.median(k_s))
    log("  time phylop_fit (%d leaves x %d patterns, CONACC): kernel %s ms "
        "(median %.1f), plain %.1f ms once; bound %.1f ms by %s, kernel at "
        "%.1f%% of it; at %.1f%% of JAX's count's %.1f ms (PR 5's bound)"
        % (len(leaves), n, [round(1e3 * x, 1) for x in k_s], ms,
           1e3 * t_plain, 1e3 * bound, how, 100 * 1e3 * bound / ms,
           100 * 1e3 * jax_bound / ms, 1e3 * jax_bound))

    # scores of a subsample of both fits, and of the float64 numpy fit
    sub = np.sort(np.random.default_rng(74).choice(n, PHYLOP_SCORED,
                                                   replace=False))
    pats = codes[:, torch.from_numpy(sub).to(dev)].t().cpu().numpy().astype(np.int64)
    t0 = time.perf_counter()
    sk = fit.scores_at(pats, *(x[sub].cpu().double().numpy() for x in fk))
    sp = fit.scores_at(pats, *(x[sub].cpu().double().numpy() for x in fp))
    t_host = time.perf_counter() - t0
    worst = scores_agree(sk, sp, "CONACC",
                         "kernel vs plain fit, %d leaves" % len(leaves))
    t0 = time.perf_counter()
    m = PHYLOP_EXACT
    exact = score_patterns(mod, li, pats[:m], "CONACC")
    t_exact = time.perf_counter() - t0
    scores_agree(sk[:m], exact, "CONACC", "kernel vs float64 numpy fit")
    scores_agree(sp[:m], exact, "CONACC", "plain vs float64 numpy fit")
    log("  host float64 re-evaluation: %.2fs for 2 x %d patterns; float64 "
        "numpy fit of %d patterns %.1fs; scores %.2f .. %.2f"
        % (t_host, PHYLOP_SCORED, m, t_exact, sk.min(), sk.max()))

    # every mode and the subtree fit on a 16-leaf tree
    small = seeded_model(PHYLOP_SMALL_LEAVES, 75)
    sl = [x for x in small.tree.postorder() if small.tree.is_leaf(x)]
    sli = {x: i for i, x in enumerate(sl)}
    inner = [x for x in small.tree.postorder() if not small.tree.is_leaf(x)]
    subtree = frozenset(small.tree.preorder(inner[len(inner) // 2]))
    for mode, subn in (("CON", None), ("ACC", None), ("NNEUT", None),
                       ("CONACC", subtree), ("CON", subtree)):
        f16 = DevicePhyloP(small, sli, mode, subn, device=dev)
        p16 = f16.program()
        c16 = simulate_codes(f16, PHYLOP_SMALL_PATTERNS, 76, dev)
        what = "16 leaves, %s%s" % (mode, " subtree" if subn else "")
        if subn:
            n16 = c16.shape[1]
            lnl_checks(pf, c16, s[:n16].contiguous(), ss[:n16].contiguous(),
                       p16, DevicePhyloP(small, sli, mode, subn,
                                         dtype=torch.float64,
                                         device=dev).program(), what)
        shapes_identical(pf, c16, p16, mode, bool(subn), what)
        tk, k16 = event_s(lambda: pf.phylop_fit(c16, p16, mode, bool(subn)))
        tk2, _ = event_s(lambda: pf.phylop_fit(c16, p16, mode, bool(subn)))
        tp, q16 = event_s(lambda: pf.fit_plain(c16, p16, mode, bool(subn)))
        b16, how16, _ = fit_bound(c16, p16, bool(subn))
        p16n = c16.t().cpu().numpy().astype(np.int64)
        a = f16.scores_at(p16n, *(x.cpu().double().numpy() for x in k16))
        b = f16.scores_at(p16n, *(x.cpu().double().numpy() for x in q16))
        scores_agree(a, b, mode, "%s, kernel %.3f / %.3f ms vs plain %.1f ms; "
                     "bound %.4f ms by %s, kernel at %.1f%% of it"
                     % (what, 1e3 * tk, 1e3 * tk2, 1e3 * tp, 1e3 * b16, how16,
                        100 * b16 / min(tk, tk2)),
                     SUBTREE_F32_SHARE if subn else 0.0)
    return {"name": "phylop_fit", "route": "cuda",
            "source": SOURCES["phylop_fit"], "replaces": REPLACES["phylop_fit"],
            "max_abs_err": lnl_abs, "max_abs_err_of": "phylop_lnl vs "
            "lnl_plain in float64, the fit's likelihood function, %d patterns"
            % n, "lnl_max_rel_err": lnl_rel, "score_max_abs_diff": worst,
            "ms": ms, "plain_ms": 1e3 * t_plain, "bound_ms": 1e3 * bound,
            "bound_by": "operations", "library_ms": None,
            "jax_count_bound_ms": 1e3 * jax_bound,
            "shape": "%d leaves x %d patterns, CONACC" % (len(leaves), n)}


def time_path_fit(dev, scorer, npat: int) -> None:
    """phylop_fit at the phyloP path's shape: the scorer's own model (its
    species' tree) and one window's count of new patterns, simulated."""
    from hal_tpu_torch.ops import phylop_fit as pf

    prog = scorer._dev.program()
    codes = simulate_codes(scorer._dev, npat, 84, dev)
    shapes_identical(pf, codes, prog, scorer._dev.mode, False,
                     "phyloP path's fit")
    ts = [event_s(lambda: pf.phylop_fit(codes, prog, scorer._dev.mode))[0]
          for _ in range(3)]
    tp, _ = event_s(lambda: pf.fit_plain(codes, prog, scorer._dev.mode,
                                         False))
    bound, how, _ = fit_bound(codes, prog, False)
    log("  time phylop_fit at the phyloP path's shape (%d leaves x %d "
        "patterns, %s): kernel %s ms, plain %.1f ms; bound %.4f ms by %s, "
        "kernel at %.1f%% of it"
        % (prog.n_leaves, npat, scorer._dev.mode,
           [round(1e3 * t, 3) for t in ts], 1e3 * tp, 1e3 * bound, how,
           100 * bound / min(ts)))


def wig_scores_agree(va, vb, what: str) -> float:
    """phyloP wiggle values of the card (va) and of --device cpu (vb),
    printed at --prec 3, within the float32 tolerance plus one rounding
    step: |d| < 2e-2 + 1e-3, signs flipping only where the cpu score is
    under 0.05.  Returns the largest |d|."""
    d = np.abs(va - vb)
    flip = np.sign(va) != np.sign(vb)
    if (d[~flip] >= 2e-2 + 1e-3).any() or np.abs(vb[flip]).max(initial=0) >= 0.05:
        raise AssertionError("%s scores disagree (max |d| %.3g)"
                             % (what, d.max()))
    return float(d.max(initial=0))


def phase_phylop(dev, maf, tmp) -> tuple:
    """The phyloP path: the kernel checks, then PhyloPScorer on the card
    over two 2^20-column windows of the MAF fixture against the same scorer
    on the CPU, then the halPhyloP CLI.  Returns (phylop_fit's record, the
    kernels' launches on the scorer's two windows)."""
    import torch

    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.phylop import NeutralModel, PhyloPScorer

    t_phase = time.perf_counter()
    rec = phylop_kernel_checks(dev)
    log("  kernel checks in %.1fs" % (time.perf_counter() - t_phase))

    aln, ref, small_hal, small_ref = maf
    mod_path = os.path.join(tmp, "maf.mod")
    with open(mod_path, "w") as f:
        f.write(mod_text(gtr_model(aln.tree.copy(), np.random.default_rng(81))))
    W = PHYLOP_WINDOW
    K.reset_launches()
    t0 = time.perf_counter()
    scorer = PhyloPScorer(aln, NeutralModel.from_mod_file(mod_path),
                          device="cuda")
    # set-up: the fit module and the reference's column engine
    scorer._score_batch(np.zeros((0, len(scorer.species)), np.int64))
    scorer._window_slices(ref, 0, 0, set(scorer.species) | {ref})
    t_setup = time.perf_counter() - t0
    spent = {}

    def timed(obj, name, key, force=False):
        fn = getattr(obj, name)

        def wrapper(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            if force:  # a generator: do its work here
                out = list(out)
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
            return out

        setattr(obj, name, wrapper)

    timed(scorer, "_window_slices", "columns", force=True)
    timed(scorer._col_eng[ref], "window_frags", "engine")
    timed(scorer, "_score_batch", "scoring")
    timed(scorer._dev, "fit", "fit")
    patterns = []
    score_batch = scorer._score_batch
    scorer._score_batch = lambda p: (patterns.append(len(p)), score_batch(p))[1]
    windows = []
    for gs in (0, W):
        spent.clear()
        t1 = time.perf_counter()
        out = scorer.score_window(ref, gs, gs + W)
        torch.cuda.synchronize()
        windows.append((out, time.perf_counter() - t1, dict(spent)))
    launches = K.launches()
    check_launched(launches, "phyloP", PALLAS_PORTS + ("phylop_fit",))
    time_path_fit(dev, scorer, patterns[0])
    scores = np.concatenate([w for w, _, _ in windows])
    if scores.shape != (2 * W,) or not np.isfinite(scores).all() or \
            np.abs(scores).max() > 20.0 + 1e-9:
        raise AssertionError("phyloP scores: not 2^21 finite values within "
                             "+-20")
    t_win = sum(t for _, t, _ in windows)
    log("  PhyloPScorer(device=cuda), %s, %d species, two %d-column windows: "
        "%.4g columns/s end to end (set-up %.2fs: fit module and column "
        "engine); new unique patterns per window %s; launches %s"
        % (ref, len(scorer.species), W, 2 * W / t_win, t_setup, patterns,
           launches))
    for k, (_, t, spent_k) in enumerate(windows):
        sp = {key: spent_k.get(key, 0.0)
              for key in ("columns", "engine", "scoring", "fit")}
        rest = t - sp["columns"] - sp["scoring"]
        log("    window %d: %.3fs = columns %.3fs (device engine incl. drain "
            "and decode %.3fs, host slices %.3fs) + the fit %.3fs (%.1f%%: "
            "device fit incl. copies %.4fs, float64 host re-evaluation and "
            "p-values %.3fs) + per-base code loop, np.unique and pattern "
            "cache %.3fs (%.0f%%)"
            % (k, t, sp["columns"], sp["engine"], sp["columns"] - sp["engine"],
               sp["scoring"], 100 * sp["scoring"] / t, sp["fit"],
               sp["scoring"] - sp["fit"], rest, 100 * rest / t))
    t0 = time.perf_counter()
    cpu = PhyloPScorer(aln, NeutralModel.from_mod_file(mod_path),
                       device="cpu").score_window(ref, 0, PHYLOP_CPU_COLUMNS)
    scores_agree(scores[:PHYLOP_CPU_COLUMNS], cpu, "CONACC",
                 "scorer cuda vs cpu on [0, %d) (cpu %.1fs)"
                 % (PHYLOP_CPU_COLUMNS, time.perf_counter() - t0))

    # the CLI on the small DNA alignment: cuda against cpu
    from hal_tpu_torch.storage import open_alignment
    from hal_tpu_torch.tools import halPhyloP

    small = open_alignment(small_hal)
    g = small.open_genome(small_ref)
    si = int(np.argmax([g.seq_length(i) for i in range(g.num_sequences)]))
    length = min(PHYLOP_CLI_COLUMNS, g.seq_length(si))
    small_mod = os.path.join(tmp, "small.mod")
    with open(small_mod, "w") as f:
        f.write(mod_text(gtr_model(small.tree.copy(),
                                   np.random.default_rng(82))))
    outs = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(tmp, "phylop_%s.wig" % device)
        K.reset_launches()
        t0 = time.perf_counter()
        halPhyloP.run([small_hal, small_ref, small_mod, out, "--refSequence",
                       g.seq_names[si], "--start", "0", "--length",
                       str(length), "--device", device])
        torch.cuda.synchronize()
        outs[device] = (open(out).read().splitlines(),
                        time.perf_counter() - t0, K.launches())
    check_launched(outs["cuda"][2], "halPhyloP --device cuda",
                   PALLAS_PORTS + ("phylop_fit",))
    if any(outs["cpu"][2].values()):
        raise AssertionError("halPhyloP --device cpu launched a kernel")
    a, b = outs["cuda"][0], outs["cpu"][0]
    heads = [x for x in a if x.startswith("fixedStep")]
    if heads != [x for x in b if x.startswith("fixedStep")] or len(a) != len(b) \
            or len(a) != length + 1:
        raise AssertionError("halPhyloP cuda/cpu: header lines or line counts "
                             "differ")
    va = np.array([float(x) for x in a if not x.startswith("fixedStep")])
    vb = np.array([float(x) for x in b if not x.startswith("fixedStep")])
    d = wig_scores_agree(va, vb, "halPhyloP cuda/cpu")
    log("  halPhyloP %s %s (%d columns): headers byte-equal, scores within "
        "the float32 tolerance of --device cpu (max |d| %.3f, %d lines "
        "differ); cuda %.1fs, cpu %.1fs; launches %s"
        % (small_ref, g.seq_names[si], length, d,
           int((va != vb).sum()), outs["cuda"][1], outs["cpu"][1],
           outs["cuda"][2]))
    log("phase 7 passed in %.1fs" % (time.perf_counter() - t_phase))
    return rec, launches


@contextlib.contextmanager
def port_tools(directory: str):
    """Yields start(tool, args, name): python -m hal_tpu_torch.tools.<tool>
    args as a subprocess of its own session, from the repository, its
    output in directory/<name>.out and .err, each process it starts
    appending to the launch log directory/<name>.jsonl.  start returns a
    callable that waits for the tool and returns (seconds, stdout, the
    launch log's path); a non-zero exit raises.  extra_env adds to the
    tool's environment.  On leaving, every tool
    still running is killed with its process group."""
    from hal_tpu_torch import LAUNCH_LOG_ENV

    procs = []

    def start(tool: str, args, name: str, extra_env=None):
        env = dict(os.environ, PYTHONPATH=REPO, **(extra_env or {}))
        env[LAUNCH_LOG_ENV] = os.path.join(directory, name + ".jsonl")
        out = os.path.join(directory, name + ".out")
        err = os.path.join(directory, name + ".err")
        with open(out, "w") as fo, open(err, "w") as fe:
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "hal_tpu_torch.tools." + tool]
                + [str(a) for a in args], cwd=REPO, env=env, stdout=fo,
                stderr=fe, start_new_session=True)
        procs.append(proc)
        ended = []  # the exit's time, taken by a thread as it happens
        waiter = threading.Thread(target=lambda: ended.append(
            (proc.wait(), time.perf_counter())), daemon=True)
        waiter.start()

        def wait():
            waiter.join()
            rc, t1 = ended[0]
            sec = t1 - t0
            if rc:
                raise AssertionError("%s (%s) exited with %d:\n%s"
                                     % (tool, name, rc, open(err).read()[-4000:]))
            return sec, open(out).read(), env[LAUNCH_LOG_ENV]

        return wait

    try:
        yield start
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()


def launch_log(path: str) -> list:
    """The processes of a HAL_TPU_TORCH_LAUNCH_LOG: (tool, its arguments,
    seconds, start, end, launches or None where it never imported the
    kernels' module), in the order they ended."""
    out = []
    with open(path) as f:
        for line in f:
            x = json.loads(line)
            out.append((os.path.basename(x["argv"][0])[:-3], x["argv"][1:],
                        x["end"] - x["start"], x["start"], x["end"],
                        x["launches"]))
    return out


def log_jobs(jobs: list) -> None:
    """Print every process of a launch log, one line a tool: each process's
    arguments (paths left out), seconds and nonzero launches ("-" where it
    never imported the kernels' module)."""
    by_tool = {}
    for tool, args, sec, _a, _b, counts in jobs:
        shown = " ".join(a for a in args if not a.startswith("/"))
        by_tool.setdefault(tool, []).append(
            "[%s] %.2fs %s" % (shown, sec, "-" if counts is None else
                               {k: v for k, v in counts.items() if v}))
    for tool, runs in by_tool.items():
        log("    job %s: %s" % (tool, "; ".join(runs)))


def card_jobs(jobs: list, tool: str, names, what: str) -> dict:
    """The launches of every `tool` process of a --device cuda run, each of
    which must have launched every kernel of names; returns their sum."""
    total = {}
    found = [j for j in jobs if j[0] == tool]
    if not found:
        raise AssertionError("%s: no %s process in the launch log"
                             % (what, tool))
    for _tool, args, _s, _a, _b, counts in found:
        if counts is None:
            raise AssertionError("%s: %s %s never imported the kernels"
                                 % (what, tool, args))
        check_launched(counts, "%s (%s %s)" % (what, tool, " ".join(args[:2])),
                       names)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def no_launches(jobs: list, what: str) -> None:
    for tool, args, _s, _a, _b, counts in jobs:
        if counts is not None and any(counts.values()):
            raise AssertionError("%s: %s %s launched a kernel: %s"
                                 % (what, tool, args, counts))


def hub_stages(jobs: list) -> str:
    """Stage A (the jobs, in parallel) and stage B (the hub's in-process
    tracks and files after its last job) of one hal2assemblyHub run."""
    hub = [j for j in jobs if j[0] == "hal2assemblyHub"]
    work = [j for j in jobs if j[0] != "hal2assemblyHub"
            and not (j[0] == "halStats" and "--sequences" in j[1])]
    if len(hub) != 1 or not work:
        raise AssertionError("launch log: %d hubs, %d jobs"
                             % (len(hub), len(work)))
    a0, a1 = min(j[3] for j in work), max(j[4] for j in work)
    by_tool = {}
    for j in work:
        by_tool.setdefault(j[0], []).append(j[2])
    return ("hub %.2fs: stage A %.2fs (%d jobs, %s), stage B %.2fs"
            % (hub[0][2], a1 - a0, len(work),
               ", ".join("%s %d x %.2f-%.2fs" % (t, len(v), min(v), max(v))
                         for t, v in sorted(by_tool.items())),
               hub[0][4] - a1))


def trackdb_stanzas(text: str) -> list:
    return [x for x in text.split("\n\n") if x.strip()]


def phase_hub(tmp: str, small_hal: str, small_ref: str, small_mod: str,
              segments: int = HUB_SEGMENTS) -> dict:
    """The assembly-hub path: hal2assemblyHub on --device cuda over every
    leaf of a DNA alignment of `segments` segments a genome, alone; then,
    concurrently, the same hub on --device cpu restricted to one leaf, the
    conservation hub of the 2 Mb CLI alignment with halPhyloP --device cpu
    beside it, and halLodBenchmark --doMaf on each device; then hal2mafMP
    on each device, concurrently.  The jobs run in subprocesses, whose
    seconds and launches come from the port's launch log.  Returns the
    kernels' launches summed over the path's card jobs."""
    import io

    from hal_tpu_torch import assemblyhub as ah
    from hal_tpu_torch.io import bbi
    from hal_tpu_torch.storage import open_alignment, save_alignment

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "hub")
    os.makedirs(d)
    t0 = time.perf_counter()
    aln = build_maf_alignment(segments, seed=HUB_SEED)
    hal = os.path.join(d, "aln.halz")
    save_alignment(aln, hal, fmt="halz")
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    lens = [aln.open_genome(n).length for n in leaves]
    leaf = leaves[0]
    log("phase 8 assembly hub: %d genomes of %d segments (seed %d), %d "
        "leaves of %.1f-%.1f Mb, in %.1fs"
        % (aln.num_genomes, segments, HUB_SEED, len(leaves), min(lens) / 1e6,
           max(lens) / 1e6, time.perf_counter() - t0))
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def read(root, *parts):
        with open(os.path.join(root, *parts), "rb") as f:
            return f.read()

    flags = ["--lod", "--gcContent", "--rmsk", "--alignability", "--numProc",
             HUB_PROCS]
    small = open_alignment(small_hal).open_genome(small_ref)
    seqs = [(small.seq_names[i], min(int(small.seq_length(i)),
                                     HUB_PHYLOP_CPU_COLUMNS))
            for i in range(small.num_sequences)]
    with port_tools(d) as start:
        # the alignability hub on the card over every leaf, alone
        cuda_dir = os.path.join(d, "hub_cuda")
        sec, _, lp = start("hal2assemblyHub", [hal, cuda_dir] + flags
                           + ["--device", "cuda"], "hub_cuda")()
        cuda_jobs = launch_log(lp)
        log("  hal2assemblyHub --device cuda (all %d leaves, alone): %.1fs; "
            "%s" % (len(leaves), sec, hub_stages(cuda_jobs)))
        log_jobs(cuda_jobs)
        add(card_jobs(cuda_jobs, "halAlignmentDepth", PALLAS_PORTS,
                      "hub --alignability --device cuda"))
        if len([j for j in cuda_jobs if j[0] == "halAlignmentDepth"]) != \
                len(leaves):
            raise AssertionError("hub: not one alignability job a leaf")

        # concurrently: the references on the CPU, the conservation hub
        # and halLodBenchmark on the card
        cpu_dir = os.path.join(d, "hub_cpu")
        cons_dir = os.path.join(d, "hub_cons")
        waits = {
            "hub_cpu": start("hal2assemblyHub", [hal, cpu_dir] + flags + [
                "--genomes", leaf, "--device", "cpu"], "hub_cpu"),
            "hub_cons": start("hal2assemblyHub", [
                small_hal, cons_dir, "--genomes", small_ref, "--conservation",
                small_mod, "--numProc", HUB_PROCS, "--device", "cuda"],
                "hub_cons"),
        }
        for k, (chrom, n) in enumerate(seqs):
            waits["phylop_cpu_%d" % k] = start("halPhyloP", [
                small_hal, small_ref, small_mod,
                os.path.join(d, "phylop_cpu_%d.wig" % k), "--refSequence",
                chrom, "--length", n, "--device", "cpu"], "phylop_cpu_%d" % k)
        for device in ("cuda", "cpu"):
            waits["lodbench_" + device] = start("halLodBenchmark", [
                hal, os.path.join(d, "lodbench_" + device), "--steps",
                HUB_LOD_STEPS, "--doMaf", "--format", "halz", "--device",
                device], "lodbench_" + device)
        done = {k: w() for k, w in waits.items()}
        concurrent = "concurrent with %d other runs" % (len(done) - 1)

        # hal2mafMP on each device, concurrently
        waits = {device: start("hal2mafMP", [
            small_hal, os.path.join(d, "mafmp_%s.maf" % device),
            "--sliceSize", MAFMP_SLICE, "--numProc", HUB_PROCS, "--device",
            device], "mafmp_" + device) for device in ("cuda", "cpu")}
        mafmp = {k: w() for k, w in waits.items()}

    # the one-leaf hub on the CPU against the card's
    sec, _, lp = done["hub_cpu"]
    cpu_jobs = launch_log(lp)
    log("  hal2assemblyHub --device cpu (--genomes %s, %s): %.1fs; %s"
        % (leaf, concurrent, sec, hub_stages(cpu_jobs)))
    log_jobs(cpu_jobs)
    no_launches(cpu_jobs, "hub --device cpu")
    same = [os.path.join(leaf, leaf + x) for x in (
        ".fa", ".gc.wig", ".gc.bw", ".rmsk.bed", ".rmsk.bb",
        ".alignability.wig", ".alignability.bw")]
    same += [os.path.join(leaf, "chrom.sizes"), "hub.txt", "groups.txt",
             "lod.txt"]

    def lod_files(root):
        return sorted(os.path.relpath(os.path.join(dp, f), root)
                      for dp, _, fs in os.walk(os.path.join(root, "lod"))
                      for f in fs)

    lods = lod_files(cpu_dir)
    if not lods or lods != lod_files(cuda_dir):
        raise AssertionError("hub: the LOD series differ or are empty")
    nbytes = 0
    for rel in same + lods:
        a, b = read(cuda_dir, rel), read(cpu_dir, rel)
        if a != b or (not a and not rel.endswith(".rmsk.bed")):
            raise AssertionError("hub: %s differs between --device cuda and "
                                 "--device cpu (%d vs %d bytes)"
                                 % (rel, len(a), len(b)))
        nbytes += len(a)
    for rel, magic in ((".gc.bw", bbi.BIGWIG_MAGIC),
                       (".alignability.bw", bbi.BIGWIG_MAGIC),
                       (".rmsk.bb", bbi.BIGBED_MAGIC)):
        if int.from_bytes(read(cuda_dir, leaf, leaf + rel)[:4],
                          "little") != magic:
            raise AssertionError("hub: %s%s is not a bigWig/bigBed"
                                 % (leaf, rel))
    # trackDb: the snake tracks name the hub's other genomes and the
    # alignability track's range its genome count, so the one-leaf hub's
    # stanzas are rewritten for the all-genome hub's list
    snakes = []
    for other in aln.genome_names():
        if other != leaf:
            buf = io.StringIO()
            ah.trackdb_snake(buf, other, "../lod.txt")
            snakes += trackdb_stanzas(buf.getvalue())
    want = snakes + [
        x.replace("type bigWig 0 1\n", "type bigWig 0 %d\n" % aln.num_genomes)
        for x in trackdb_stanzas(read(cpu_dir, leaf, "trackDb.txt").decode())]
    got = trackdb_stanzas(read(cuda_dir, leaf, "trackDb.txt").decode())
    if got != want or not any("track alignability" in x for x in got):
        raise AssertionError("hub: %s/trackDb.txt differs from the one-leaf "
                             "hub's" % leaf)
    log("  %s's hub files (FASTA, chrom.sizes, GC wiggle and bigWig, "
        "repeat-mask BED and bigBed, alignability wiggle and bigWig), "
        "hub.txt, groups.txt, lod.txt and the %d LOD files: %d bytes equal "
        "on --device cuda and --device cpu; trackDb.txt equal up to the "
        "hubs' genome lists" % (leaf, len(lods), nbytes))

    # the conservation hub against halPhyloP --device cpu
    sec, _, lp = done["hub_cons"]
    jobs = launch_log(lp)
    log("  hal2assemblyHub --conservation --genomes %s --device cuda (%s): "
        "%.1fs; %s" % (small_ref, concurrent, sec, hub_stages(jobs)))
    log_jobs(jobs)
    add(card_jobs(jobs, "halPhyloP", PALLAS_PORTS + ("phylop_fit",),
                  "hub --conservation --device cuda"))
    if int.from_bytes(read(cons_dir, small_ref,
                           small_ref + ".conservation.bw")[:4],
                      "little") != bbi.BIGWIG_MAGIC:
        raise AssertionError("hub: the conservation bigWig is missing")
    blocks = read(cons_dir, small_ref, small_ref + ".conservation.wig"
                  ).decode().split("fixedStep ")[1:]
    if len(blocks) != len(seqs):
        raise AssertionError("hub conservation: %d fixedStep blocks for %d "
                             "sequences" % (len(blocks), len(seqs)))
    dmax, t_cpu = 0.0, 0.0
    for k, ((chrom, n), blk) in enumerate(zip(seqs, blocks)):
        sec, _, lp = done["phylop_cpu_%d" % k]
        t_cpu += sec
        no_launches(launch_log(lp), "halPhyloP --device cpu")
        lines = read(d, "phylop_cpu_%d.wig" % k).decode().splitlines()
        head, _, body = blk.partition("\n")
        va = np.array([float(x) for x in body.split()[:n]])
        vb = np.array([float(x) for x in lines[1:]])
        if "fixedStep " + head != lines[0] or len(vb) != n or len(va) != n:
            raise AssertionError("hub conservation: %s's header or length "
                                 "differs from halPhyloP --device cpu" % chrom)
        dmax = max(dmax, wig_scores_agree(va, vb, "hub conservation %s"
                                          % chrom))
    log("  %s.conservation.wig: %d fixedStep headers equal to halPhyloP "
        "--device cpu's, the first %d values of each sequence (%d in all) "
        "within the float32 tolerance (max |d| %.3f); cpu %.1fs (%s)"
        % (small_ref, len(blocks), HUB_PHYLOP_CPU_COLUMNS,
           sum(n for _, n in seqs), dmax, t_cpu, concurrent))

    # halLodBenchmark --doMaf: its hal2maf runs on the card
    rows = {}
    for device in ("cuda", "cpu"):
        sec, text, lp = done["lodbench_" + device]
        table = [x.split(", ") for x in text.splitlines()
                 if x and not x.startswith("#")]
        col = table[0].index("mafLines")
        rows[device] = [int(r[col]) for r in table[1:]]
        jobs = launch_log(lp)
        log("  halLodBenchmark --steps %s --doMaf --format halz --device %s "
            "(%s): %.1fs, mafLines %s"
            % (HUB_LOD_STEPS, device, concurrent, sec, rows[device]))
        log_jobs([j for j in jobs if j[0] != "halStats"])
        if device == "cuda":
            add(card_jobs(jobs, "hal2maf", PALLAS_PORTS,
                          "halLodBenchmark --doMaf --device cuda"))
        else:
            no_launches(jobs, "halLodBenchmark --device cpu")
    if rows["cuda"] != rows["cpu"] or len(rows["cuda"]) != \
            len(HUB_LOD_STEPS.split(",")) or min(rows["cuda"]) <= 2:
        raise AssertionError("halLodBenchmark: MAF lines %s" % rows)

    # hal2mafMP: every slice runs hal2maf --unique, a host path
    for device, (sec, _, lp) in mafmp.items():
        jobs = [j for j in launch_log(lp) if j[0] == "hal2maf"]
        if not jobs or any(j[5] is not None for j in jobs) or \
                not all("--unique" in j[1] for j in jobs):
            raise AssertionError("hal2mafMP --device %s: a slice reached the "
                                 "device engine" % device)
        mafmp[device] = (read(d, "mafmp_%s.maf" % device), sec, len(jobs))
    if mafmp["cuda"][0] != mafmp["cpu"][0] or not mafmp["cuda"][0]:
        raise AssertionError("hal2mafMP: --device cuda MAF differs from "
                             "--device cpu")
    log("  hal2mafMP --sliceSize %d --numProc %d: a host path (every slice "
        "runs hal2maf --unique, outside the device engine's flag set: the "
        "native engine, with hal2maf's notice, and no slice imports the "
        "kernels); %d slices, %d bytes equal on --device cuda (%.1fs) and "
        "--device cpu (%.1fs), the two concurrent"
        % (MAFMP_SLICE, HUB_PROCS, mafmp["cuda"][2], len(mafmp["cuda"][0]),
           mafmp["cuda"][1], mafmp["cpu"][1]))
    log("  hub path launches (the card jobs' sum): %s" % total)
    log("phase 8 passed in %.1fs" % (time.perf_counter() - t_phase))
    return total


def hub_inputs(tmp: str) -> tuple:
    """Phase 6's CLI alignment (maf.halz) and phase 7's small.mod, made as
    those phases make them, for --hub-only: (halz, its first leaf, .mod)."""
    from hal_tpu_torch.storage import save_alignment

    small = build_maf_alignment(1 << 14, seed=12)
    hal = os.path.join(tmp, "maf.halz")
    save_alignment(small, hal, fmt="halz")
    ref = [n for n in small.genome_names() if small.tree.is_leaf(n)][0]
    mod = os.path.join(tmp, "small.mod")
    with open(mod, "w") as f:
        f.write(mod_text(gtr_model(small.tree.copy(),
                                   np.random.default_rng(82))))
    return hal, ref, mod


def analysis_genes(g, rng, n_status: int, n_rates: int) -> tuple:
    """BED12 text of n_status genes of 1-8 exons over 1-20 kb at random
    places of g's sequences, and BED6 text of n_rates sorted, disjoint
    genes of up to 2 kb and half a slot, one in each of n_rates equal slots
    of g."""
    rows12 = []
    for k in range(n_status):
        si = int(rng.integers(0, g.num_sequences))
        span = int(rng.integers(1000, 20000))
        st = int(rng.integers(0, g.seq_length(si) - span))
        nb = int(rng.integers(1, 9))
        cuts = np.sort(rng.choice(np.arange(1, span), 2 * nb - 2,
                                  replace=False))
        edges = np.concatenate([[0], cuts, [span]])
        starts, ends = edges[0::2], edges[1::2]
        rows12.append("%s\t%d\t%d\tgene%d\t0\t%s\t%d\t%d\t0\t%d\t%s,\t%s,\n"
                      % (g.seq_names[si], st, st + span, k, "+-"[k % 2], st,
                         st + span, nb, ",".join(str(int(e - s)) for s, e
                                                 in zip(starts, ends)),
                         ",".join(str(int(s)) for s in starts)))
    rows6 = []
    per = -(-n_rates // g.num_sequences)
    for si in range(g.num_sequences):
        slot = g.seq_length(si) // per
        for j in range(per):
            ln = int(rng.integers(slot // 10 + 1, min(2000, slot // 2)))
            st = j * slot + int(rng.integers(0, slot - ln))
            rows6.append("%s\t%d\t%d\tgene%d\t0\t%s\n"
                         % (g.seq_names[si], st, st + ln, len(rows6),
                            "+-"[int(rng.integers(0, 2))]))
    return "".join(rows12), "".join(rows6[:n_rates])


def analysis_fixture(tmp: str, segments: int, what: str) -> dict:
    """Phase 9's DNA alignment (phase 4's CLI alignment shape, seed 11,
    `segments` to 1.5 x `segments` segments of ~2 kb a genome) in
    tmp/analysis/aln.halz, its deepest leaf pair and the gene files of
    analysis_genes: made by the first phase that asks, reused by phase
    10.  Returns dict(dir, hal, aln, src, tgt, g (src's genome), bed12,
    bed6)."""
    from hal_tpu_torch.randgen import create_random_alignment
    from hal_tpu_torch.storage import open_alignment, save_alignment

    d = os.path.join(tmp, "analysis")
    hal = os.path.join(d, "aln.halz")
    made = not os.path.exists(hal)
    t0 = time.perf_counter()
    if made:
        os.makedirs(d)
        aln = create_random_alignment(
            seed=11, max_genomes=10, min_genomes=8, mean_degree=1.5,
            max_branch_length=0.2, min_segment_length=1900,
            max_segment_length=2100, min_segments=segments,
            max_segments=segments * 3 // 2, store_dna=True)
        save_alignment(aln, hal, fmt="halz")
    else:
        aln = open_alignment(hal)
    src, tgt = pick_pair(aln)
    g = aln.open_genome(src)
    bed12, bed6 = (os.path.join(d, x) for x in ("genes12.bed", "genes6.bed"))
    if made:
        for path, text in zip((bed12, bed6), analysis_genes(
                g, np.random.default_rng(9), ANALYSIS_STATUS_GENES,
                ANALYSIS_RATE_GENES)):
            with open(path, "w") as f:
                f.write(text)
    log("%s: %d genomes of %d-%d segments with DNA (seed 11, %.1f-%.1f Mb), "
        "%s -> %s (path %d), %s in %.1fs"
        % (what, aln.num_genomes, segments, segments * 3 // 2,
           min(aln.open_genome(n).length for n in aln.genome_names()) / 1e6,
           max(aln.open_genome(n).length for n in aln.genome_names()) / 1e6,
           src, tgt, len(aln.tree.path(src, tgt)),
           "made" if made else "reused", time.perf_counter() - t0))
    return dict(dir=d, hal=hal, aln=aln, src=src, tgt=tgt, g=g,
                bed12=bed12, bed6=bed6)


def run_captured(run, argv, out_path: str, err_path: str, card: str,
                 top: list | None = None):
    """run(argv) in this process with its stdout and stderr in files, under
    torch.profiler when card is a CUDA device: (seconds, device ms or None
    where the profiler recorded no device time).  top, if given, receives
    the three device kernels or copies of most time as (name, ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if card == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # the profiler starts and stops outside the redirection: what it
    # writes itself is not the tool's stderr
    with profile(activities=activities) as prof:
        with open(out_path, "w") as fo, open(err_path, "w") as fe, \
                contextlib.redirect_stdout(fo), \
                contextlib.redirect_stderr(fe):
            t0 = time.perf_counter()
            run(argv)
            if card == "cuda":
                torch.cuda.synchronize()
            sec = time.perf_counter() - t0
    rows = sorted(((e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    if top is not None:
        top.extend(rows[:3])
    dev = sum(ms for _, ms in rows)
    return sec, (dev or None)


def phase_analysis(tmp: str, segments: int = ANALYSIS_SEGMENTS,
                   card: str = "cuda") -> dict:
    """The comparative-analysis tools on phase 4's CLI alignment shape with
    DNA, cut to `segments` segments a genome: halValidate; halSynteny on
    the deepest leaf pair, whole genome; halLiftoverStatus of
    ANALYSIS_STATUS_GENES BED12 genes; syntenyRates of ANALYSIS_RATE_GENES
    sorted genes; the neutral-indel pipeline halTreeMutations ->
    halTreeNIBackground -> halTreeNIConservation -> halTreeNITurnover;
    runDotplot of the source's first sequence.  Each lifting tool runs on
    --device card in this process (under the profiler: its seconds and the
    card's device time) and on --device cpu in a subprocess, the cpu runs
    concurrently with the card's; every output file, stdout and stderr
    must be equal between the two; each card run launches every Pallas
    port, no cpu run any kernel.  Returns the kernels' launches summed
    over the card runs."""
    import shutil

    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.tools import (halLiftoverStatus, halSynteny,
                                     halTreeNITurnover, halValidate,
                                     syntenyRates)

    t_phase = time.perf_counter()
    fx = analysis_fixture(tmp, segments, "phase 9 analysis")
    d, hal, aln, src, tgt, g, bed12, bed6 = (fx[k] for k in (
        "dir", "hal", "aln", "src", "tgt", "g", "bed12", "bed6"))
    ni = os.path.join(d, "ni")
    chrom = g.seq_names[0]
    jobs = {  # name: (tool module, arguments given the output prefix)
        "halSynteny": (halSynteny, lambda o: [
            hal, o + ".psl", "--queryGenome", src, "--targetGenome", tgt]),
        "halLiftoverStatus": (halLiftoverStatus, lambda o: [
            bed12, hal, src, tgt, o + ".tsv"]),
        "syntenyRates": (syntenyRates, lambda o: [
            hal, src, bed6, tgt, "--mergeBedLines"]),
        "halTreeNITurnover": (halTreeNITurnover, lambda o: [hal, o]),
        "runDotplot": (None, lambda o: [
            hal, src, chrom, tgt, "--out", o + ".tsv"]),
    }
    total = {}
    rows = []
    cpu_env = {"OMP_NUM_THREADS": "1"}  # the references share the host
    with port_tools(d) as start:
        # the neutral-indel stages before the lift, one after another, and
        # the references of the other tools, all beside the card's runs
        chain, failed = [], []

        def ni_stages():
            try:
                for tool, args in (
                        ("halTreeMutations", [hal, ni]),
                        ("halTreeNIBackground", [hal, ni]),
                        ("halTreeNIConservation", [hal, ni]
                         + list(ANALYSIS_NI_FLAGS))):
                    chain.append((tool,) + start(tool, args, "ni_" + tool)())
            except AssertionError as e:  # raised below, in this thread's caller
                failed.append(e)

        stages = threading.Thread(target=ni_stages, daemon=True)
        stages.start()
        cpu = {name: start(name, args(os.path.join(d, name + "_cpu"))
                           + ["--device", "cpu"], name + "_cpu", cpu_env)
               for name, (_mod, args) in jobs.items()
               if name != "halTreeNITurnover"}
        out = os.path.join(d, "validate")
        sec, _dev = run_captured(halValidate.run, [hal], out + ".out",
                                 out + ".err", "cpu")
        if open(out + ".out").read() != "\nFile valid\n":
            raise AssertionError("halValidate: %s" % open(out + ".err").read())
        log("  halValidate: File valid in %.1fs (host)" % sec)

        def card_run(name, prefix):
            mod, args = jobs[name]
            K.reset_launches()
            sec, dev = run_captured(mod.run, args(prefix) + [
                "--device", card], prefix + ".out", prefix + ".err", card)
            counts = K.launches()
            check_launched(counts, "analysis %s --device %s" % (name, card))
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            rows.append((name, sec, dev, counts))

        for name in ("halSynteny", "halLiftoverStatus", "syntenyRates"):
            card_run(name, os.path.join(d, name + "_card"))
        sec, _, lp = start("runDotplot", jobs["runDotplot"][1](
            os.path.join(d, "runDotplot_card")) + ["--device", card],
            "runDotplot_card")()
        counts = card_jobs(launch_log(lp), "halLiftover", PALLAS_PORTS,
                           "analysis runDotplot --device %s" % card)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        rows.append(("runDotplot", sec, None, counts))
        stages.join()
        if failed:
            raise failed[0]
        for tool, sec, text, _lp in chain:
            log("  %s (host, beside the card's runs): %.1fs%s"
                % (tool, sec, "; " + text.strip().replace("\n", "; ")[:400]
                   if text.strip() else ""))
        ni_dirs = {run: os.path.join(d, "halTreeNITurnover_" + run)
                   for run in ("card", "cpu")}
        for path in ni_dirs.values():
            shutil.copytree(ni, path)
        cpu["halTreeNITurnover"] = start(
            "halTreeNITurnover", [hal, ni_dirs["cpu"], "--device", "cpu"],
            "halTreeNITurnover_cpu", cpu_env)
        card_run("halTreeNITurnover", ni_dirs["card"])
        refs = {name: wait() for name, wait in cpu.items()}

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    def outputs(name, run):
        base = os.path.join(d, "%s_%s" % (name, run))
        if name == "halTreeNITurnover":
            got = {f: read(os.path.join(base, f))
                   for f in sorted(os.listdir(base))}
        else:
            got = {x: read(base + x) for x in (".psl", ".tsv")
                   if os.path.exists(base + x)}
        got["stdout"] = read(base + ".out")
        got["stderr"] = read(base + ".err")
        return got

    for name, sec, dev, counts in rows:
        want = outputs(name, "cpu")
        got = outputs(name, "card")
        if got != want:
            raise AssertionError("analysis %s: --device %s differs from "
                                 "--device cpu in %s" % (
                                     name, card, sorted(
                                         k for k in set(got) | set(want)
                                         if got.get(k) != want.get(k))))
        body = {k: v for k, v in want.items() if k not in ("stdout",
                                                           "stderr")}
        if not any(body.values()) and not want["stdout"]:
            raise AssertionError("analysis %s wrote nothing" % name)
        ref_sec, _, ref_log = refs[name]
        no_launches(launch_log(ref_log), "analysis %s --device cpu" % name)
        log("  %s: %s; --device %s %.2fs (%s), --device cpu %.2fs "
            "(concurrent); launches %s"
            % (name, ", ".join("%s %d bytes" % (k, len(v))
                               for k, v in sorted(want.items())
                               if k in ("stdout", "stderr", ".psl", ".tsv")
                               or name == "halTreeNITurnover"
                               and k.endswith(("_pm.bed", "_pa.bed"))),
               card, sec,
               "device %.2f ms, %.2f%% of the run" % (dev, dev / sec / 10)
               if dev else "device time not measured%s" % (
                   ": a subprocess job" if name == "runDotplot" else ""),
               ref_sec, {k: v for k, v in counts.items() if v}))
    log("  analysis path launches (the card runs' sum): %s" % total)
    log("phase 9 passed in %.1fs" % (time.perf_counter() - t_phase))
    return total


def phase_regions(tmp: str, segments: int = ANALYSIS_SEGMENTS,
                  card: str = "cuda") -> dict:
    """The region and SNP tools on phase 9's alignment (analysis_fixture):
    halSnps --tsv of the whole source genome against REGIONS_SNP_TARGETS
    leaves, with dupes and with --noDupes; halContiguousRegions of every
    source sequence to the pair's target; halSingleCopyRegionsExtract of
    the whole source against every leaf (its self-map up to the root);
    findRegionsExclusivelyInGroup with a REGIONS_INGROUP-leaf ingroup and
    all outgroup leaves but one allowed;
    hal4dExtract --conserved of the first REGIONS_GENES BED12 genes.  Each
    runs on --device card in this process under the profiler (its seconds
    and the card's device time) and on --device cpu in a subprocess beside
    it; every file it writes, its stdout and its stderr must be equal
    between the two, each card run must launch every Pallas port and no
    cpu run any kernel.  Returns the kernels' launches summed over the
    card runs."""
    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.tools import (findRegionsExclusivelyInGroup,
                                     hal4dExtract, halContiguousRegions,
                                     halSingleCopyRegionsExtract, halSnps)

    t_phase = time.perf_counter()
    fx = analysis_fixture(tmp, segments, "phase 10 regions")
    aln, hal, src, tgt = fx["aln"], fx["hal"], fx["src"], fx["tgt"]
    d = os.path.join(tmp, "regions")
    os.makedirs(d)
    others = [tgt] + [n for n in aln.genome_names() if aln.tree.is_leaf(n)
                      and n not in (src, tgt)]
    snp_targets = ",".join(others[:REGIONS_SNP_TARGETS])
    ingroup = ",".join(others[:REGIONS_INGROUP])
    # at most all outgroup leaves but one: at the fixture's short branches
    # nearly every base aligns to every leaf, and with 0 nothing is left
    max_out = str(max(len(others) - REGIONS_INGROUP - 1, 0))
    genes = os.path.join(d, "genes4d.bed")
    with open(fx["bed12"]) as f, open(genes, "w") as out:
        out.writelines(f.readlines()[:REGIONS_GENES])
    log("  %s: halSnps against %s, ingroup %s (--maxOutgroupGenomes %s), "
        "%d genes, %d sequences" % (src, snp_targets, ingroup, max_out,
                                    REGIONS_GENES, fx["g"].num_sequences))
    jobs = {  # name: (tool module, arguments given the output prefix)
        "halSnps": (halSnps, lambda o: [hal, src, snp_targets, "--tsv",
                                        o + ".tsv"]),
        "halSnps_noDupes": (halSnps, lambda o: [
            hal, src, snp_targets, "--tsv", o + ".tsv", "--noDupes"]),
        "halContiguousRegions": (halContiguousRegions,
                                 lambda o: [hal, src, tgt]),
        "halSingleCopyRegionsExtract": (halSingleCopyRegionsExtract,
                                        lambda o: [hal, src]),
        "findRegionsExclusivelyInGroup": (
            findRegionsExclusivelyInGroup,
            lambda o: [hal, src, ingroup, "--maxOutgroupGenomes", max_out]),
        "hal4dExtract": (hal4dExtract, lambda o: [
            hal, src, genes, o + ".bed", "--conserved"]),
    }
    total, rows = {}, []
    with port_tools(d) as start:
        cpu = {name: start(mod.__name__.rsplit(".", 1)[1],
                           args(os.path.join(d, name + "_cpu"))
                           + ["--device", "cpu"], name + "_cpu",
                           {"OMP_NUM_THREADS": "1"})
               for name, (mod, args) in jobs.items()}
        for name, (mod, args) in jobs.items():
            prefix = os.path.join(d, name + "_card")
            K.reset_launches()
            top = []
            sec, dev = run_captured(mod.run, args(prefix) + [
                "--device", card], prefix + ".out", prefix + ".err", card,
                top)
            counts = K.launches()
            check_launched(counts, "regions %s --device %s" % (name, card))
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            rows.append((name, sec, dev, counts, top))
        refs = {name: wait() for name, wait in cpu.items()}

    def outputs(name, run):
        base = os.path.join(d, "%s_%s" % (name, run))
        got = {}
        for x in (".tsv", ".bed", ".out", ".err"):
            if os.path.exists(base + x):
                with open(base + x, "rb") as f:
                    got[x] = f.read()
        return got

    for name, sec, dev, counts, top in rows:
        want, got = outputs(name, "cpu"), outputs(name, "card")
        if got != want:
            bad = sorted(k for k in set(got) | set(want)
                         if got.get(k) != want.get(k))
            raise AssertionError(
                "regions %s: --device %s differs from --device cpu in %s; "
                "stderr %r against %r" % (name, card, bad,
                                          got.get(".err", b"")[-2000:],
                                          want.get(".err", b"")[-2000:]))
        if not any(v for k, v in want.items() if k != ".err"):
            raise AssertionError("regions %s wrote nothing" % name)
        ref_sec, _, ref_log = refs[name]
        no_launches(launch_log(ref_log), "regions %s --device cpu" % name)
        log("  %s: %s; --device %s %.2fs (device %s), --device cpu %.2fs "
            "(concurrent); launches %s"
            % (name, ", ".join("%s %d lines" % (k, v.count(b"\n"))
                               for k, v in sorted(want.items())),
               card, sec, "%.2f ms, %.2f%% of the run" % (dev, dev / sec / 10)
               if dev else "time not measured", ref_sec,
               {k: v for k, v in counts.items() if v}))
        log("    device top: %s" % "; ".join("%s %.3f ms" % (k[:70], ms)
                                             for k, ms in top))
    log("  regions path launches (the card runs' sum): %s" % total)
    log("phase 10 passed in %.1fs" % (time.perf_counter() - t_phase))
    return total


@contextlib.contextmanager
def timed_calls(mod, names):
    """While the block runs, each function of mod named in names adds its
    seconds to the yielded dict."""
    spent = {n: 0.0 for n in names}
    real = {n: getattr(mod, n) for n in names}

    def timed(n):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return real[n](*a, **k)
            finally:
                spent[n] += time.perf_counter() - t0
        return call

    for n in names:
        setattr(mod, n, timed(n))
    try:
        yield spent
    finally:
        for n in names:
            setattr(mod, n, real[n])


def ml_timed(argv, out_path: str, err_path: str, card: str) -> dict:
    """ancestorsML.run(argv --device card) with its stdout and stderr in
    files, under the profiler (run_captured): its seconds, split into open
    (open_for_update), pass (the likelihoods, posterior and calls and
    their copy to the host) and save (save_back), the device ms and its
    three largest items, the peak device memory (a card run) and the
    launches."""
    import torch

    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.tools import ancestorsML

    K.reset_launches()
    if card == "cuda":
        torch.cuda.reset_peak_memory_stats()
    top = []
    with timed_calls(ancestorsML, ("open_for_update", "save_back")) as spent:
        sec, dev = run_captured(ancestorsML.run, list(argv) + [
            "--device", card], out_path, err_path, card, top)
    return dict(seconds=sec, open=spent["open_for_update"], top=top,
                save=spent["save_back"],
                pass_=sec - spent["open_for_update"] - spent["save_back"],
                device_ms=dev, launches=K.launches(),
                peak=torch.cuda.max_memory_allocated() if card == "cuda"
                else None)


def ml_map_check(aln, genome: str, card: str) -> tuple:
    """ancestorsML's segment map of every child of genome on the card, at
    the run's shape: _child_rows' rows and rev through kernels.cummax_i32
    equal, element for element, to the same map through the plain scan
    (cummax_i32_plain) on the same inputs.  Returns (children, positions,
    aligned positions, reversed positions) summed over the children."""
    import torch

    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.tools import ancestorsML

    g = aln.open_genome(genome)
    n = g.length
    aligned = flipped = 0
    kids = aln.tree.children(genome)
    for child in kids:
        args = (g, aln.open_genome(child), aln.tree.child_index(genome, child),
                n, card)
        before = K.cummax_i32.launches
        rows, rev = ancestorsML._child_rows(*args)
        if K.cummax_i32.launches != before + 1:
            raise AssertionError("ancestorsML map of %s: cummax_i32 launched "
                                 "%d times, want 1" % (
                                     child, K.cummax_i32.launches - before))
        kernel = K.cummax_i32
        K.cummax_i32 = K.cummax_i32_plain
        try:
            want_rows, want_rev = ancestorsML._child_rows(*args)
        finally:
            K.cummax_i32 = kernel
        bad = (rows != want_rows) | (rev != want_rev)
        if bool(bad.any()):
            k = int(bad.nonzero()[0, 0])
            raise AssertionError(
                "ancestorsML map of %s over %d positions: the kernel's rows "
                "or rev differ from the plain scan's at %d positions (first "
                "%d: rows %d vs %d, rev %s vs %s)"
                % (child, n, int(bad.sum()), k, int(rows[k]),
                   int(want_rows[k]), bool(rev[k]), bool(want_rev[k])))
        aligned += int((rows >= 0).sum())
        flipped += int(rev.sum())
        del rows, rev, want_rows, want_rev, bad
    return len(kids), n, aligned, flipped


def same_genome(ga, gb, what: str, dna: bool = True) -> None:
    """Every field of two genomes equal (arrays by value), the DNA unless
    dna is false."""
    import dataclasses

    for f in dataclasses.fields(ga):
        if f.name == "dna" and not dna:
            continue
        x, y = getattr(ga, f.name), getattr(gb, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            equal = np.array_equal(np.asarray(x), np.asarray(y))
        else:
            equal = x == y
        if not equal:
            raise AssertionError("%s: genome %s differs in %s"
                                 % (what, ga.name, f.name))


def ml_ties(aln, genome: str, got: np.ndarray, want: np.ndarray,
            what: str) -> int:
    """The tie rule for ancestorsML's calls of genome: where the card's
    bases (got) differ from the --device cpu run's (want), the reference's
    posteriors (the CPU pass, recomputed here) must tie: the two largest
    within ML_TIE, or the largest within ML_TIE of ML_THRESHOLD.  Returns
    the number of differing positions."""
    import torch

    from hal_tpu_torch.tools import ancestorsML

    diff = np.flatnonzero(got != want)
    if diff.size:
        L = ancestorsML._likelihoods_for(aln, genome, "cpu")[
            torch.from_numpy(diff)].numpy()
        post = L / np.maximum(L.sum(axis=1, keepdims=True), 1e-300)
        top = np.sort(post, axis=1)
        tie = (top[:, 3] - top[:, 2] <= ML_TIE) | (
            np.abs(top[:, 3] - ML_THRESHOLD) <= ML_TIE)
        if not tie.all():
            k = int(np.flatnonzero(~tie)[0])
            raise AssertionError(
                "%s: %s's bases differ at %d positions, %d outside the tie "
                "set (first: position %d, posteriors %s)"
                % (what, genome, diff.size, int((~tie).sum()), int(diff[k]),
                   post[k].tolist()))
    return int(diff.size)


def rewrote(old: np.ndarray, new: np.ndarray, genome: str) -> bytes:
    """ancestorsML --printWrites' line for calls new over bases old."""
    up = np.where((old >= 97) & (old <= 122), old - 32, old)
    return ("ancestorsML: rewrote %d/%d bases of %s\n"
            % (int((up != new).sum()), len(new), genome)).encode()


def lift_bed(g, path: str, n: int, seed: int, rename=None) -> str:
    """n intervals of 1-500 bp at random places of g's sequences, as BED4
    (rename maps sequence names), in path."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(n):
        si = int(rng.integers(0, g.num_sequences))
        ln = g.seq_length(si)
        lo = int(rng.integers(0, max(ln - 1, 1)))
        hi = min(lo + int(rng.integers(1, 501)), ln)
        name = g.seq_names[si]
        rows.append("%s\t%d\t%d\tr%d\n" % ((rename or {}).get(name, name),
                                             lo, hi, k))
    with open(path, "w") as f:
        f.writelines(rows)
    return path


def validated(path: str, what: str) -> None:
    from hal_tpu_torch.tools import halValidate

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        halValidate.run([path])
    if out.getvalue() != "\nFile valid\n":
        raise AssertionError("%s: halValidate printed %r" % (what,
                                                             out.getvalue()))


def phase_editing(tmp: str, maf_aln=None, segments: int = ANALYSIS_SEGMENTS,
                  card: str = "cuda") -> tuple:
    """The editing, import and generation tools.  11a: ancestorsML of the
    root of phase 6's MAF fixture (made here when maf_aln is None), saved
    as mmap, --device card in this process, alone on the host and timed
    (open, pass, save), then --device cpu in a subprocess on a copy: the
    segment map of every child of the root through cummax_i32 equal to the
    plain scan's at every position (ml_map_check), the root's new DNA
    equal under the tie rule, every other genome and every table
    unchanged, stderr equal.  11b: ancestorsMLMP on copies of phase 9's
    alignment, card against cpu, every ancestor's DNA equal under the tie
    rule.  11c: halSetMetadata, halRenameGenomes, halRenameSequences,
    halUpdateBranchLengths, halWriteNucleotides, halRemoveGenome (a leaf),
    halRemoveSubtree, halExtract (a subtree), halAppendSubtree (it back)
    and halReplaceGenome (an identical donor), each on a copy of phase 9's
    alignment and each result validated; on each, halLiftover across the
    edit, card in this process against cpu in a subprocess, bytes equal;
    hal2maf of one sequence, maf2hal of that MAF, halValidate, and hal2maf
    of the imported alignment, card against cpu.  11d: halRandGen,
    halExtract to mmap, halTestGen (each validated), benchMark --formats
    halz,mmap, runAndGetResources around halValidate, and halPhyloPTrain
    failing with the reference's phast message.  Every card run of
    ancestorsML launches cummax_i32, every card lift or hal2maf every
    Pallas port, no cpu run a kernel.  Returns the launches summed over
    the card runs of 11a-11b ("ancestors") and of 11c ("editing")."""
    import re
    import shutil

    import torch

    from hal_tpu_torch.ops import kernels as K
    from hal_tpu_torch.storage import open_alignment, save_alignment
    from hal_tpu_torch.tools import (benchMark, hal2maf, halAppendSubtree,
                                     halExtract, halLiftover, halPhyloPTrain,
                                     halRandGen, halRemoveGenome,
                                     halRemoveSubtree, halRenameGenomes,
                                     halRenameSequences, halReplaceGenome,
                                     halSetMetadata, halTestGen,
                                     halUpdateBranchLengths,
                                     halWriteNucleotides, maf2hal)

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "editing")
    os.makedirs(d)
    ancestors, editing = {}, {}

    def add(total, counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    def sync():
        if card == "cuda":
            torch.cuda.synchronize()

    # ---- 11a: the fixture, its copy, the cpu run started first
    t0 = time.perf_counter()
    made = maf_aln is None
    if made:
        maf_aln = build_maf_alignment(MAF_SEGMENTS)
    root = maf_aln.root_name
    n_root = maf_aln.open_genome(root).length
    ml = {run: os.path.join(d, "ml_%s.mmap" % run) for run in ("card", "cpu")}
    save_alignment(maf_aln, ml["card"], fmt="mmap")
    shutil.copyfile(ml["card"], ml["cpu"])
    log("phase 11 ancestorsML fixture: %s, %d genomes, root %s over %d "
        "children, %.1f Mb; mmap %.2f GB saved and copied, in %.1fs"
        % ("made (MAF_SEGMENTS)" if made else "phase 6's", maf_aln.num_genomes,
           root, len(maf_aln.tree.children(root)), n_root / 1e6,
           os.path.getsize(ml["card"]) / 1e9, time.perf_counter() - t0))

    def ml_argv(run):
        return [ml[run], root, "--printWrites"]

    cpu_env = {"OMP_NUM_THREADS": "1"}
    with port_tools(d) as start:
        # the card run alone on the host; its cpu reference starts after it
        res = ml_timed(ml_argv("card"), ml["card"] + ".out",
                       ml["card"] + ".err", card)
        ml_cpu = start("ancestorsML", ml_argv("cpu") + ["--device", "cpu"],
                       "ml_cpu")
        check_launched(res["launches"], "ancestors (ancestorsML --device %s)"
                       % card, ("cummax_i32",))
        add(ancestors, res["launches"])
        log("  11a ancestorsML --device %s (alone): %.2fs (open %.2f, pass "
            "%.2f, save %.2f), device %s, peak device memory %s, launches %s"
            % (card, res["seconds"], res["open"], res["pass_"], res["save"],
               "%.2f ms, %.2f%% of the run" % (
                   res["device_ms"], res["device_ms"] / res["seconds"] / 10)
               if res["device_ms"] else "not measured",
               "%.2f GB" % (res["peak"] / 1e9) if res["peak"] else "-",
               {k: v for k, v in res["launches"].items() if v}))
        log("    device top: %s" % "; ".join(
            "%s %.3f ms" % (k[:70], ms) for k, ms in res["top"]))
        t0 = time.perf_counter()
        kids, n_map, aligned, flipped = ml_map_check(maf_aln, root, card)
        log("  11a segment map of %d children x %d positions: cummax_i32's "
            "rows and rev equal to the plain scan's at every position (%d "
            "aligned, %d reversed); %.2fs"
            % (kids, n_map, aligned, flipped, time.perf_counter() - t0))

        # ---- 11b: ancestorsMLMP on copies of phase 9's alignment
        fx = analysis_fixture(tmp, segments, "phase 11")
        hal, aln9 = fx["hal"], fx["aln"]
        anc9 = [n for n in aln9.genome_names() if aln9.tree.children(n)]
        mp = {run: os.path.join(d, "mp_%s.halz" % run)
              for run in ("card", "cpu")}
        mp_wait = {}
        for run in ("cpu", "card"):
            shutil.copytree(hal, mp[run])
            mp_wait[run] = start("ancestorsMLMP", [
                mp[run], "--device", card if run == "card" else "cpu"],
                "mp_" + run, cpu_env if run == "cpu" else None)

        # ---- 11c: edits on copies, each validated and lifted across
        tree = aln9.tree
        src, tgt, g = fx["src"], fx["tgt"], fx["g"]
        below = {n: set(tree.preorder(n)) for n in aln9.genome_names()}
        leaves = [n for n in aln9.genome_names() if tree.is_leaf(n)]
        inner = [n for n in aln9.genome_names() if tree.parent(n)
                 and tree.children(n) and set(leaves) - below[n]]
        if not inner:
            raise AssertionError("phase 11: phase 9's tree has no inner "
                                 "genome below its root")
        x = max(inner, key=lambda n: len(below[n]))
        x_leaf = max((n for n in leaves if n in below[x]),
                     key=lambda n: len(tree.path(n, x)))
        out_leaf = next(n for n in leaves if n not in below[x])
        gone = next(n for n in leaves if n not in (src, tgt, x_leaf,
                                                   out_leaf))
        beds = {name: lift_bed(aln9.open_genome(name), os.path.join(
            d, "lift_%s.bed" % name), EDIT_LIFT_LINES, 5 + i)
            for i, name in enumerate((src, x, x_leaf))}
        seq0 = g.seq_names[0]
        beds["renamed"] = lift_bed(g, os.path.join(d, "lift_renamed.bed"),
                                   EDIT_LIFT_LINES, 5,
                                   {seq0: seq0 + "_renamed"})
        tsv = {}
        for name, text in (
                ("genomes", "%s\t%s_renamed\n" % (tgt, tgt)),
                ("sequences", "%s\t%s_renamed\n" % (seq0, seq0))):
            tsv[name] = os.path.join(d, name + ".tsv")
            with open(tsv[name], "w") as f:
                f.write(text)
        rng = np.random.default_rng(17)
        with open(os.path.join(d, "writes.tsv"), "w") as f:
            for name in (src, tgt):
                gg = aln9.open_genome(name)
                for pos in rng.integers(0, gg.length, 16):
                    cur = gg.get_dna_string(int(pos), 1)
                    f.write("%s\t%d\t%s\t%s\n" % (name, pos, cur,
                                                  "C" if cur in "aA" else "A"))
        newick = re.sub(r":[0-9.eE+-]+", ":0.5", tree.to_newick())
        stages = {}  # name: the edited file

        def edited(name, mod, argv_of, base=None):
            path = os.path.join(d, "edit_%s.halz" % name)
            if base is not None:
                shutil.copytree(base, path)
            t0 = time.perf_counter()
            mod.run([str(a) for a in argv_of(path)])
            t_edit = time.perf_counter() - t0
            validated(path, "editing %s" % name)
            stages[name] = path
            return t_edit

        lifts = []

        def lift(name, path, a, bed, b, tool=halLiftover):
            if tool is halLiftover:
                argv = lambda out: [path, a, bed, b, out + ".bed"]
            else:
                argv = lambda out: [path, out + ".maf"]
            out = os.path.join(d, "lift_" + name)
            cpu = start(tool.__name__.rsplit(".", 1)[1], argv(out + "_cpu")
                        + ["--device", "cpu"], "lift_%s_cpu" % name, cpu_env)
            K.reset_launches()
            sec, dev = run_captured(tool.run, argv(out + "_card")
                                    + ["--device", card], out + "_card.out",
                                    out + "_card.err", card)
            counts = K.launches()
            check_launched(counts, "editing (%s after %s --device %s)"
                           % (tool.__name__.rsplit(".", 1)[1], name, card))
            add(editing, counts)
            lifts.append((name, out, cpu, sec, dev, counts))

        renamed = tgt + "_renamed"
        t_edits = {}
        for name, mod, argv_of, base, target in (
                ("halSetMetadata", halSetMetadata,
                 lambda p: [p, "editedBy", "chip_smoke"], hal,
                 (src, beds[src], tgt)),
                ("halRenameGenomes", halRenameGenomes,
                 lambda p: [p, tsv["genomes"]], hal,
                 (src, beds[src], renamed)),
                ("halRenameSequences", halRenameSequences,
                 lambda p: [p, src, tsv["sequences"]], hal,
                 (src, beds["renamed"], tgt)),
                ("halUpdateBranchLengths", halUpdateBranchLengths,
                 lambda p: [p, newick], hal, (src, beds[src], tgt)),
                ("halWriteNucleotides", halWriteNucleotides,
                 lambda p: [p, os.path.join(d, "writes.tsv")], hal,
                 (src, beds[src], tgt)),
                ("halRemoveGenome", halRemoveGenome,
                 lambda p: [p, gone], hal,
                 (src, beds[src], tree.parent(gone))),
                ("halRemoveSubtree", halRemoveSubtree,
                 lambda p: [p, x], hal, (x, beds[x], out_leaf)),
                ("halExtract", halExtract,
                 lambda p: [hal, p, "--root", x], None,
                 (x_leaf, beds[x_leaf], x)),
                ("halAppendSubtree", halAppendSubtree,
                 lambda p: [p, stages["halExtract"], tree.parent(x), x],
                 "removed", (x_leaf, beds[x_leaf], out_leaf)),
                ("halReplaceGenome", halReplaceGenome,
                 lambda p: [p, x, "--topAlignmentFile", hal,
                            "--bottomAlignmentFile", hal], hal,
                 (x_leaf, beds[x_leaf], out_leaf))):
            if base == "removed":
                base = stages["halRemoveSubtree"]
            t_edits[name] = edited(name, mod, argv_of, base)
            lift(name, stages[name], *target)
        # the maf2hal round trip
        rt_maf = os.path.join(d, "rt_src.maf")
        K.reset_launches()
        t0 = time.perf_counter()
        notes = io.StringIO()  # the engine's notice, maf2hal's warnings
        with contextlib.redirect_stderr(notes):
            hal2maf.run([hal, rt_maf, "--refGenome", src, "--refSequence",
                         seq0, "--device", card])
            sync()
            t_rt = time.perf_counter() - t0
            counts = K.launches()
            check_launched(counts, "editing (hal2maf of %s --device %s)"
                           % (seq0, card))
            add(editing, counts)
            imported = os.path.join(d, "rt.halz")
            t0 = time.perf_counter()
            maf2hal.run([rt_maf, imported])
            t_import = time.perf_counter() - t0
        notes = notes.getvalue().splitlines()
        validated(imported, "editing maf2hal")
        lift("maf2hal", imported, None, None, None, tool=hal2maf)

        # ---- 11d: generation and resource tools
        t0 = time.perf_counter()
        gen = {name: os.path.join(d, name) for name in (
            "rand.halz", "rand.mmap", "test.halz")}
        halRandGen.run([gen["rand.halz"], "--preset", "small", "--seed", "7",
                        "--format", "halz"])
        halExtract.run([gen["rand.halz"], gen["rand.mmap"], "--outputFormat",
                        "mmap"])
        halTestGen.run([gen["test.halz"]])
        for name, path in gen.items():
            validated(path, "generation " + name)
        bench = io.StringIO()
        with contextlib.redirect_stdout(bench):
            benchMark.run(["--formats", "halz,mmap"])
        rows = bench.getvalue().splitlines()
        if [r.split(", ")[0] for r in rows[1:]] != ["halz", "mmap"]:
            raise AssertionError("benchMark printed %r" % bench.getvalue())
        _s, res_out, _l = start("runAndGetResources", [
            sys.executable, "-m", "hal_tpu_torch.tools.halValidate",
            gen["rand.mmap"]], "resources")()
        if not re.fullmatch(r"\nFile valid\n\([0-9]+\.[0-9]{3}, [0-9]+\)\n",
                            res_out):
            raise AssertionError("runAndGetResources printed %r" % res_out)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = halPhyloPTrain.main([hal, src, fx["bed12"],
                                      os.path.join(d, "neutral.mod"),
                                      "--device", card])
        if rc != 1 or err.getvalue() != PHAST_MESSAGE:
            raise AssertionError("halPhyloPTrain: exit %d, %r; want exit 1, "
                                 "%r" % (rc, err.getvalue(), PHAST_MESSAGE))
        log("  11d halRandGen (halz, then halExtract to mmap) and halTestGen "
            "valid; benchMark: %s; runAndGetResources %s; halPhyloPTrain "
            "exit 1 with the phast message; %.1fs"
            % ("; ".join(rows[1:]), res_out.split("\n")[-2],
               time.perf_counter() - t0))

        # ---- the references
        lifts = [row + (row[2](),) for row in lifts]
        mp_runs = {run: mp_wait[run]() for run in ("card", "cpu")}
        cpu_sec, _out, cpu_log = ml_cpu()

    # ---- 11a checks
    no_launches(launch_log(cpu_log), "ancestorsML --device cpu")
    a, b = (open_alignment(ml[run]) for run in ("card", "cpu"))
    for name in maf_aln.genome_names():
        for got, run in ((a, "card"), (b, "cpu")):
            same_genome(got.open_genome(name), maf_aln.open_genome(name),
                        "ancestorsML (%s)" % run, dna=name != root)
    old = maf_aln.open_genome(root).get_dna(0, n_root)
    x_card = a.open_genome(root).get_dna(0, n_root)
    x_cpu = b.open_genome(root).get_dna(0, n_root)
    ties = ml_ties(maf_aln, root, x_card, x_cpu, "ancestorsML")
    errs = {"card": read(ml["card"] + ".err"),
            "cpu": read(os.path.join(d, "ml_cpu.err"))}
    want = {"card": rewrote(old, x_card, root), "cpu": rewrote(old, x_cpu,
                                                                root)}
    if errs != want or (not ties and errs["card"] != errs["cpu"]):
        raise AssertionError("ancestorsML stderr: %r, want %r" % (errs, want))
    log("  11a ancestorsML --device cpu (a subprocess, concurrent with "
        "11b-11d): %.2fs; %s; root DNA equal but for %d tie-set positions; "
        "every other genome and table unchanged"
        % (cpu_sec, errs["cpu"].decode().strip(), ties))

    # ---- 11b checks
    jobs = launch_log(mp_runs["card"][2])
    counts = card_jobs(jobs, "ancestorsML", ("cummax_i32",),
                       "ancestors (ancestorsMLMP --device %s)" % card)
    if len([j for j in jobs if j[0] == "ancestorsML"]) != len(anc9):
        raise AssertionError("ancestorsMLMP ran %d ancestorsML jobs for %d "
                             "ancestors" % (len([j for j in jobs if j[0] ==
                                                 "ancestorsML"]), len(anc9)))
    add(ancestors, counts)
    no_launches(launch_log(mp_runs["cpu"][2]), "ancestorsMLMP --device cpu")
    a, b = (open_alignment(mp[run]) for run in ("card", "cpu"))
    ties = 0
    for name in aln9.genome_names():
        for got, run in ((a, "card"), (b, "cpu")):
            same_genome(got.open_genome(name), aln9.open_genome(name),
                        "ancestorsMLMP (%s)" % run, dna=name not in anc9)
        if name in anc9:
            n = aln9.open_genome(name).length
            ties += ml_ties(aln9, name, a.open_genome(name).get_dna(0, n),
                            b.open_genome(name).get_dna(0, n),
                            "ancestorsMLMP")
    log("  11b ancestorsMLMP of %d ancestors: --device %s %.2fs, --device "
        "cpu %.2fs (concurrent); DNA equal but for %d tie-set positions; "
        "launches %s" % (len(anc9), card, mp_runs["card"][0],
                         mp_runs["cpu"][0], ties,
                         {k: v for k, v in counts.items() if v}))
    log_jobs(jobs)

    # ---- 11c checks
    log("  11c x = %s (%d genomes below), %s under it, %s outside, %s "
        "removed; edits (s): %s; hal2maf of %s %.2fs (%s), maf2hal %.2fs "
        "(%d lines of warnings, the first %r)"
        % (x, len(below[x]), x_leaf, out_leaf, gone,
           ", ".join("%s %.2f" % kv for kv in t_edits.items()), seq0, t_rt,
           notes[0] if notes else "", t_import, len(notes) - 1,
           notes[1] if len(notes) > 1 else ""))
    for name, out, _wait, sec, dev, counts, (cpu_sec, _o, cpu_log) in lifts:
        no_launches(launch_log(cpu_log), "editing %s --device cpu" % name)
        ext = ".bed" if name != "maf2hal" else ".maf"
        got = (read(out + "_card" + ext), read(out + "_card.err"))
        want = (read(out + "_cpu" + ext),
                read(os.path.join(d, "lift_%s_cpu.err" % name)))
        if got != want or not got[0]:
            raise AssertionError("editing %s: --device %s output differs "
                                 "from --device cpu (%d vs %d bytes)"
                                 % (name, card, len(got[0]), len(want[0])))
        log("    %s after %s: %d bytes equal; --device %s %.2fs (device %s), "
            "cpu %.2fs; launches %s"
            % ("hal2maf" if name == "maf2hal" else "halLiftover", name,
               len(got[0]), card, sec, "%.2f ms" % dev if dev else "-",
               cpu_sec, {k: v for k, v in counts.items() if v}))
    log("  ancestors path launches: %s; editing path launches: %s"
        % (ancestors, editing))
    log("phase 11 passed in %.1fs" % (time.perf_counter() - t_phase))
    return ancestors, editing


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke test of the port "
                                 "(all phases when run with no argument)")
    ap.add_argument("--hub-only", action="store_true",
                    help="phase 1, then phase 8 alone, on its own copies of "
                         "phase 6's CLI alignment and phase 7's model; "
                         "prints no result lines")
    ap.add_argument("--hub-segments", type=int, default=HUB_SEGMENTS,
                    help="segments a genome of phase 8's alignment")
    ap.add_argument("--analysis-only", action="store_true",
                    help="phase 1, then phase 9 alone; prints no result "
                         "lines")
    ap.add_argument("--analysis-segments", type=int,
                    default=ANALYSIS_SEGMENTS,
                    help="fewest segments a genome of phase 9's alignment "
                         "(phase 10's too)")
    ap.add_argument("--regions-only", action="store_true",
                    help="phase 1, then phase 10 alone; prints no result "
                         "lines")
    ap.add_argument("--editing-only", action="store_true",
                    help="phase 1, then phase 11 alone (on its own MAF "
                         "fixture and phase 9's alignment); prints no "
                         "result lines")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "hal_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(hal_tpu_torch/ not found beside this script)")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log("torch %s, CUDA %s, %s; nvidia-smi: %s"
        % (torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0), smi[0]))
    phase_build()
    if args.hub_only:
        with tempfile.TemporaryDirectory() as tmp:
            phase_hub(tmp, *hub_inputs(tmp), segments=args.hub_segments)
        log("--hub-only: phases 1 and 8 passed in %.1fs; no result lines"
            % (time.perf_counter() - t_start))
        return 0
    if args.analysis_only:
        with tempfile.TemporaryDirectory() as tmp:
            phase_analysis(tmp, segments=args.analysis_segments)
        log("--analysis-only: phases 1 and 9 passed in %.1fs; no result "
            "lines" % (time.perf_counter() - t_start))
        return 0
    if args.regions_only:
        with tempfile.TemporaryDirectory() as tmp:
            phase_regions(tmp, segments=args.analysis_segments)
        log("--regions-only: phases 1 and 10 passed in %.1fs; no result "
            "lines" % (time.perf_counter() - t_start))
        return 0
    if args.editing_only:
        with tempfile.TemporaryDirectory() as tmp:
            phase_editing(tmp, segments=args.analysis_segments)
        log("--editing-only: phases 1 and 11 passed in %.1fs; no result "
            "lines" % (time.perf_counter() - t_start))
        return 0
    t0 = time.perf_counter()
    rec = phase_kernels(dev)
    log("phase 2 passed in %.1fs" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    bench = phase_bench_scale(dev)
    log("phase 3 passed in %.1fs" % (time.perf_counter() - t0))
    from hal_tpu_torch.parallel import distributed

    with tempfile.TemporaryDirectory() as tmp, distributed.initialize(
            "localhost:%d" % free_port(), 1, 0, device=dev) as group:
        t0 = time.perf_counter()
        cli = cli_fixture(tmp)
        runs = {}  # each local CLI run, repeated on a URL in phase 6b
        counts = phase_main_path(dev, bench, tmp, cli, runs)
        log("phase 4 passed in %.1fs" % (time.perf_counter() - t0))
        paths = {"liftover": counts,
                 "depth": phase_depth(dev, bench, tmp, cli, runs)}
        paths["sharded"], sharded_ms = phase_sharded(dev, bench, group)
        del bench
        paths["maf"], (col_counts, sharded_ms["column"]), maf = phase_maf(
            dev, tmp, group, runs)
        for k, c in col_counts.items():
            paths["sharded"][k] += c
        paths["remote"] = phase_remote(tmp, cli, runs)
        rec["phylop_fit"], paths["phylop"] = phase_phylop(dev, maf, tmp)
        small_hal, small_ref, maf_aln = maf[2], maf[3], maf[0]
        del maf
        torch.cuda.empty_cache()
        paths["hub"] = phase_hub(tmp, small_hal, small_ref,
                                 os.path.join(tmp, "small.mod"))
        paths["analysis"] = phase_analysis(tmp,
                                           segments=args.analysis_segments)
        paths["regions"] = phase_regions(tmp,
                                         segments=args.analysis_segments)
        paths["ancestors"], paths["editing"] = phase_editing(
            tmp, maf_aln, segments=args.analysis_segments)
        del maf_aln
    for name in PALLAS_PORTS:
        rec[name]["launches"] = counts[name]
    rec["phylop_fit"]["launches"] = paths["phylop"]["phylop_fit"]
    for name in rec:
        rec[name]["launches_by_path"] = {p: n[name] for p, n in paths.items()}
    log("sharded steps at %d local shards, ms a call (CUDA events / device "
        "/ collectives / NCCL kernels): %s"
        % (SHARDS, {k: [round(v[m], 4) for m in (
            "event_ms", "device_ms", "mesh_ms", "nccl_ms")]
            for k, v in sharded_ms.items()}))
    log("all phases passed in %.1fs" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": [rec[k] for k in PALLAS_PORTS
                                  + ("phylop_fit",)]}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

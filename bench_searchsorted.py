#!/usr/bin/env python3
"""Time hal_tpu_torch's searchsorted kernel against torch.searchsorted and,
optionally, the searchsorted kernel of an earlier checkout, on one GPU.

    python3 bench_searchsorted.py [--baseline DIR]

DIR is an unpacked earlier commit of this repository (git archive) whose
hal_tpu_torch/csrc/searchsorted.cu has the int32-only C entry
hal_searchsorted_right_i32(grid, n, q, out, nq, stream) (the one-thread-
per-query binary search).  That source is compiled alone with the same
nvcc flags.

Shapes (one query per slot of a bench-scale level's capacity, 1,310,720):
  - a 65,536-entry int32 grid with int32 queries (the old kernel limit);
  - a bench-scale uint32-range grid (1,179,648 segments) with int64
    queries, as chip_smoke.py's phase 3 runs it: the kernel's uint32 entry
    on the biased int32 grid; torch.searchsorted on the int64 grid; the
    baseline on the biased grid with queries biased beforehand (its
    wrapper's extra launches are not timed);
  - the CLI cell's shape: a 60,000-entry grid, 16,384 int32 queries.
Each side is timed in turns (baseline, kernel, library, library, kernel,
baseline): device ms from torch.profiler and event ms on the device
timeline; every result is first checked equal to the plain version.
Prints one line per shape, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CAP = 1310720


def load_baseline(root: str, tmp: str):
    """The baseline's searchsorted.cu, built alone; its int32 entry."""
    from hal_tpu_torch.ops import _build

    src = os.path.join(root, "hal_tpu_torch", "csrc", "searchsorted.cu")
    so = os.path.join(tmp, "libbaseline_searchsorted.so")
    cmd = [_build._nvcc()] + _build.NVCC_FLAGS + ["-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s"
                           % (src, res.stderr[-4000:]))
    fn = ctypes.CDLL(so).hal_searchsorted_right_i32
    vp = ctypes.c_void_p
    fn.argtypes = [vp, ctypes.c_int, vp, vp, ctypes.c_longlong, vp]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an unpacked earlier checkout")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_searchsorted: CUDA is not available")
    from chip_smoke import HBM_BYTES_PER_S, device_ms, time_ms
    from hal_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    tmp = tempfile.mkdtemp(prefix="bench_searchsorted_")
    base = load_baseline(args.baseline, tmp) if args.baseline else None

    def on(a):
        return torch.from_numpy(a).to(dev)

    g32 = on(np.sort(rng.integers(0, 1 << 30, 65536)).astype(np.int32))
    q32 = on(rng.integers(0, 1 << 30, CAP).astype(np.int32))
    g64 = on(np.sort(rng.integers(0, 2_600_000_000, 1179648)))
    q64 = on(rng.integers(0, 2_600_000_000, CAP))
    gb = K.bias_u32(g64)
    qb = (q64 - (1 << 31)).to(torch.int32)
    gcli = on(np.sort(rng.integers(0, 120_000_000, 60000)).astype(np.int32))
    qcli = on(rng.integers(0, 120_000_000, 16384).astype(np.int32))

    def baseline(g, q):
        out = torch.empty_like(q)
        err = base(g.data_ptr(), g.numel(), q.data_ptr(), out.data_ptr(),
                   q.numel(), torch._C._cuda_getCurrentRawStream(0))
        if err:
            raise RuntimeError("baseline launch failed (cudaError %d)" % err)
        return out

    for what, g, q, kfn, lfn, bfn in (
            ("grid 65536, %d int32 queries" % CAP, g32, q32,
             lambda t=K.search_tables(g32): K.searchsorted_right(g32, q32, t),
             lambda: torch.searchsorted(g32, q32, right=True, out_int32=True),
             lambda: baseline(g32, q32)),
            ("u32 grid 1179648, %d int64 queries" % CAP, gb, q64,
             lambda t=K.search_tables(gb): K.searchsorted_right_u32(gb, q64,
                                                                    t),
             lambda: torch.searchsorted(g64, q64, right=True),
             lambda: baseline(gb, qb)),
            ("CLI grid 60000, 16384 int32 queries", gcli, qcli,
             lambda t=K.search_tables(gcli): K.searchsorted_right(gcli, qcli,
                                                                  t),
             lambda: torch.searchsorted(gcli, qcli, right=True,
                                        out_int32=True),
             lambda: baseline(gcli, qcli))):
        want = lfn().long()
        for name, fn in (("kernel", kfn), ("baseline", bfn)):
            if name == "baseline" and base is None:
                continue
            if not torch.equal(fn().long(), want):
                raise AssertionError("%s != torch.searchsorted, %s"
                                     % (name, what))
        fns = {"kernel": kfn, "library": lfn}
        order = ["kernel", "library", "library", "kernel"]
        if base is not None:
            fns["baseline"] = bfn
            order = ["baseline"] + order + ["baseline"]
        devt = {k: 0.0 for k in fns}
        evt = {k: 0.0 for k in fns}
        for k in order:
            devt[k] += device_ms(fns[k])[0] / 2
        for k in order:
            evt[k] += time_ms(fns[k]) / 2
        nbytes = g.numel() * 4 + 2 * q.numel() * q.element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print("searchsorted %s: device ms kernel %.4f, torch.searchsorted "
              "%.4f%s; event ms kernel %.4f, torch.searchsorted %.4f%s; bound "
              "%.4f ms (bytes, %d B), kernel at %.1f%% of it"
              % (what, devt["kernel"], devt["library"],
                 ", baseline %.4f" % devt["baseline"] if base else "",
                 evt["kernel"], evt["library"],
                 ", baseline %.4f" % evt["baseline"] if base else "",
                 bound, nbytes, 100 * bound / devt["kernel"]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

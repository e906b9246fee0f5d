#!/usr/bin/env python3
"""Time hal_tpu_torch's phyloP fit kernel (csrc/phylop_fit.cu) against its
plain PyTorch version and, optionally, the fit kernel of an earlier
checkout, on one GPU; print each one's float64 likelihood error.

    python3 bench_phylop_fit.py [--baseline DIR] [--sass]

DIR is an unpacked earlier commit of this repository (git archive into a
gitignored directory such as .scratch/parent) whose csrc/phylop_fit.cu has
the C entries hal_phylop_fit(model, prog, n_edges, n_slots, codes, npat,
lo, hi, invphi, subtree, null, scale, sub, stream) and hal_phylop_lnl(model,
prog, n_edges, n_slots, codes, npat, scale, sub, out, stream).  That source
is compiled alone with the same nvcc flags, and its program and model words
come from DIR's own ops/phylop_fit.py.

Shapes (chip_smoke.py's seeded models and simulated columns):
  - 241 leaves x 2^20 patterns, CONACC: a 241-way window (phase 7);
  - a seeded 9-leaf model x 18,796 patterns, CONACC: the size of the phyloP
    path's first window (phase 7 times the path's own 9-leaf model there);
  - 16 leaves x 2^14 patterns, CONACC, and the subtree CONACC fit.
At each shape: chip_smoke.lnl_checks, the likelihood at seeded scales
(phylop_lnl, the kernel's own likelihood function) against lnl_plain in
float64 on the card, with the baseline's error, which the kernel's must not
exceed; chip_smoke.shapes_identical, both launch shapes and a repeated call
bit-identical; then the fit timed by CUDA events around single calls in
turns (baseline, kernel, kernel in the other shape, plain, ..., baseline),
with the bound of chip_smoke.fit_bound and the share of JAX's count.
--sass prints, per build, the instructions of the fit's edge loop by kind
and per evaluation of the 241-leaf tree (sass_counts; the earlier build's
likelihood kernel, whose walk is its fit's), and the share of the issue
rate they take at the fit's time.
Prints one line per measurement, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def _nvcc_lib(src: str, tmp: str, name: str) -> str:
    from hal_tpu_torch.ops import _build

    so = os.path.join(tmp, name + ".so")
    cmd = [_build._nvcc()] + _build.NVCC_FLAGS + ["-shared", "-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s" % (src, res.stderr[-4000:]))
    return so


def load_baseline(root: str, tmp: str):
    """(the baseline's library, its ops/phylop_fit module) of DIR."""
    src = os.path.join(root, "hal_tpu_torch", "csrc", "phylop_fit.cu")
    lib = ctypes.CDLL(_nvcc_lib(src, tmp, "libbaseline_phylop"))
    vp, ll, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    lib.hal_phylop_fit.argtypes = [vp, vp, i32, i32, vp, ll, f32, f32, f32,
                                   i32, vp, vp, vp, vp]
    lib.hal_phylop_fit.restype = i32
    lib.hal_phylop_lnl.argtypes = [vp, vp, i32, i32, vp, ll, vp, vp, vp, vp]
    lib.hal_phylop_lnl.restype = i32
    spec = importlib.util.spec_from_file_location(
        "baseline_phylop_fit", os.path.join(root, "hal_tpu_torch", "ops",
                                            "phylop_fit.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # dataclasses look their module up
    spec.loader.exec_module(mod)
    return lib, mod


# ------------------------------------------------------------------ SASS

def _instructions(sass: str, func: str) -> list:
    """[(address, instruction), ...] of the function whose mangled name
    contains func."""
    bodies = re.split(r"\n\s*Function : ", sass)
    body = next(b for b in bodies[1:] if func in b.split("\n", 1)[0])
    return [(int(m.group(1), 16), m.group(2).strip()) for m in
            re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]


KINDS = (("FP32", ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FCHK",
                   "FSET")),
         ("MUFU", ("MUFU",)),
         ("local", ("LDL", "STL")),
         ("shared", ("LDS", "STS")),
         ("global", ("LDG", "STG")),
         ("constant", ("LDC",)))


def _kind(op: str) -> str:
    return next((k for k, ops in KINDS if op in ops), "other")


def _target(ins: str):
    m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def sass_counts(sass: str, func: str, flags) -> tuple:
    """(instructions by kind, data-dependent branches) that one walk of the
    edge program issues in the likelihood kernel's edge loop (the longest
    loop with no loop inside it), found by running the loop's SASS on the
    program's flags: every program entry read from shared memory at a
    uniform address is the next entry; registers copied from it carry its
    fields; a branch on a predicate set from an entry's flags follows that
    entry's flag; the loop's back edge, or a branch out of it, is taken
    while entries remain, or once they are all read.  A branch on data
    within the loop (a subnormal partial, the division's slow path) is
    taken, which skips the rare path.  Predicated instructions count as
    issued."""
    ins = _instructions(sass, func)
    at = {a: i for i, (a, _s) in enumerate(ins)}
    loops = [(_target(s), a) for a, s in ins
             if _target(s) is not None and _target(s) < a]
    inner = [x for x in loops if not any(y != x and x[0] <= y[0] and y[1] <= x[1]
                                         for y in loops)]
    lo, hi = max(inner, key=lambda x: x[1] - x[0])
    flags = list(flags) + [0]          # the kernel's zero sentinel
    reg: dict = {}                     # register -> (entry, field) or flag bits
    pred: dict = {}                    # predicate -> meaning
    loaded = 0
    counts = collections.Counter()
    data_branches = 0
    pc = 0
    for _step in range(10 ** 7):
        addr, s = ins[pc]
        guard = re.match(r"@(!?)(U?P\d)\s+(.*)", s)
        body = guard.group(3) if guard else s
        op = body.split()[0]
        base = op.split(".")[0]
        args = [x.strip() for x in body[len(op):].split(",")]
        if lo <= addr <= hi and base not in ("NOP", "BSSY", "BSYNC"):
            counts[_kind(base)] += 1
        dst = args[0] if args and args[0] else ""
        if base == "LDS" and re.fullmatch(r"\[UR\d+(\+0x[0-9a-f]+)?\]", args[-1]) \
                and op.endswith(".128"):
            r = int(dst[1:])
            for f in range(4):
                reg["R%d" % (r + f)] = ("entry", loaded, f)
            loaded += 1
        elif base == "MOV" or op == "IMAD.MOV.U32":
            src = args[-1]
            reg[dst] = reg.get(src)
        elif base == "LOP3" and len(args) >= 6:
            src = args[2] if dst.startswith("P") else args[1]
            mask = args[3] if dst.startswith("P") else args[2]
            e = reg.get(src)
            if e and e[0] == "entry" and e[2] == 2 and mask.startswith("0x"):
                val = ("flag", e[1], int(mask, 16))
                (pred if dst.startswith("P") else reg)[dst] = val
            elif dst.startswith("P"):
                pred[dst] = None
            else:
                reg[dst] = None
        elif base == "R2P":                         # bit i of a register -> Pi
            e = reg.get(args[1])
            for i in range(1, 7):
                if int(args[2], 16) >> i & 1:
                    pred["P%d" % i] = (("flag", e[1], 1 << i)
                                       if e and e[0] == "entry" and e[2] == 2
                                       else None)
        elif base == "ISETP" and args[2] in reg and reg[args[2]] \
                and reg[args[2]][0] == "flag":
            _f, j, mask = reg[args[2]]
            imm = args[3]
            want = int(imm, 16) if imm.startswith("0x") else 0
            neg = ".NE." in op
            pred[dst] = ("cmp", j, mask, want, neg)
        elif dst.startswith(("P", "UP")):
            pred[dst] = None
        elif dst.startswith("R"):
            reg[dst] = None
            if ".64" in op or ".128" in op:
                for f in range(1, 4 if ".128" in op else 2):
                    reg["R%d" % (int(dst[1:]) + f)] = None
        if base == "EXIT" and not guard:
            break
        target = _target(s)
        if target is None:
            pc += 1
            continue
        if guard:
            meaning = pred.get(guard.group(2))
            done = loaded >= len(flags)              # the sentinel is read
            if addr == hi:                           # the back edge
                taken = not done
            elif meaning is None and not lo <= target <= hi:
                taken = done if lo <= addr <= hi else False
            elif meaning is None:
                taken = True
                data_branches += 1
            elif meaning[0] == "flag":
                taken = bool(flags[meaning[1]] & meaning[2])
            else:
                _c, j, mask, want, neg = meaning
                taken = ((flags[j] & mask) != want) == neg
            if guard.group(1) == "!" and meaning is not None:
                taken = not taken
        else:
            taken = True
        if addr == hi and not taken:
            break
        if taken and target < lo and addr != hi:     # an outer loop: once
            taken = False
        pc = at[target] if taken else pc + 1
    return counts, data_branches


def print_sass(label: str, cubin_src: str, func: str, points: int, prog,
               tmp: str, out_dir: str | None, fit_ms: float,
               npat: int) -> None:
    """The instructions an evaluation of the kernel whose mangled name
    contains func (a walk evaluates `points` points), and their share of
    the card's issue rate (one warp instruction a clock on each of an SM's
    four schedulers) at the fit's time fit_ms on npat patterns."""
    import torch

    import chip_smoke as cs
    from hal_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    cubin = os.path.join(tmp, label + ".cubin")
    subprocess.run([nvcc] + [f for f in _build.NVCC_FLAGS if f != "-v"
                             and f != "-Xptxas"]
                   + ["-cubin", "-o", cubin, cubin_src], check=True,
                   capture_output=True)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, label + "_sass.txt"), "w") as f:
            f.write(sass)
    flags = prog.edges[:, 2].tolist()
    counts, data = sass_counts(sass, func, flags)
    per_eval = sum(counts.values()) / points
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fit = 100 * npat * per_eval
    issue_ms = 1e3 * fit / (sms * 128 * cs.SM_CLOCK_HZ)
    print("sass %s %s: per evaluation of the %d-edge program (%d points a "
          "walk, %d data-dependent branches a walk taken): %.0f "
          "instructions, %s; a fit of %d patterns takes %.1f ms at the issue "
          "rate (%d SMs x 128 lanes x 1.98 GHz), the measured %.1f ms is "
          "%.0f%% of it"
          % (label, func, len(flags), points, data, per_eval,
             {k: n / points for k, n in sorted(counts.items())}, npat,
             issue_ms, sms, fit_ms, 100 * issue_ms / fit_ms), flush=True)


# ----------------------------------------------------------------- timing

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an unpacked earlier checkout")
    ap.add_argument("--sass", action="store_true",
                    help="count the likelihood loop's SASS instructions")
    ap.add_argument("--sass-dir", help="also write each build's SASS here")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_phylop_fit: CUDA is not available")
    import chip_smoke as cs
    from hal_tpu_torch.ops import phylop_fit as pf
    from hal_tpu_torch.phylop_torch import DevicePhyloP

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="bench_phylop_")
    base = load_baseline(args.baseline, tmp) if args.baseline else None

    def base_prog(fit):
        old = base[1]
        mod = fit.model
        p = old.build_program(fit._prog, fit._leaves, mod._U, mod._Uinv,
                              mod._lam, mod.background, dtype=torch.float32,
                              device=dev)
        return p, old.model_words(p)

    def base_fit(codes, p, words, mode, sub):
        lo, hi = pf.alt_bounds(mode)
        npat = codes.shape[1]
        outs = [torch.empty(npat, device=dev) for _ in range(3)]
        err = base[0].hal_phylop_fit(
            words.data_ptr(), p.edges.data_ptr(), p.edges.shape[0], p.n_slots,
            codes.data_ptr(), npat, lo, hi, pf.INVPHI, int(sub),
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            torch._C._cuda_getCurrentRawStream(0))
        if err:
            raise RuntimeError("baseline fit failed (cudaError %d)" % err)
        return outs

    def base_lnl(codes, p, words, s, ss):
        out = torch.empty(codes.shape[1], device=dev)
        err = base[0].hal_phylop_lnl(
            words.data_ptr(), p.edges.data_ptr(), p.edges.shape[0], p.n_slots,
            codes.data_ptr(), codes.shape[1], s.data_ptr(), ss.data_ptr(),
            out.data_ptr(), torch._C._cuda_getCurrentRawStream(0))
        if err:
            raise RuntimeError("baseline lnl failed (cudaError %d)" % err)
        return out

    shapes = [("241 leaves x %d, CONACC" % cs.PHYLOP_PATTERNS, 241, 71,
               cs.PHYLOP_PATTERNS, "CONACC", False),
              ("seeded 9 leaves x 18796, CONACC (the phyloP path's window "
               "count)", 9, 83, 18796, "CONACC", False),
              ("16 leaves x %d, CONACC" % cs.PHYLOP_SMALL_PATTERNS, 16, 75,
               cs.PHYLOP_SMALL_PATTERNS, "CONACC", False),
              ("16 leaves x %d, subtree CONACC" % cs.PHYLOP_SMALL_PATTERNS, 16,
               75, cs.PHYLOP_SMALL_PATTERNS, "CONACC", True)]
    for what, n_leaves, seed, npat, mode, subtree in shapes:
        mod = cs.seeded_model(n_leaves, seed)
        leaves = [n for n in mod.tree.postorder() if mod.tree.is_leaf(n)]
        li = {n: i for i, n in enumerate(leaves)}
        sub_nodes = None
        if subtree:
            inner = [x for x in mod.tree.postorder() if not mod.tree.is_leaf(x)]
            sub_nodes = frozenset(mod.tree.preorder(inner[len(inner) // 2]))
        fit = DevicePhyloP(mod, li, mode, sub_nodes, device=dev)
        prog = fit.program()
        prog64 = DevicePhyloP(mod, li, mode, sub_nodes, dtype=torch.float64,
                              device=dev).program()
        codes = cs.simulate_codes(fit, npat, seed + 1, dev)
        rng = np.random.default_rng(seed + 2)
        s = torch.from_numpy(rng.uniform(0.1, 3.0, npat)).float().to(dev)
        ss = torch.from_numpy(rng.uniform(0.5, 2.0, npat)).float().to(dev)
        fns = {"kernel": lambda: pf.phylop_fit(codes, prog, mode, subtree)}
        auto = npat < (pf._launch_args("phylop_fit", codes, prog)[0]
                       .hal_phylop_fit_wave(prog.edges.shape[0], prog.n_slots))
        other = "kernel, %s" % ("one thread a pattern" if auto else
                                "two lanes a pattern")
        fns[other] = lambda: pf._fit_kernel(codes, prog, mode, subtree,
                                            not auto)
        fns["plain"] = lambda: pf.fit_plain(codes, prog, mode, subtree)
        baseline = None
        if base is not None:
            bp, bw = base_prog(fit)
            fns["baseline"] = lambda: base_fit(codes, bp, bw, mode, subtree)

            def baseline():
                return base_lnl(codes, bp, bw, s, ss)
        cs.lnl_checks(pf, codes, s, ss, prog, prog64, what, baseline)
        cs.shapes_identical(pf, codes, prog, mode, subtree, what)
        order = ["kernel", other, "kernel"]
        if base is not None:
            order = ["baseline"] + order + ["baseline"]
        order.insert(len(order) // 2, "plain")
        times = collections.defaultdict(list)
        for name in order:
            times[name].append(cs.event_s(fns[name])[0] * 1e3)
        bound, how, jax = cs.fit_bound(codes, prog, subtree)
        bound, jax = 1e3 * bound, 1e3 * jax
        ms = {name: float(np.median(t)) for name, t in times.items()}
        print("%s: fit ms %s; bound %.4f ms by %s: kernel at %.1f%% of it%s; "
              "of JAX's count's %.4f ms: kernel at %.1f%%%s"
              % (what, ", ".join("%s %s" % (n, [round(x, 3) for x in t])
                                 for n, t in times.items()),
                 bound, how, 100 * bound / ms["kernel"],
                 ", baseline at %.1f%%" % (100 * bound / ms["baseline"])
                 if base is not None else "", jax, 100 * jax / ms["kernel"],
                 ", baseline at %.1f%%" % (100 * jax / ms["baseline"])
                 if base is not None else ""), flush=True)
        if args.sass and n_leaves == 241:
            src = os.path.join(REPO, "hal_tpu_torch", "csrc", "phylop_fit.cu")
            print_sass("kernel", src, "phylop_fit_kernelILi2E", 2, prog,
                       tmp, args.sass_dir, ms["kernel"], npat)
            if base is not None:
                # the earlier fit kernel inlines a walk at every search; its
                # likelihood kernel walks once
                print_sass("baseline", os.path.join(
                    args.baseline, "hal_tpu_torch", "csrc", "phylop_fit.cu"),
                    "phylop_lnl_kernel", 1, bp, tmp, args.sass_dir,
                    ms["baseline"], npat)
        del codes, prog64
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

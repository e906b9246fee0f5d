"""The phyloP fit on the device: the plain PyTorch version and the wrappers
of the CUDA kernel (hal_tpu_torch/csrc/phylop_fit.cu) — the counterpart of
hal_tpu/phylop_jax.py:106-203 (DevicePhyloP._lnl, _golden, _alt_bounds and
the jitted program of _build_jit).

A FitProgram is the model tree as the fit walks it: the internal nodes in
JAX's postorder, each with its children (a leaf's code row or an internal
node's index, the branch length, whether the branch carries the subtree
scale), which the plain version walks, and the kernel's walk of the same
tree as an int4 edge program over shared-memory slots.  Codes are (nleaf,
npat) uint8 base codes (0-3 ACGT, 4 and above missing), pattern-contiguous.

phylop_fit and phylop_lnl take the plain version for tensors on the CPU;
for CUDA tensors they launch the kernel or raise.  Each carries
`launches`, registered in hal_tpu_torch.ops.kernels.KERNELS.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

GOLDEN_ITERS = 50      # phylop_jax.GOLDEN_ITERS
SUBTREE_ITERS = 4      # phylop_jax.SUBTREE_ITERS
SCALE_LO, SCALE_HI = 1e-6, 20.0  # phylop.SCALE_LO / SCALE_HI
INVPHI = (math.sqrt(5.0) - 1.0) / 2.0
MODES = ("CONACC", "CON", "ACC", "NNEUT")
MAX_SLOTS = 32  # kMaxSlots of csrc/phylop_fit.cu
MAX_PATTERNS = 1 << 30  # kMaxPatterns: a call's patterns on the card

# edge flags of the kernel's program (csrc/phylop_fit.cu)
FLAG_IN_SUB, FLAG_LEAF, FLAG_LAST = 1, 2, 8


def alt_bounds(mode: str) -> tuple[float, float]:
    """The alternative model's scale bounds per mode
    (phylop_jax.DevicePhyloP._alt_bounds)."""
    if mode not in MODES:
        raise ValueError("unknown phyloP mode " + mode)
    lo, hi = SCALE_LO, SCALE_HI
    if mode == "CON":
        hi = 1.0
    elif mode == "ACC":
        lo = 1.0
    return lo, hi


@dataclass(frozen=True)
class FitProgram:
    """The tree and the model in one dtype on one device.  nodes: per
    internal node in JAX's postorder, (index, children), each child
    (is_leaf, code row or the index of an internal node, branch length,
    in_sub), in JAX's child order; leaf_cols: (4, 5), column c = Uinv @ L_c
    for the one-hot L_c (c < 4) and L_4 = 1; edges: the kernel's walk
    (program_layout), (n_edges, 4) int32, one row per child: (code row or
    slot, parent slot, flags, branch length as float32 bits); n_slots: the
    slots it keeps alive at once; exp2_rates: lam * log2(e) in float64,
    the last 0 (the function exp2_rates)."""

    nodes: tuple
    n_slots: int
    U: torch.Tensor
    Uinv: torch.Tensor
    lam: torch.Tensor
    bg: torch.Tensor
    leaf_cols: torch.Tensor
    edges: torch.Tensor
    exp2_rates: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.U.dtype

    @property
    def device(self) -> torch.device:
        return self.U.device

    @property
    def n_leaves(self) -> int:
        return sum(leaf for _index, kids in self.nodes for leaf, *_ in kids)

    @property
    def tiny(self) -> float:
        # log(max(bg . root, tiny)), phylop_jax.py:115-116
        return 1e-300 if self.dtype == torch.float64 else 1e-30


def program_layout(prog: list, leaves: list) -> tuple[tuple, int, np.ndarray]:
    """(nodes, n_slots, edges) of a postorder edge program prog = [(node,
    [(child, branch length, in_sub), ...]), ...] over the leaf order
    `leaves` (phylop_jax.DevicePhyloP._prog).  nodes keep prog's order;
    edges are the kernel's walk: from the root down, each node's child
    subtrees are visited in order of the slots they need, largest first
    (Sethi-Ullman; ties in prog's order), and each node's own edges follow
    in prog's child order.  Slots go to internal nodes as they complete; a
    child's slot is freed when its parent consumes it, and the smallest
    free slot is taken first."""
    leaf_row = {n: i for i, n in enumerate(leaves)}
    if not prog:
        raise ValueError("the model tree has no internal node")
    index = {name: k for k, (name, _kids) in enumerate(prog)}
    nodes = tuple(
        (k, tuple((True, leaf_row[c], float(bl), bool(s)) if c in leaf_row
                  else (False, index[c], float(bl), bool(s))
                  for c, bl, s in kids))
        for k, (_name, kids) in enumerate(prog))
    # the slots each subtree keeps alive at its peak: its i-th internal
    # child in visit order needs its own need plus the i results before it
    need = []
    for k, kids in nodes:
        inner = sorted((need[i] for leaf, i, *_ in kids if not leaf),
                       reverse=True)
        need.append(max([1] + [n + i for i, n in enumerate(inner)]))
    visit = []
    stack = [(len(nodes) - 1, False)]
    while stack:
        k, done = stack.pop()
        if done:
            visit.append(k)
            continue
        stack.append((k, True))
        inner = sorted((i for leaf, i, *_ in nodes[k][1] if not leaf),
                       key=lambda i: -need[i])
        stack.extend((i, False) for i in reversed(inner))
    if len(visit) != len(nodes):
        raise ValueError("the edge program is not one tree rooted at its "
                         "last node")
    slot_of: dict = {}
    free: list[int] = []
    n_slots = 0
    edges = []
    for k in visit:
        kids = nodes[k][1]
        rows = []
        for leaf, i, bl, in_sub in kids:
            if leaf:
                rows.append(i)
            else:
                s = slot_of.pop(i)
                rows.append(s)
                free.append(s)
        if free:
            free.sort()
            slot = free.pop(0)
        else:
            slot = n_slots
            n_slots += 1
        slot_of[k] = slot
        for j, ((leaf, _i, bl, in_sub), row) in enumerate(zip(kids, rows)):
            flags = ((FLAG_IN_SUB if in_sub else 0) | (FLAG_LEAF if leaf else 0)
                     | (FLAG_LAST if j == len(kids) - 1 else 0))
            bits = int(np.array(bl, np.float32).view(np.int32))
            edges.append((row, slot, flags, bits))
    return nodes, n_slots, np.array(edges, np.int32).reshape(-1, 4)


def exp2_rates(lam) -> tuple:
    """lam * log2(e) per state in float64, the last set to 0: a rate
    matrix's rows sum to 0, so it has the eigenvalue 0, which eigh puts last
    (the others are negative) and leaves at the residue of the .mod file's
    rounded rows (~1e-11 at ten decimals).  The kernel skips that state's
    exps, each exactly 1.  A last eigenvalue far from 0 is refused."""
    lam = np.asarray(lam, np.float64)
    if abs(lam[3]) > 1e-3 * max(1.0, float(np.abs(lam).max())):
        raise ValueError("the rate matrix's last eigenvalue is %.3g, not its "
                         "eigenvalue 0" % lam[3])
    return tuple(x / math.log(2.0) for x in lam[:3].tolist()) + (0.0,)


def build_program(prog: list, leaves: list, U, Uinv, lam, bg, *,
                  dtype: torch.dtype, device) -> FitProgram:
    """A FitProgram of the edge program `prog` and the model's eigenbasis
    (numpy U, Uinv, lam, bg) in dtype on device."""
    nodes, n_slots, edges = program_layout(prog, leaves)
    if dtype == torch.float32:  # branch lengths as the float32 program sees them
        nodes = tuple((k, tuple((leaf, i, float(np.float32(bl)), s)
                                for leaf, i, bl, s in kids))
                      for k, kids in nodes)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    Uinv_t = t(Uinv)
    leaf_cols = torch.cat([Uinv_t, Uinv_t.sum(dim=1, keepdim=True)], dim=1)
    return FitProgram(nodes=nodes, n_slots=n_slots, U=t(U), Uinv=Uinv_t,
                      lam=t(lam), bg=t(bg), leaf_cols=leaf_cols,
                      edges=torch.as_tensor(edges, device=device),
                      exp2_rates=exp2_rates(lam))


# ------------------------------------------------------------ plain version

def lnl_plain(codes: torch.Tensor, scale: torch.Tensor,
              sub_scale: torch.Tensor, prog: FitProgram) -> torch.Tensor:
    """Log-likelihood per pattern at per-pattern branch multipliers scale
    and sub_scale (npat,) — phylop_jax.DevicePhyloP._lnl."""
    U, Uinv, lam, bg = prog.U, prog.Uinv, prog.lam, prog.bg
    rows = codes.long().clamp(max=4)
    partial: dict = {}
    logscale = torch.zeros(scale.shape, dtype=prog.dtype, device=prog.device)
    L = None
    for node, kids in prog.nodes:
        L = None
        for leaf, index, bl, in_sub in kids:
            t = bl * scale
            if in_sub:
                t = t * sub_scale
            if leaf:
                w = prog.leaf_cols[:, rows[index]]        # Uinv @ L_leaf
            else:
                w = Uinv @ partial.pop(index)
            w = w * torch.exp(lam[:, None] * t[None, :])
            w = torch.clamp_min(U @ w, 0.0)   # P >= 0 (phylop.py pmatrix clip)
            L = w if L is None else L * w
        mx = torch.amax(L, dim=0)
        mx = torch.where(mx > 0, mx, torch.ones_like(mx))
        L = L / mx[None, :]
        logscale = logscale + torch.log(mx)
        partial[node] = L
    return torch.log(torch.clamp_min(bg @ L, prog.tiny)) + logscale


def _golden_plain(fn, lo: float, hi: float, npat: int,
                  prog: FitProgram) -> torch.Tensor:
    """Golden-section maximisation of fn over [lo, hi] per pattern
    (phylop_jax.DevicePhyloP._golden): GOLDEN_ITERS iterations of two
    evaluations; left = f(c) > f(d), so a NaN goes right."""
    kw = dict(dtype=prog.dtype, device=prog.device)
    invphi = torch.tensor(INVPHI, **kw)
    a = torch.full((npat,), lo, **kw)
    b = torch.full((npat,), hi, **kw)
    for _ in range(GOLDEN_ITERS):
        c = b - invphi * (b - a)
        d = a + invphi * (b - a)
        left = fn(c) > fn(d)    # max in [a, d] -> drop (d, b]
        a, b = torch.where(left, a, c), torch.where(left, d, b)
    return (a + b) / 2


def fit_plain(codes: torch.Tensor, prog: FitProgram, mode: str,
              sub: bool) -> tuple:
    """(null_scale, scale, sub_scale) per pattern — the program of
    phylop_jax.DevicePhyloP._build_jit.  Without a subtree the alternative
    fits one scale within the mode's bounds, and the null and subtree scales
    are 1.  With one (sub), the null fits the whole-tree scale over
    [SCALE_LO, SCALE_HI]; the alternative runs SUBTREE_ITERS rounds of a
    whole-tree fit, then a subtree fit within the mode's bounds."""
    npat = codes.shape[1]
    lo, hi = alt_bounds(mode)
    ones = torch.ones(npat, dtype=prog.dtype, device=prog.device)

    def at_sub(sub_scale):
        return lambda s: lnl_plain(codes, s, sub_scale, prog)

    if not sub:
        return ones, _golden_plain(at_sub(ones), lo, hi, npat, prog), ones
    null_scale = _golden_plain(at_sub(ones), SCALE_LO, SCALE_HI, npat, prog)
    scale, sub_scale = ones, ones
    for _ in range(SUBTREE_ITERS):
        scale = _golden_plain(at_sub(sub_scale), SCALE_LO, SCALE_HI, npat,
                              prog)
        fixed = scale
        sub_scale = _golden_plain(
            lambda s: lnl_plain(codes, fixed, s, prog), lo, hi, npat, prog)
    return null_scale, scale, sub_scale


# ----------------------------------------------------------------- kernel

def _check(name: str, codes: torch.Tensor, prog: FitProgram) -> None:
    if codes.dtype != torch.uint8:
        raise TypeError("%s: codes must be uint8, got %s" % (name, codes.dtype))
    if codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError("%s: codes must be a contiguous (nleaf, npat) tensor"
                         % name)
    if codes.shape[0] != prog.n_leaves:
        raise ValueError("%s: codes have %d rows, the tree %d leaves"
                         % (name, codes.shape[0], prog.n_leaves))
    if codes.device != prog.device:
        raise ValueError("%s: codes on %s, program on %s"
                         % (name, codes.device, prog.device))
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (name, codes.device))
    if codes.device.type == "cuda" and prog.dtype != torch.float32:
        raise TypeError("%s: the kernel runs float32, the program is %s"
                        % (name, prog.dtype))


def model_words(prog: FitProgram) -> torch.Tensor:
    """The kernel's Model (csrc/phylop_fit.cu) as float32 host memory: U,
    Uinv (row-major), leaf columns (column c as 4 consecutive words),
    exp2_rates, bg, tiny."""
    parts = [prog.U.reshape(-1), prog.Uinv.reshape(-1),
             prog.leaf_cols.t().reshape(-1),
             torch.tensor(prog.exp2_rates, dtype=torch.float64), prog.bg]
    words = torch.cat([p.detach().to("cpu", torch.float32) for p in parts]
                      + [torch.tensor([prog.tiny], dtype=torch.float32)])
    return words.contiguous()


def _launch_args(name: str, codes: torch.Tensor, prog: FitProgram):
    if codes.shape[1] > MAX_PATTERNS:
        raise ValueError("%s: %d patterns in one call, the kernel at most %d"
                         % (name, codes.shape[1], MAX_PATTERNS))
    if prog.n_slots > MAX_SLOTS:
        raise ValueError("%s: the tree keeps %d partials alive at once, the "
                         "kernel at most %d" % (name, prog.n_slots, MAX_SLOTS))
    from hal_tpu_torch.ops._build import library

    lib = library()
    words = model_words(prog)
    if words.numel() != lib.hal_phylop_model_words():
        raise RuntimeError("csrc/phylop_fit.cu's Model differs from "
                           "phylop_fit.model_words")
    if lib.hal_phylop_max_patterns() != MAX_PATTERNS:
        raise RuntimeError("csrc/phylop_fit.cu's kMaxPatterns differs from "
                           "phylop_fit.MAX_PATTERNS")
    edges = prog.edges
    if edges.dtype != torch.int32 or not edges.is_contiguous():
        raise ValueError("%s: the edge program must be contiguous int32"
                         % name)
    stream = torch._C._cuda_getCurrentRawStream(codes.device.index)
    return lib, words, edges, stream


def phylop_fit(codes: torch.Tensor, prog: FitProgram, mode: str,
               sub: bool = False) -> tuple:
    """(null_scale, scale, sub_scale) per pattern of codes (nleaf, npat)
    uint8: fit_plain on the CPU, the CUDA kernel on the card (float32),
    one launch per call."""
    _check("phylop_fit", codes, prog)
    if codes.device.type == "cpu":
        return fit_plain(codes, prog, mode, sub)
    return _fit_kernel(codes, prog, mode, sub, None)


def _fit_kernel(codes: torch.Tensor, prog: FitProgram, mode: str, sub: bool,
                pair_lanes: bool | None) -> tuple:
    """phylop_fit's launch in either shape: one thread a pattern
    (pair_lanes False) or two lanes a pattern (True), which give the same
    bits; None takes two lanes when the patterns do not fill one wave of
    the card in the first shape."""
    lo, hi = alt_bounds(mode)
    npat = codes.shape[1]
    outs = [torch.empty(npat, dtype=torch.float32, device=codes.device)
            for _ in range(3)]
    if npat == 0:
        return tuple(outs)
    if codes.device.index != torch.cuda.current_device():
        with torch.cuda.device(codes.device):
            return _fit_kernel(codes, prog, mode, sub, pair_lanes)
    lib, words, edges, stream = _launch_args("phylop_fit", codes, prog)
    if pair_lanes is None:
        wave = lib.hal_phylop_fit_wave(edges.shape[0], prog.n_slots)
        if wave < 0:
            raise RuntimeError("phylop_fit: occupancy query failed "
                               "(cudaError %d)" % -wave)
        pair_lanes = npat < wave
    err = lib.hal_phylop_fit(
        words.data_ptr(), edges.data_ptr(), edges.shape[0], prog.n_slots,
        codes.data_ptr(), npat, lo, hi, INVPHI, int(bool(sub)),
        int(pair_lanes), outs[0].data_ptr(),
        outs[1].data_ptr(), outs[2].data_ptr(), stream)
    if err:
        raise RuntimeError("phylop_fit: CUDA launch failed (cudaError %d)"
                           % err)
    phylop_fit.launches += 1
    return tuple(outs)


phylop_fit.launches = 0


def phylop_lnl(codes: torch.Tensor, scale: torch.Tensor,
               sub_scale: torch.Tensor, prog: FitProgram) -> torch.Tensor:
    """Log-likelihood per pattern at given scales: lnl_plain on the CPU, the
    kernel's own likelihood function on the card (float32)."""
    _check("phylop_lnl", codes, prog)
    npat = codes.shape[1]
    for t in (scale, sub_scale):
        if (t.shape != (npat,) or t.dtype != prog.dtype
                or t.device != codes.device or not t.is_contiguous()):
            raise ValueError("phylop_lnl: scales must be contiguous (npat,) "
                             "%s on %s" % (prog.dtype, codes.device))
    if codes.device.type == "cpu":
        return lnl_plain(codes, scale, sub_scale, prog)
    out = torch.empty(npat, dtype=torch.float32, device=codes.device)
    if npat == 0:
        return out
    if codes.device.index != torch.cuda.current_device():
        with torch.cuda.device(codes.device):
            return phylop_lnl(codes, scale, sub_scale, prog)
    lib, words, edges, stream = _launch_args("phylop_lnl", codes, prog)
    err = lib.hal_phylop_lnl(
        words.data_ptr(), edges.data_ptr(), edges.shape[0], prog.n_slots,
        codes.data_ptr(), npat, scale.data_ptr(), sub_scale.data_ptr(),
        out.data_ptr(), stream)
    if err:
        raise RuntimeError("phylop_lnl: CUDA launch failed (cudaError %d)"
                           % err)
    phylop_lnl.launches += 1
    return out


phylop_lnl.launches = 0

"""Port copy of hal_tpu/phylop.py (the same code, imports pointing at
hal_tpu_torch), except PhyloPScorer's device dispatch, which is
the port's: `device` names the torch device ("cuda", the default, or
"cpu"); every batch of patterns is fitted by
hal_tpu_torch.phylop_torch.DevicePhyloP on that device (float32 on the
card, float64 on the CPU), and every window's columns come from the port's
DeviceColumnEngine on that device.  Only a DFS key space the engine refuses
(KeySpaceError) takes the exact column engine, with one stderr line;
anything else raises.

In-process phyloP scoring — native replacement for the phast library the
reference wraps (reference phyloP/impl/halPhyloP.cpp:15-346; the reference
links phast's tm_new_from_file / col_compute_log_likelihood /
opt_newton_1d / chisq_cdf in-process behind its ENABLE_PHYLOP build gate).

hal_tpu computes the same per-column likelihood-ratio test natively:

  * `NeutralModel.from_mod_file` parses the phyloFit .mod format
    (ALPHABET/BACKGROUND/RATE_MAT/TREE) the reference consumes verbatim.
  * Column patterns come from the exact column engine; per-species dup
    masking follows PhyloP::pval's rules (halPhyloP.cpp:239-280):
    dupType=ambiguous masks a species only when its copies disagree,
    dupType=all always masks; dupMask=soft writes N, hard zeroes the
    column's score.
  * Felsenstein pruning over the .mod tree, vectorized across all UNIQUE
    column patterns in the window at once (the reference recomputes per
    column; identical columns share one likelihood fit here).
  * The alternative model fits one scale parameter per pattern by
    golden-section maximization (phast opt_newton_1d equivalent, bounds
    per mode: CON caps scale at 1, ACC floors it at 1 — phast
    fit_column.c semantics), and the LRT p-value uses the chi^2_1 upper
    tail, exact via erfc; CON/ACC use the 50:50 chi^2/point-mass mixture
    (halPhyloP.cpp:322-329).
  * Score = -log10(p), negated under CONACC when the fitted scale > 1
    (acceleration, halPhyloP.cpp:337-339); p floored at 1e-20.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np

import torch

from hal_tpu_torch.tree import Tree

_BASE_INDEX = {65: 0, 67: 1, 71: 2, 84: 3,  # ACGT
               97: 0, 99: 1, 103: 2, 116: 3}  # acgt
SCALE_LO, SCALE_HI = 1e-6, 20.0  # phast fit_column scale bounds


@dataclass
class NeutralModel:
    """Parsed phyloFit .mod: time-reversible rate matrix + phylogeny."""

    background: np.ndarray        # (4,) equilibrium frequencies
    rate_matrix: np.ndarray       # (4,4) Q, rows sum to 0
    tree: Tree
    branch_length: dict           # name -> branch length to parent
    # eigendecomposition of the symmetrized Q for fast expm
    _U: np.ndarray = field(default=None, repr=False)
    _lam: np.ndarray = field(default=None, repr=False)
    _Uinv: np.ndarray = field(default=None, repr=False)

    @classmethod
    def from_mod_file(cls, path: str) -> "NeutralModel":
        txt = open(path).read()

        def grab(key):
            m = re.search(r"^%s:\s*(.*)$" % key, txt, re.M)
            return m.group(1).strip() if m else None

        alphabet = (grab("ALPHABET") or "A C G T").split()
        if [a.upper() for a in alphabet] != ["A", "C", "G", "T"]:
            raise ValueError("only the ACGT alphabet is supported")
        if grab("ORDER") not in (None, "0"):
            raise ValueError("only ORDER 0 models are supported")
        bg = np.array([float(x) for x in grab("BACKGROUND").split()])
        m = re.search(r"^RATE_MAT:\s*$(.*?)^(?=[A-Z_]+:|\Z)", txt,
                      re.M | re.S)
        rows = [r for r in m.group(1).strip().splitlines() if r.strip()]
        Q = np.array([[float(x) for x in r.split()] for r in rows[:4]])
        newick = grab("TREE")
        tree = Tree.from_newick(newick)
        bl = {n: tree.branch_length(n) for n in tree.names()
              if tree.parent(n) is not None}
        model = cls(background=bg, rate_matrix=Q, tree=tree,
                    branch_length=bl)
        model._decompose()
        return model

    def _decompose(self):
        # REV: D^{1/2} Q D^{-1/2} is symmetric -> eigh; P(t)=U e^{lam t} U^-1
        d = np.sqrt(self.background)
        S = (d[:, None] * self.rate_matrix) / d[None, :]
        lam, V = np.linalg.eigh((S + S.T) / 2.0)
        self._U = V / d[:, None]
        self._Uinv = V.T * d[None, :]
        self._lam = lam

    def pmatrix(self, t) -> np.ndarray:
        """P(t) = expm(Q t); t may be an array (..., ) -> (..., 4, 4)."""
        t = np.asarray(t, float)
        e = np.exp(t[..., None] * self._lam)
        P = np.einsum("ij,...j,jk->...ik", self._U, e, self._Uinv)
        return np.clip(P, 1e-300, None)


def column_log_likelihood(model: NeutralModel, leaf_idx: dict,
                          patterns: np.ndarray,
                          scale: np.ndarray,
                          sub_nodes: frozenset | None = None,
                          sub_scale=None) -> np.ndarray:
    """Felsenstein pruning, vectorized: patterns (npat, nleaf) of base
    codes 0..3 (4 = N/missing), scale (npat,) branch multipliers.
    Branches of nodes in sub_nodes get an extra sub_scale factor (the
    phast subtree model's second parameter).  Returns (npat,)
    log-likelihoods."""
    npat = patterns.shape[0]
    scale = np.broadcast_to(np.asarray(scale, float), (npat,))
    if sub_nodes:
        sub_scale = np.broadcast_to(np.asarray(sub_scale, float), (npat,))
    partial = {}
    logscale = np.zeros(npat)
    for name in model.tree.postorder():
        kids = model.tree.children(name)
        if not kids:
            col = patterns[:, leaf_idx[name]]
            L = np.zeros((npat, 4))
            known = col < 4
            L[known, col[known]] = 1.0
            L[~known] = 1.0
            partial[name] = L
            continue
        L = np.ones((npat, 4))
        for c in kids:
            t = model.branch_length[c] * scale
            if sub_nodes and c in sub_nodes:
                t = t * sub_scale
            P = model.pmatrix(t)  # (npat,4,4)
            L = L * np.einsum("pij,pj->pi", P, partial.pop(c))
        # renormalize to avoid underflow on deep trees
        mx = L.max(axis=1)
        mx = np.where(mx > 0, mx, 1.0)
        L /= mx[:, None]
        logscale += np.log(mx)
        partial[name] = L
    root = partial[model.tree.root]
    return np.log(np.clip(root @ model.background, 1e-300, None)) + logscale


def _fit_scale(model, leaf_idx, patterns, lo, hi, iters=50, fn=None):
    """Golden-section maximization of the column log-likelihood over the
    branch-scale parameter, per pattern (vectorized across patterns;
    phast's opt_newton_1d equivalent — the column lnl is unimodal in the
    scale).  Interval shrinks by 0.618/iter: 50 iters ≈ 1e-10 * (hi-lo).
    fn overrides the objective (used by the subtree coordinate fits)."""
    if fn is None:
        def fn(s):
            return column_log_likelihood(model, leaf_idx, patterns, s)
    npat = patterns.shape[0]
    invphi = (math.sqrt(5.0) - 1) / 2
    a = np.full(npat, float(lo))
    b = np.full(npat, float(hi))
    for _ in range(iters):
        c = b - invphi * (b - a)
        d = a + invphi * (b - a)
        fc = fn(c)
        fd = fn(d)
        left = fc > fd  # max in [a, d] -> drop (d, b]; else drop [a, c)
        b = np.where(left, d, b)
        a = np.where(left, a, c)
    s = (a + b) / 2
    return s, fn(s)


def _fit_subtree(model, leaf_idx, patterns, sub_nodes, mode, iters=4):
    """Alternating 1-D fits of (whole-tree scale, subtree scale) — the
    phast subtree alternative model (opt_bfgs over 2 params,
    halPhyloP.cpp:305-312).  The subtree scale is bounded per mode."""
    npat = patterns.shape[0]
    s_lo, s_hi = SCALE_LO, SCALE_HI
    if mode == "CON":
        s_hi = 1.0
    elif mode == "ACC":
        s_lo = 1.0
    scale = np.ones(npat)
    sub = np.ones(npat)
    lnl = None
    for _ in range(iters):
        scale, lnl = _fit_scale(
            model, leaf_idx, patterns, SCALE_LO, SCALE_HI,
            fn=lambda s: column_log_likelihood(model, leaf_idx, patterns, s,
                                               sub_nodes, sub))
        sub, lnl = _fit_scale(
            model, leaf_idx, patterns, s_lo, s_hi,
            fn=lambda s: column_log_likelihood(model, leaf_idx, patterns,
                                               scale, sub_nodes, s))
    return scale, sub, lnl


def score_patterns(model: NeutralModel, leaf_idx: dict,
                   patterns: np.ndarray, mode: str = "CONACC",
                   sub_nodes: frozenset | None = None) -> np.ndarray:
    """phyloP LRT scores for base-code patterns (npat, nleaf).

    Follows PhyloP::pval (halPhyloP.cpp:282-346): null lnl at scale 1,
    alternative maximizes over scale (bounded per mode), p from the
    chi^2_1 upper tail (CON/ACC: 50:50 mixture), score = -log10(p) with
    CONACC acceleration marked negative.

    With sub_nodes (the --subtree branches): null fits the whole-tree
    scale alone; the alternative adds a second, mode-bounded scale on the
    subtree branches, and the sign follows the SUBTREE scale
    (halPhyloP.cpp:296-339)."""
    npat = patterns.shape[0]
    if npat == 0:
        return np.zeros(0)
    if sub_nodes:
        _, null_lnl = _fit_scale(model, leaf_idx, patterns,
                                 SCALE_LO, SCALE_HI)
        _, sign_scale, alt_lnl = _fit_subtree(model, leaf_idx, patterns,
                                              sub_nodes, mode)
        # columns with data only inside or only outside the subtree carry
        # no contrast (col_has_data_sub, halPhyloP.cpp:297-301)
        inside_cols = [leaf_idx[n] for n in leaf_idx if n in sub_nodes]
        outside_cols = [leaf_idx[n] for n in leaf_idx if n not in sub_nodes]
        informative = ((patterns[:, inside_cols] < 4).any(axis=1) &
                       (patterns[:, outside_cols] < 4).any(axis=1))
    else:
        null_lnl = column_log_likelihood(model, leaf_idx, patterns,
                                         np.ones(npat))
        lo, hi = SCALE_LO, SCALE_HI
        if mode == "CON":
            hi = 1.0
        elif mode == "ACC":
            lo = 1.0
        sign_scale, alt_lnl = _fit_scale(model, leaf_idx, patterns, lo, hi)
        informative = (patterns < 4).sum(axis=1) > 0
    return scores_from_lrt(alt_lnl - null_lnl, sign_scale, informative,
                           mode)


def scores_from_lrt(delta: np.ndarray, sign_scale: np.ndarray,
                    informative: np.ndarray, mode: str) -> np.ndarray:
    """LRT delta-lnl -> phyloP score (shared by the numpy and device
    fits): chi^2_1 upper-tail p (CON/ACC: 50:50 mixture with a point mass
    at zero), score = -log10(p) floored at 1e-20, CONACC acceleration
    negative, uninformative columns zero (halPhyloP.cpp:322-346)."""
    x = 2.0 * np.maximum(delta, 0.0)
    # columns whose likelihood is flat in the scale (e.g. a single known
    # species) fit delta = 0 up to optimizer noise; an epsilon there flips
    # the CON/ACC point mass (score 0 vs 0.301).  Snap to the boundary —
    # phast's optimizer tolerance has the same effect.
    x = np.where(x < 1e-9, 0.0, x)
    sf = np.array([math.erfc(math.sqrt(v / 2.0)) for v in x])
    if mode in ("NNEUT", "CONACC"):
        pval = sf
    else:
        # 50:50 mix of chi^2_1 and a point mass at zero
        pval = np.where(x <= 0, 1.0, 0.5 * sf)
    pval = np.maximum(pval, 1e-20)
    score = -np.log10(pval)
    if mode == "CONACC":
        score = np.where(sign_scale > 1.0, -score, score)
    return np.where(informative, score + 0.0, 0.0)  # -0.0 -> 0.0


class PhyloPScorer:
    """Window scorer: columns from the exact column engine, per-species
    dup masking, pattern dedup, vectorized LRT."""

    def __init__(self, aln, mod: NeutralModel, mode: str = "CONACC",
                 dup_mask: str = "soft", dup_type: str = "ambiguous",
                 subtree: str | None = None, device: str = "cuda"):
        if mode not in ("CONACC", "CON", "ACC", "NNEUT"):
            raise ValueError("unknown phyloP mode " + mode)
        if device not in ("cuda", "cpu"):
            raise ValueError("device must be cuda or cpu")
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PhyloPScorer: device cuda: no CUDA device is "
                               "available (device cpu runs on the CPU)")
        if dup_type not in ("all", "ambiguous"):
            raise ValueError("unknown dupType " + dup_type +
                             ", should be all or ambiguous")
        if dup_mask not in ("soft", "hard"):
            raise ValueError("unknown dupMask " + dup_mask)
        self.aln = aln
        self.mod = mod
        self.mode = mode
        self.dup_mask = dup_mask
        self.dup_type = dup_type
        # species = intersection of mod-tree leaves and alignment genomes;
        # absent species are pruned from the tree itself with a warning,
        # like the reference's tr_prune call (halPhyloP.cpp:70-95).
        # Unary internal nodes left behind are harmless for pruning
        # likelihoods (branch factors compose).
        leaves = [n for n in mod.tree.names() if mod.tree.is_leaf(n)]
        present = set(aln.genome_names())
        missing = [n for n in leaves if n not in present]
        if missing:
            import sys

            print("Genome(s) %s not found in alignment; pruning from tree"
                  % ",".join(missing), file=sys.stderr)
        self.species = [n for n in leaves if n in present]
        if not self.species:
            raise ValueError("no model species present in the alignment")
        if missing:
            tree = mod.tree.copy()
            keep = set(self.species)
            changed = True
            while changed:  # childless internals become prunable leaves
                changed = False
                for n in list(tree.names()):
                    if n != tree.root and tree.is_leaf(n) and n not in keep:
                        tree.remove_leaf(n)
                        changed = True
            bl = {n: mod.branch_length[n] for n in tree.names()
                  if tree.parent(n) is not None}
            pruned = NeutralModel(background=mod.background,
                                  rate_matrix=mod.rate_matrix, tree=tree,
                                  branch_length=bl)
            pruned._U, pruned._lam, pruned._Uinv = mod._U, mod._lam, mod._Uinv
            mod = pruned
            self.mod = mod
        self.leaf_idx = {n: i for i, n in enumerate(self.species)}
        # --subtree: a second scale on the branches under (and including)
        # the named node (halPhyloP.cpp:110-126 subtree_root + partition)
        self.sub_nodes: frozenset | None = None
        if subtree:
            if subtree not in self.mod.tree:
                raise ValueError("no node named " + subtree)
            self.sub_nodes = frozenset(self.mod.tree.preorder(subtree))
        self._cache: dict = {}
        # the torch device of the fit and of the column engine; nothing
        # moves from one device to the other
        self.device = device
        self._dev = None
        self._col_eng: dict = {}
        self._col_bad: set = set()

    def _score_batch(self, pats: np.ndarray) -> np.ndarray:
        """Score distinct patterns with the port's DevicePhyloP on
        self.device (the CUDA fit kernel on the card, the float64 plain
        fit on the CPU), then the shared float64 postprocessing."""
        if self._dev is None:
            from hal_tpu_torch.phylop_torch import DevicePhyloP

            self._dev = DevicePhyloP(self.mod, self.leaf_idx, self.mode,
                                     self.sub_nodes or None,
                                     device=self.device)
        return self._dev.score_patterns(pats)

    def _window_slices(self, ref, gs, ge, targets):
        """Column slices for a window from the port's DeviceColumnEngine on
        self.device, one engine per reference.  The engine's slices equal
        the exact DFS's (tests/test_torch_column.py), so dup-mask
        stickiness and row order are unaffected.  A reference whose DFS key
        space the engine refuses (KeySpaceError) takes the exact column
        engine, with one stderr line; any other failure raises."""
        from hal_tpu_torch.ops.column import iter_slices_exact
        from hal_tpu_torch.ops.column_torch import (DeviceColumnEngine,
                                                    KeySpaceError)

        eng = self._col_eng.get(ref)
        if eng is None and ref not in self._col_bad:
            try:
                eng = DeviceColumnEngine(self.aln, ref, targets=targets,
                                         device=self.device)
                self._col_eng[ref] = eng
            except KeySpaceError as e:
                import sys

                self._col_bad.add(ref)
                sys.stderr.write("halPhyloP: device column engine unavailable "
                                 "for %s (%s); using the exact column "
                                 "engine\n" % (ref, e))
        if eng is not None:
            return eng.window_slices(gs, ge)
        return iter_slices_exact(self.aln, ref, gs, ge, targets=targets)

    def score_window(self, ref: str, gs: int, ge: int) -> np.ndarray:
        """Scores for reference positions [gs, ge) (genome coords)."""
        n = ge - gs
        nsp = len(self.species)
        # per-position per-species base code; 4 = missing, 5 = dup-masked
        # (sticky: a masked species never un-masks when more copies land)
        codes = np.full((n, nsp), 4, np.int8)
        hard = np.zeros(n, bool)
        targets = set(self.species) | {ref}
        for sl in self._window_slices(ref, gs, ge, targets):
            k = sl.hi - sl.lo
            off = sl.lo - gs
            for r in sl.rows:
                si = self.leaf_idx.get(r.genome)
                if si is None:
                    continue
                g = self.aln.open_genome(r.genome)
                raw = g.get_dna(r.tgt_lo, k, reversed_=r.rev)
                bc = np.array([_BASE_INDEX.get(int(b), 4) for b in raw],
                              np.int8)
                cur = codes[off:off + k, si]
                fresh = cur == 4
                masked = cur == 5
                if self.dup_type == "all":
                    dup = ~fresh & ~masked
                else:  # ambiguous: only disagreeing copies mask
                    dup = ~fresh & ~masked & (cur != bc)
                if self.dup_mask == "hard":
                    hard[off:off + k] |= dup
                codes[off:off + k, si] = np.where(
                    masked, np.int8(5),
                    np.where(fresh, bc, np.where(dup, np.int8(5), cur)))
        codes = np.where(codes == 5, np.int8(4), codes)  # masked -> N
        # dedup patterns, score each distinct one once (cached across
        # windows — identical columns share one likelihood fit)
        pats, inv = np.unique(codes, axis=0, return_inverse=True)
        keys = [p.tobytes() for p in pats]
        new = [i for i, k in enumerate(keys) if k not in self._cache]
        if new:
            vals = self._score_batch(pats[new].astype(np.int64))
            for j, i in enumerate(new):
                self._cache[keys[i]] = float(vals[j])
        out = np.array([self._cache[k] for k in keys])[inv]
        out[hard] = 0.0  # hard dup mask: column scored 0 (halPhyloP.cpp:262)
        return out

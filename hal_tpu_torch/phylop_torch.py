"""The phyloP fit on a torch device — the counterpart of
hal_tpu/phylop_jax.py:60-264 (DevicePhyloP).

DevicePhyloP flattens the model tree into the postorder edge program of
phylop_jax (each internal node's children with their branch length and
subtree flag) and keeps it, with the rate matrix's eigenbasis (U, Uinv,
lam) and the background, as buffers on an explicit device.  fit() runs
every golden-section search of a batch of patterns through
hal_tpu_torch.ops.phylop_fit.phylop_fit: one launch of the CUDA fit kernel
on the card (float32), the plain PyTorch version on the CPU (float64), the
JAX package's dtype rule.  score_patterns() then re-evaluates the null and
alternative log-likelihoods once each in float64 on the host at the fitted
scales (hal_tpu_torch.phylop.column_log_likelihood) and applies the shared
p-value, sign and mask postprocessing, as phylop_jax does: a float32 search
perturbs the fitted scale only to second order in the likelihood.
"""

from __future__ import annotations

import numpy as np
import torch

from hal_tpu_torch.ops import phylop_fit as pf
from hal_tpu_torch.phylop import (NeutralModel, column_log_likelihood,
                                  scores_from_lrt)


class DevicePhyloP(torch.nn.Module):
    """phyloP LRT over base-code patterns for one neutral model on one
    device; mirrors hal_tpu.phylop.score_patterns (same golden-section
    iteration count, per-mode scale bounds and subtree alternating fit).
    dtype: float32 on cuda and float64 on cpu unless given."""

    def __init__(self, model: NeutralModel, leaf_idx: dict,
                 mode: str = "CONACC", sub_nodes: frozenset | None = None,
                 dtype: torch.dtype | None = None, *, device="cuda"):
        super().__init__()
        if mode not in pf.MODES:
            raise ValueError("unknown phyloP mode " + mode)
        self.model = model
        self.leaf_idx = dict(leaf_idx)
        self.mode = mode
        self.sub_nodes = frozenset(sub_nodes or ())
        self.device = torch.device(device)
        if dtype is None:
            dtype = torch.float64 if self.device.type == "cpu" else torch.float32
        self.dtype = dtype
        # the postorder edge program: for each internal node, its children
        # with (branch length, in-subtree flag)
        self._prog = []
        self._leaves = []
        for name in model.tree.postorder():
            kids = model.tree.children(name)
            if not kids:
                self._leaves.append(name)
                continue
            self._prog.append((name, [(c, float(model.branch_length[c]),
                                       c in self.sub_nodes) for c in kids]))
        self.nleaf = len(self._leaves)
        self._cols = [self.leaf_idx[n] for n in self._leaves]
        prog = pf.build_program(self._prog, self._leaves, model._U,
                                model._Uinv, model._lam, model.background,
                                dtype=dtype, device=self.device)
        self._nodes, self._n_slots = prog.nodes, prog.n_slots
        self._exp2_rates = prog.exp2_rates
        for name in ("U", "Uinv", "lam", "bg", "leaf_cols", "edges"):
            self.register_buffer(name, getattr(prog, name))

    def program(self) -> pf.FitProgram:
        """The fit program over this module's buffers."""
        return pf.FitProgram(nodes=self._nodes, n_slots=self._n_slots,
                             U=self.U, Uinv=self.Uinv, lam=self.lam,
                             bg=self.bg, leaf_cols=self.leaf_cols,
                             edges=self.edges, exp2_rates=self._exp2_rates)

    def codes(self, patterns: np.ndarray) -> torch.Tensor:
        """Patterns (npat, nleaf) with columns ordered by leaf_idx as the
        fit's (nleaf, npat) uint8 codes on this device, rows in the
        program's leaf order."""
        c = np.ascontiguousarray(np.asarray(patterns)[:, self._cols].T,
                                 dtype=np.uint8)
        return torch.from_numpy(c).to(self.U.device)

    def fit(self, patterns: np.ndarray):
        """(null_scale, scale, sub_scale) fitted per pattern as float64
        numpy arrays — patterns (npat, nleaf), columns ordered by
        leaf_idx."""
        out = pf.phylop_fit(self.codes(patterns), self.program(), self.mode,
                            bool(self.sub_nodes))
        return tuple(t.cpu().numpy().astype(np.float64) for t in out)

    def score_patterns(self, patterns: np.ndarray) -> np.ndarray:
        """Drop-in for hal_tpu_torch.phylop.score_patterns: the fit on this
        device, then two float64 host likelihood evaluations at the fitted
        scales and the shared p-value/sign postprocessing."""
        if patterns.shape[0] == 0:
            return np.zeros(0)
        return self.scores_at(patterns, *self.fit(patterns))

    def scores_at(self, patterns: np.ndarray, null_scale: np.ndarray,
                  scale: np.ndarray, sub: np.ndarray) -> np.ndarray:
        """Scores of patterns at fitted (null_scale, scale, sub_scale): the
        float64 host re-evaluation, the float32 delta floor when this
        module fits in float32, and the shared postprocessing."""
        npat = patterns.shape[0]
        if self.sub_nodes:
            null_lnl = column_log_likelihood(self.model, self.leaf_idx,
                                             patterns, null_scale)
            alt_lnl = column_log_likelihood(self.model, self.leaf_idx,
                                            patterns, scale,
                                            self.sub_nodes, sub)
            sign_scale = sub
        else:
            null_lnl = column_log_likelihood(self.model, self.leaf_idx,
                                             patterns, np.ones(npat))
            alt_lnl = column_log_likelihood(self.model, self.leaf_idx,
                                            patterns, scale)
            sign_scale = scale
        delta = alt_lnl - null_lnl
        # float32 search noise floor: a fitted scale off by ~sqrt(eps_f32)
        # perturbs delta by ~1e-5 (second order); below that the LRT
        # carries no signal (score <= ~0.3) and the exact boundary zero
        # must win.  float64 searches need no floor (scores_from_lrt's
        # 1e-9 snap covers them).
        if self.dtype == torch.float32:
            delta = np.where(delta < 1e-4, 0.0, delta)
        if self.sub_nodes:
            inside = [self.leaf_idx[n] for n in self.leaf_idx
                      if n in self.sub_nodes]
            outside = [self.leaf_idx[n] for n in self.leaf_idx
                       if n not in self.sub_nodes]
            informative = ((patterns[:, inside] < 4).any(axis=1)
                           & (patterns[:, outside] < 4).any(axis=1))
        else:
            informative = (patterns < 4).sum(axis=1) > 0
        return scores_from_lrt(delta, sign_scale, informative, self.mode)

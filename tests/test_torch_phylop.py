"""The port's phyloP path (hal_tpu_torch.phylop, phylop_torch,
ops.phylop_fit and the halPhyloP / halPhyloPMP / halTreePhyloP CLIs) on
the CPU, held against the JAX package on the same seeded inputs.

Neutral models are seeded GTR matrices on trees of at most 16 leaves (the
JAX program unrolls the pruning per tree), written as .mod text and parsed
by both packages; nothing is read from outside the repository.
Tolerances: float64 scores within 1e-6 of the JAX package's float64
program (flat-likelihood columns carry ~1e-8 of optimizer noise through
-log10); float64 log-likelihoods within rtol 1e-12 (summation order;
atol 1e-13 for the all-missing column, whose lnl is 0 up to rounding); the
float32 plain fit against the JAX float32 program off the CON/ACC point
mass within 2e-2, CONACC signs flipping only where |score| < 0.05
(tests/test_phylop_jax.py's float32 tolerances); wiggle lines byte-equal."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hal_tpu import phylop as jax_phylop
from hal_tpu.phylop_jax import DevicePhyloP as JaxDevicePhyloP
from hal_tpu.storage import save_alignment as jax_save
from hal_tpu_torch import phylop
from hal_tpu_torch.ops import kernels as K
from hal_tpu_torch.ops import phylop_fit as pf
from hal_tpu_torch.phylop_torch import DevicePhyloP
from hal_tpu_torch.storage import open_alignment
from hal_tpu_torch.tools import HalError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["CONACC", "CON", "ACC", "NNEUT"]

# an 8-leaf binary tree, a multifurcating one (a 3-way node under a 4-way
# root) and one with unary nodes (what pruning absent species leaves)
BINARY8 = ("(((L1:0.11,L2:0.07)I1:0.05,(L3:0.21,L4:0.09)I2:0.12)I3:0.04,"
           "((L5:0.15,L6:0.03)I4:0.08,(L7:0.3,L8:0.06)I5:0.02)I6:0.1)R;")
MULTI = ("((L1:0.1,L2:0.2,L3:0.05)M:0.1,L4:0.3,(L5:0.12,L6:0.04)N:0.07,"
         "L7:0.09)R;")
UNARY = "(((L1:0.1)U1:0.2,L2:0.3)X:0.1,((L3:0.05)U2:0.15)U3:0.1,L4:0.2)R;"


def gtr_mod_text(newick: str, seed: int) -> str:
    """A .mod file of a seeded GTR model (random exchangeabilities and
    background, one expected substitution per unit time) on newick."""
    rng = np.random.default_rng(seed)
    bg = rng.dirichlet(np.full(4, 8.0))
    S = np.zeros((4, 4))
    S[np.triu_indices(4, 1)] = rng.uniform(0.5, 3.0, 6)
    S = S + S.T
    Q = S * bg[None, :]
    np.fill_diagonal(Q, -Q.sum(axis=1))
    Q = Q / -(np.diag(Q) * bg).sum()
    rows = "\n".join("  " + " ".join("%.10f" % v for v in r) for r in Q)
    return ("ALPHABET: A C G T \nORDER: 0\nSUBST_MOD: REV\n"
            "BACKGROUND: %s \nRATE_MAT:\n%s\nTREE: %s\n"
            % (" ".join("%.8f" % b for b in bg), rows, newick))


def models(tmp_path, newick, seed=0):
    """(port model, JAX-package model, leaf_idx) parsed from one file."""
    p = tmp_path / ("m%d.mod" % seed)
    p.write_text(gtr_mod_text(newick, seed))
    pm = phylop.NeutralModel.from_mod_file(str(p))
    jm = jax_phylop.NeutralModel.from_mod_file(str(p))
    leaves = [n for n in pm.tree.names() if pm.tree.is_leaf(n)]
    return pm, jm, {n: i for i, n in enumerate(leaves)}


def patterns(nleaf, npat, seed):
    """Seeded base codes 0-4 (4 = missing), with all-equal and all-missing
    rows among them."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 5, (npat, nleaf)).astype(np.int64)
    p[0] = 0
    p[1] = 4
    p[2] = np.arange(nleaf) % 4
    return p


def outside_f32_tolerance(got, want, mode):
    """The patterns outside the float32 tolerance (tests/test_phylop_jax.py,
    and chip_smoke.scores_agree): near the CON/ACC point mass (both |score|
    <= 0.32) either side of the 0.301 step is fine; elsewhere a CONACC sign
    may flip only where |score| < 0.05, and |d| < 2e-2."""
    d = np.abs(got - want)
    point = np.zeros(len(d), bool)
    if mode in ("CON", "ACC"):
        point = (np.abs(want) <= 0.32) & (np.abs(got) <= 0.32)
    flip = (np.sign(got) != np.sign(want)) & ~point
    return np.where(flip, np.abs(want) >= 0.05, d >= 2e-2) & ~point


def assert_f32_agree(got, want, mode):
    bad = outside_f32_tolerance(got, want, mode)
    assert not bad.any(), (int(bad.sum()), np.abs(got - want)[bad].max())


def seeded_newick(n_leaves, seed):
    """A seeded binary tree: random joins of two subtrees, branch lengths
    0.005 + Exp(0.05)."""
    rng = np.random.default_rng(seed)
    nodes = ["S%02d:%.4f" % (k, 0.005 + rng.exponential(0.05))
             for k in range(n_leaves)]
    k = 0
    while len(nodes) > 1:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        b, a = nodes.pop(j), nodes.pop(i)
        bl = ":%.4f" % (0.005 + rng.exponential(0.05)) if nodes else ""
        nodes.append("(%s,%s)N%02d%s" % (a, b, k, bl))
        k += 1
    return nodes[0] + ";"


def simulated_patterns(model, leaf_idx, npat, seed):
    """Columns simulated down the model tree at per-column scales U(0.1,
    3), then ~20% of the codes set to 4 (missing)."""
    rng = np.random.default_rng(seed)
    tree = model.tree
    scale = rng.uniform(0.1, 3.0, npat)
    state = {tree.root: rng.choice(4, npat, p=model.background)}
    for name in tree.preorder():
        for c in tree.children(name):
            P = model.pmatrix(model.branch_length[c] * scale)
            cum = np.cumsum(np.maximum(P[np.arange(npat), state[name]], 0.0),
                            axis=1)
            u = rng.random((npat, 1)) * cum[:, -1:]
            state[c] = np.minimum((cum < u).sum(axis=1), 3)
    pats = np.stack([state[n] for n in leaf_idx], axis=1).astype(np.int64)
    pats[rng.random(pats.shape) < 0.2] = 4
    return pats


@pytest.mark.parametrize("mode", MODES)
def test_device_phylop_f64_equals_jax(tmp_path, mode):
    pm, jm, li = models(tmp_path, BINARY8, seed=1)
    pats = patterns(8, 300, 2)
    want = JaxDevicePhyloP(jm, li, mode, dtype=np.float64).score_patterns(pats)
    dev = DevicePhyloP(pm, li, mode, device="cpu")
    assert dev.dtype == torch.float64
    got = dev.score_patterns(pats)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the fitted scales are equally good optima (they may differ where the
    # likelihood is flat and the search's comparisons tie)
    _n, s_port, _s = dev.fit(pats)
    _n, s_jax, _s = JaxDevicePhyloP(jm, li, mode, dtype=np.float64).fit(pats)
    np.testing.assert_allclose(
        phylop.column_log_likelihood(pm, li, pats, s_port),
        phylop.column_log_likelihood(pm, li, pats, s_jax), atol=1e-9, rtol=0)


@pytest.mark.parametrize("mode", ["CONACC", "CON"])
def test_subtree_fit_f64_equals_jax(tmp_path, mode):
    pm, jm, li = models(tmp_path, BINARY8, seed=3)
    sub = frozenset(pm.tree.preorder("I2"))
    pats = patterns(8, 200, 4)
    want = JaxDevicePhyloP(jm, li, mode, sub,
                           dtype=np.float64).score_patterns(pats)
    got = DevicePhyloP(pm, li, mode, sub, device="cpu").score_patterns(pats)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got != 0).any()


@pytest.mark.parametrize("newick", [MULTI, UNARY], ids=["multifurcating",
                                                       "unary"])
def test_nonbinary_trees_f64_equal_jax(tmp_path, newick):
    pm, jm, li = models(tmp_path, newick, seed=5)
    pats = patterns(len(li), 250, 6)
    for mode in ("CONACC", "ACC"):
        want = JaxDevicePhyloP(jm, li, mode,
                               dtype=np.float64).score_patterns(pats)
        got = DevicePhyloP(pm, li, mode, device="cpu").score_patterns(pats)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the numpy fit agrees too
    np.testing.assert_allclose(
        got, phylop.score_patterns(pm, li, pats, "ACC"), atol=1e-6, rtol=0)


def _jax_lnl(jd, pats, scale, sub):
    import jax.numpy as jnp

    codes = pats[:, [jd.leaf_idx[n] for n in jd._leaves]].T
    states = np.arange(4)[:, None]
    leafL = {name: jnp.asarray(np.where((codes[i][None, :] == states)
                                        | (codes[i][None, :] >= 4), 1.0, 0.0),
                               jd.dtype)
             for i, name in enumerate(jd._leaves)}
    return np.asarray(jd._lnl(leafL, jnp.asarray(scale, jd.dtype),
                              jnp.asarray(sub, jd.dtype)))


@pytest.mark.parametrize("newick", [BINARY8, MULTI, UNARY],
                         ids=["binary", "multifurcating", "unary"])
def test_lnl_plain_equals_jax_lnl(tmp_path, newick):
    pm, jm, li = models(tmp_path, newick, seed=7)
    internal = [n for n in pm.tree.names() if not pm.tree.is_leaf(n)]
    sub = frozenset(pm.tree.preorder(internal[1]))
    pats = patterns(len(li), 400, 8)
    rng = np.random.default_rng(9)
    scale = rng.uniform(1e-3, 5.0, 400)
    sscale = rng.uniform(0.2, 3.0, 400)
    jd = JaxDevicePhyloP(jm, li, "CONACC", sub, dtype=np.float64)
    want = _jax_lnl(jd, pats, scale, sscale)
    dev = DevicePhyloP(pm, li, "CONACC", sub, device="cpu")
    got = pf.lnl_plain(dev.codes(pats), torch.from_numpy(scale),
                       torch.from_numpy(sscale), dev.program()).numpy()
    # atol for the all-missing column, whose lnl is 0 up to rounding
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = K.launches()
    got2 = pf.phylop_lnl(dev.codes(pats), torch.from_numpy(scale),
                         torch.from_numpy(sscale), dev.program()).numpy()
    assert np.array_equal(got2, got) and K.launches() == before


def _kernel_walk(prog, codes, scale, sub):
    """numpy emulation of csrc/phylop_fit.cu's lnl(): the int4 edge program
    in its visit order with its flags and slot indices, the precomputed leaf
    columns, each edge's w = L + U (2^(exp2_rates t) - 1) Uinv @ L over the
    states that are not unit states multiplied into a partial that starts
    at 1, each node's partial scaled by 2^-e (e
    the binary exponent of its largest state, frexp's) and the integer log
    scale k, result log(max(bg . root, tiny)) + k ln2; in float64."""
    U, Uinv, bg, leaf = (t.numpy() for t in (
        prog.U, prog.Uinv, prog.bg, prog.leaf_cols))
    rates = np.array(prog.exp2_rates)
    keep = rates != 0
    onehot = np.concatenate([np.eye(4), np.ones((4, 1))], axis=1)
    npat = codes.shape[1]
    slots = np.full((prog.n_slots, 4, npat), np.nan)
    L = np.ones((4, npat))
    k = np.zeros(npat, np.int64)
    for child, parent, flags, bits in prog.edges.numpy():
        t = float(np.array(bits, np.int32).view(np.float32)) * scale
        if flags & pf.FLAG_IN_SUB:
            t = t * sub
        if flags & pf.FLAG_LEAF:
            c = np.minimum(codes[child], 4)
            Lc, v = onehot[:, c], leaf[:, c]
        else:
            Lc = slots[child]
            v = Uinv @ Lc
        m = np.expm1(np.log(2.0) * rates[keep, None] * t[None, :])
        w = np.maximum(Lc + U[:, keep] @ (v[keep] * m), 0.0)
        L = L * w
        if flags & pf.FLAG_LAST:
            _m, e = np.frexp(L.max(axis=0))   # e = 0 for an all-zero partial
            slots[parent] = np.ldexp(L, -e[None, :])
            k += e
            L = np.ones((4, npat))
    L = slots[parent]
    return np.log(np.maximum(bg @ L, prog.tiny)) + k * np.log(2.0)


@pytest.mark.parametrize("newick", [BINARY8, MULTI, UNARY],
                         ids=["binary", "multifurcating", "unary"])
def test_kernel_edge_program_equals_plain(tmp_path, newick):
    """What the kernel reads — the edge program, its flags and slots —
    walked as the kernel walks it gives lnl_plain's values (branch lengths
    that float32 holds exactly, so the float64 walk is comparable) on the
    same model with its unit eigenvalue 0, which float32's exp already
    rounds to (every exp of it is exactly 1 in float32)."""
    import dataclasses

    pm, _jm, li = models(tmp_path, newick, seed=11)
    for n in pm.branch_length:
        pm.branch_length[n] = round(pm.branch_length[n] * 128) / 128
    internal = [n for n in pm.tree.names() if not pm.tree.is_leaf(n)]
    dev = DevicePhyloP(pm, li, "CONACC", frozenset(pm.tree.preorder(
        internal[-1])), device="cpu")
    prog = dev.program()
    edges = prog.edges.numpy()
    assert edges.dtype == np.int32 and edges.shape == (
        sum(len(k) for _, k in prog.nodes), 4)
    assert prog.n_slots < len(prog.nodes) or len(prog.nodes) <= 2
    pats = patterns(len(li), 300, 12)
    pats[3, 0] = 7  # any code past 4 is missing, as in the JAX program
    rng = np.random.default_rng(13)
    scale, sub = rng.uniform(0.01, 4.0, 300), rng.uniform(0.3, 3.0, 300)
    codes = dev.codes(pats)
    assert prog.exp2_rates == tuple(
        x / np.log(2.0) for x in pm._lam[:3]) + (0.0,)
    t_max = 400 * max(pm.branch_length.values())
    assert np.float32(np.exp(pm._lam[3] * t_max)) == 1
    lam0 = prog.lam.clone()
    lam0[3] = 0
    want = pf.lnl_plain(codes, torch.from_numpy(scale), torch.from_numpy(sub),
                        dataclasses.replace(prog, lam=lam0)).numpy()
    got = _kernel_walk(prog, codes.numpy().astype(np.int64), scale, sub)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def _simulate_slots(prog):
    """Walk the kernel's edge program over slot states: every slot read is
    of a partial written before and not yet consumed, no slot is written
    while its partial is alive, and every partial but the root's is
    consumed.  Returns the largest slot index used + 1."""
    alive = {}
    for child, parent, flags, _bits in prog.edges.numpy():
        if not flags & pf.FLAG_LEAF:
            assert alive.pop(int(child), None) == "written", child
        if flags & pf.FLAG_LAST:
            assert int(parent) not in alive, parent
            alive[int(parent)] = "written"
    assert len(alive) == 1
    return int(prog.edges[:, 1].max()) + 1


@pytest.mark.parametrize("n_leaves,seed,most", [(241, 71, 5), (16, 75, 2)])
def test_program_layout_visits_by_slot_need(n_leaves, seed, most):
    """The kernel's walk of chip_smoke's seeded trees (the 241-leaf tree
    keeps 14 partials alive in JAX's postorder): at most `most` slots,
    each node's edges in JAX's child order, no slot read before it is
    written or overwritten while alive."""
    sys.path.insert(0, REPO)
    import chip_smoke

    mod = chip_smoke.seeded_model(n_leaves, seed)
    leaves = [n for n in mod.tree.postorder() if mod.tree.is_leaf(n)]
    dev = DevicePhyloP(mod, {n: i for i, n in enumerate(leaves)}, "CONACC",
                       device="cpu")
    prog = dev.program()
    assert prog.n_slots <= most
    assert _simulate_slots(prog) == prog.n_slots
    # nodes keep JAX's postorder, children in JAX's order
    assert [len(kids) for _k, kids in prog.nodes] == [len(k) for _n, k in
                                                      dev._prog]
    # each node's run of edges, in the walk, is its JAX child list
    edges = prog.edges.numpy()
    ends = np.flatnonzero(edges[:, 2] & pf.FLAG_LAST)
    runs = np.split(edges, ends[:-1] + 1)
    by_kids = sorted(tuple((bool(leaf), int(i) if leaf else -1,
                            float(np.float32(bl)))
                           for leaf, i, bl, _s in kids)
                     for _k, kids in prog.nodes)
    got = sorted(tuple((bool(f & pf.FLAG_LEAF),
                        int(c) if f & pf.FLAG_LEAF else -1,
                        float(np.array(b, np.int32).view(np.float32)))
                       for c, _p, f, b in run) for run in runs)
    assert got == by_kids
    # JAX's postorder keeps more partials alive at once (14 and 3)
    alive = peak = 0
    for _k, kids in prog.nodes:
        alive += 1 - sum(not leaf for leaf, *_ in kids)
        peak = max(peak, alive)
    assert peak > prog.n_slots


def test_program_slots_reused_and_bounded():
    """Slots are reused over the postorder: a caterpillar keeps one partial
    alive, a balanced 16-leaf tree four; a tree past MAX_SLOTS is refused
    before any launch."""
    cat = [("I%d" % k, [("I%d" % (k - 1) if k else "L0", 0.1, False),
                        ("L%d" % (k + 1), 0.1, False)]) for k in range(15)]
    leaves = ["L%d" % k for k in range(16)]
    assert pf.program_layout(cat, leaves)[1] == 1

    def balanced(lo, hi, prog):
        if hi - lo == 1:
            return "L%d" % lo
        mid = (lo + hi) // 2
        a, b = balanced(lo, mid, prog), balanced(mid, hi, prog)
        prog.append(("N%d_%d" % (lo, hi), [(a, 0.1, False), (b, 0.1, False)]))
        return prog[-1][0]

    prog = []
    balanced(0, 16, prog)
    nodes, n_slots, edges = pf.program_layout(prog, leaves)
    assert n_slots == 4 and len(nodes) == 15 and edges.shape == (30, 4)
    wide = [("W%d" % k, [("a%d" % k, 0.1, False), ("b%d" % k, 0.1, False)])
            for k in range(pf.MAX_SLOTS + 1)]
    wide.append(("R", [("W%d" % k, 0.1, False)
                       for k in range(pf.MAX_SLOTS + 1)]))
    wl = [x % k for k in range(pf.MAX_SLOTS + 1) for x in ("a%d", "b%d")]
    bg = np.full(4, 0.25)
    prog_w = pf.build_program(wide, wl, np.eye(4), np.eye(4), np.zeros(4), bg,
                              dtype=torch.float32, device="cpu")
    assert prog_w.n_slots == pf.MAX_SLOTS + 1
    codes = torch.zeros((len(wl), 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="partials alive"):
        pf._launch_args("phylop_fit", codes, prog_w)


@pytest.mark.parametrize("mode", ["CONACC", "CON", "ACC"])
def test_f32_plain_fit_agrees_with_jax_f32(tmp_path, mode):
    """The float32 plain fit (the card's precision) against the JAX
    package's float32 program, both after the float64 host re-evaluation,
    and each against the float64 numpy fit."""
    pm, jm, li = models(tmp_path, BINARY8, seed=15)
    pats = patterns(8, 300, 16)
    want = JaxDevicePhyloP(jm, li, mode, dtype=np.float32).score_patterns(pats)
    dev = DevicePhyloP(pm, li, mode, dtype=torch.float32, device="cpu")
    assert dev.U.dtype == torch.float32
    got = dev.score_patterns(pats)
    assert_f32_agree(got, want, mode)
    exact = phylop.score_patterns(pm, li, pats, mode)
    assert_f32_agree(got, exact, mode)
    assert_f32_agree(want, exact, mode)


@pytest.mark.parametrize("sub_leaves", [2, 4, 11])
def test_f32_subtree_fit_agrees_with_jax_f32(tmp_path, sub_leaves):
    """The float32 subtree fit depends on rounding: its 4 alternating
    rounds stop short of convergence on a ridge of (scale, subtree scale),
    so two float32 programs of the same schedule part on a few patterns.
    The port's plain float32 fit against the JAX package's float32 program
    on simulated columns of a 16-leaf tree: at most 1% of the patterns
    outside the float32 tolerance (chip_smoke.SUBTREE_F32_SHARE, the share
    the card's kernel may differ from the plain fit by)."""
    pm, jm, li = models(tmp_path, seeded_newick(16, 75), seed=75)
    inner = sorted(n for n in pm.tree.names() if not pm.tree.is_leaf(n))
    size = {n: sum(pm.tree.is_leaf(x) for x in pm.tree.preorder(n))
            for n in inner}
    node = min(inner, key=lambda n: (abs(size[n] - sub_leaves), n))
    sub = frozenset(pm.tree.preorder(node))
    pats = simulated_patterns(pm, li, 4096, 77)
    want = JaxDevicePhyloP(jm, li, "CONACC", sub,
                           dtype=np.float32).score_patterns(pats)
    got = DevicePhyloP(pm, li, "CONACC", sub, dtype=torch.float32,
                       device="cpu").score_patterns(pats)
    bad = outside_f32_tolerance(got, want, "CONACC")
    assert bad.mean() <= 0.01, (size[node], int(bad.sum()))
    assert (np.abs(got - want) < 1e-3).mean() > 0.95


def test_fit_wrapper_on_cpu_and_its_checks(tmp_path):
    pm, _jm, li = models(tmp_path, BINARY8, seed=17)
    dev = DevicePhyloP(pm, li, "CONACC", device="cpu")
    pats = patterns(8, 50, 18)
    codes, prog = dev.codes(pats), dev.program()
    before = K.launches()
    assert set(before) >= {"phylop_fit", "phylop_lnl", "searchsorted_right"}
    got = pf.phylop_fit(codes, prog, "CONACC")
    want = pf.fit_plain(codes, prog, "CONACC", False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K.launches() == before
    with pytest.raises(TypeError, match="uint8"):
        pf.phylop_fit(codes.long(), prog, "CONACC")
    with pytest.raises(ValueError, match="contiguous"):
        pf.phylop_fit(codes.t(), prog, "CONACC")
    with pytest.raises(ValueError, match="7 rows, the tree 8 leaves"):
        pf.phylop_fit(codes[:7].contiguous(), prog, "CONACC")
    with pytest.raises(ValueError, match="unknown phyloP mode"):
        pf.phylop_fit(codes, prog, "FAST")
    with pytest.raises(ValueError, match="no internal node"):
        pf.program_layout([], ["A"])
    assert pf.phylop_fit(codes[:, :0].contiguous(), prog, "CON")[1].shape == (0,)
    words = pf.model_words(prog)
    assert words.dtype == torch.float32 and words.numel() == 61
    assert torch.equal(words[32:36], prog.leaf_cols[:, 0].float())
    # lam * log2(e) with the unit state's 0, as csrc/phylop_fit.cu's lam2
    assert torch.equal(words[52:56], torch.tensor(prog.exp2_rates).float())
    assert words[55] == 0
    with pytest.raises(ValueError, match="not its eigenvalue 0"):
        pf.exp2_rates([-1.5, -1.0, -0.5, -0.1])
    assert float(words[-1]) == pytest.approx(1e-300) or words[-1] == 0


# ---------------------------------------------------------------- scorer

def _port_aln(jax_aln, tmp_path, name):
    path = str(tmp_path / name)
    jax_save(jax_aln, path, fmt="halz")
    return path, open_alignment(path)


def _tree_mod(tmp_path, aln, seed):
    """A .mod on the alignment's own tree (its names and branch lengths)."""
    p = tmp_path / ("tree%d.mod" % seed)
    p.write_text(gtr_mod_text(aln.tree.to_newick(), seed))
    return str(p)


def _random_jax_aln():
    from hal_tpu.randgen import create_random_alignment

    return create_random_alignment(seed=21, max_genomes=7, min_genomes=6,
                                   min_segments=5, max_segments=25,
                                   min_segment_length=3, max_segment_length=10)


@pytest.mark.parametrize("fixture", ["three_genome", "random"])
def test_scorer_window_equals_jax(tmp_path, fixture):
    """PhyloPScorer(device="cpu").score_window against hal_tpu's scorer with
    the JAX fit and column engine (device="on") and with the numpy fit and
    exact columns (device="off")."""
    from fixtures import three_genome_alignment

    jaln = three_genome_alignment() if fixture == "three_genome" \
        else _random_jax_aln()
    _path, paln = _port_aln(jaln, tmp_path, "w.halz")
    mod = _tree_mod(tmp_path, jaln, 23)
    leaves = [n for n in jaln.genome_names() if jaln.tree.is_leaf(n)]
    ref = "Anc" if fixture == "three_genome" else leaves[0]
    ge = min(int(jaln.open_genome(ref).length), 120)
    for opts in (dict(), dict(mode="CON", dup_type="all", dup_mask="hard")):
        port = phylop.PhyloPScorer(
            paln, phylop.NeutralModel.from_mod_file(mod), device="cpu",
            **opts)
        got = port.score_window(ref, 0, ge)
        assert port._dev is not None and port._col_eng
        for device in ("on", "off"):
            want = jax_phylop.PhyloPScorer(
                jaln, jax_phylop.NeutralModel.from_mod_file(mod),
                device=device, **opts).score_window(ref, 0, ge)
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert (got != 0).any()


def test_scorer_prunes_missing_species_like_jax(tmp_path):
    """Species absent from the alignment are pruned from the model tree,
    leaving unary nodes; the port scores them as hal_tpu does."""
    from fixtures import three_genome_alignment

    jaln = three_genome_alignment()
    _path, paln = _port_aln(jaln, tmp_path, "p.halz")
    p = tmp_path / "ghost.mod"
    p.write_text(gtr_mod_text(
        "((A:0.2,Ghost1:0.2)I:0.1,(B:0.3,Ghost3:0.3)J:0.1)R;", 25))
    port = phylop.PhyloPScorer(paln, phylop.NeutralModel.from_mod_file(str(p)),
                               device="cpu")
    assert port.species == ["A", "B"]
    assert any(len(port.mod.tree.children(n)) == 1
               for n in port.mod.tree.names())
    got = port.score_window("Anc", 0, 30)
    want = jax_phylop.PhyloPScorer(
        jaln, jax_phylop.NeutralModel.from_mod_file(str(p)),
        device="on").score_window("Anc", 0, 30)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert not np.allclose(got, 0.0)


def test_scorer_key_space_fallback_and_other_failures(tmp_path, monkeypatch,
                                                      capsys):
    """Only a refused DFS key space takes the exact column engine (one
    stderr line, the same scores); any other failure of the device column
    engine raises."""
    from fixtures import three_genome_alignment

    from hal_tpu_torch.ops import column_torch

    jaln = three_genome_alignment()
    _path, paln = _port_aln(jaln, tmp_path, "k.halz")
    mod = _tree_mod(tmp_path, jaln, 27)
    want = phylop.PhyloPScorer(paln, phylop.NeutralModel.from_mod_file(mod),
                               device="cpu").score_window("Anc", 0, 30)

    def refuse(*a, **k):
        raise column_torch.KeySpaceError("key space 2^40 >= 2^31")

    monkeypatch.setattr(column_torch, "DeviceColumnEngine", refuse)
    s = phylop.PhyloPScorer(paln, phylop.NeutralModel.from_mod_file(mod),
                            device="cpu")
    capsys.readouterr()
    got = np.concatenate([s.score_window("Anc", 0, 15),
                          s.score_window("Anc", 15, 30)])
    err = capsys.readouterr().err
    assert err.count("device column engine unavailable") == 1
    np.testing.assert_array_equal(got, want)

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(column_torch, "DeviceColumnEngine", broken)
    s = phylop.PhyloPScorer(paln, phylop.NeutralModel.from_mod_file(mod),
                            device="cpu")
    with pytest.raises(RuntimeError, match="illegal memory"):
        s.score_window("Anc", 0, 30)


# ------------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def cli_fixture(tmp_path_factory):
    """A random DNA alignment as halz and a seeded GTR .mod on its tree."""
    from hal_tpu.randgen import create_random_alignment

    d = tmp_path_factory.mktemp("phylop_cli")
    jaln = create_random_alignment(seed=31, max_genomes=6, min_genomes=5,
                                   min_segments=20, max_segments=60,
                                   min_segment_length=4,
                                   max_segment_length=14)
    hal = str(d / "aln.halz")
    jax_save(jaln, hal, fmt="halz")
    mod = d / "aln.mod"
    mod.write_text(gtr_mod_text(jaln.tree.to_newick(), 33))
    leaves = [n for n in jaln.genome_names() if jaln.tree.is_leaf(n)]
    return hal, str(mod), leaves, d


def _near_rounding_boundary(values, prec):
    """Scores within 1e-6 of a rounding boundary of --prec digits."""
    x = np.abs(np.asarray(values)) * 10 ** prec
    return int((np.abs(x - np.floor(x) - 0.5) * 10 ** -prec < 1e-6).sum())


@pytest.mark.parametrize("flags", [[], ["--mode", "CON", "--dupMask", "hard"],
                                   ["--mode", "ACC", "--step", "3"]],
                         ids=["default", "con-hard", "acc-step"])
def test_halPhyloP_cli_cpu_equals_jax(cli_fixture, flags):
    from hal_tpu.tools import halPhyloP as jax_cli
    from hal_tpu_torch.tools import halPhyloP as port_cli

    hal, mod, leaves, d = cli_fixture
    ref = leaves[0]
    name = "_".join(flags) or "default"
    want_p, got_p = str(d / ("jax_%s.wig" % name)), str(d / ("port_%s.wig" % name))
    jax_cli.run(flags + ["--device", "on", hal, ref, mod, want_p])
    before = K.launches()
    port_cli.run(flags + ["--device", "cpu", hal, ref, mod, got_p])
    assert K.launches() == before
    want = open(want_p, "rb").read()
    # the JAX values behind the lines: a value within 1e-6 of a rounding
    # boundary could print either way; none are expected here
    from hal_tpu.storage import open_alignment as jax_open

    ja = jax_open(hal)
    opts = {"--mode": "mode", "--dupMask": "dup_mask"}
    kw = {opts[f]: v for f, v in zip(flags[::2], flags[1::2]) if f in opts}
    sc = jax_phylop.PhyloPScorer(ja, jax_phylop.NeutralModel.from_mod_file(mod),
                                 device="on", **kw)
    g = ja.open_genome(ref)
    vals = np.concatenate([sc.score_window(ref, int(g.seq_start[i]),
                                           int(g.seq_start[i + 1]))
                           for i in range(g.num_sequences)])
    assert _near_rounding_boundary(vals, 3) == 0
    assert want.count(b"fixedStep") == g.num_sequences
    assert open(got_p, "rb").read() == want


def test_halPhyloP_cli_range_and_subtree(cli_fixture):
    """--refSequence/--start/--length and --subtree, against hal_tpu."""
    from hal_tpu.tools import halPhyloP as jax_cli
    from hal_tpu_torch.tools import halPhyloP as port_cli

    hal, mod, leaves, d = cli_fixture
    aln = open_alignment(hal)
    g = aln.open_genome(leaves[1])
    parent = aln.tree.parent(leaves[1])
    flags = ["--refSequence", g.seq_names[-1], "--start", "3", "--length",
             str(g.seq_length(g.num_sequences - 1) - 5), "--subtree", parent]
    jax_cli.run(flags + ["--device", "on", hal, leaves[1], mod,
                         str(d / "jax_sub.wig")])
    port_cli.run(flags + ["--device", "cpu", hal, leaves[1], mod,
                          str(d / "port_sub.wig")])
    want = open(d / "jax_sub.wig", "rb").read()
    assert want.startswith(b"fixedStep chrom=%s start=4 step=1\n"
                           % g.seq_names[-1].encode())
    assert open(d / "port_sub.wig", "rb").read() == want


def _run_port(tool, args, cwd):
    res = subprocess.run([sys.executable, "-m", "hal_tpu_torch.tools." + tool]
                         + args, cwd=cwd, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return res


def test_halPhyloPMP_and_halTreePhyloP_equal_per_run(cli_fixture):
    """halPhyloPMP concatenates one halPhyloP run per sequence, and
    halTreePhyloP writes one halPhyloP run per leaf genome; both pass
    --device on to the port's halPhyloP."""
    from hal_tpu_torch.tools import halPhyloP as port_cli

    hal, mod, leaves, d = cli_fixture
    aln = open_alignment(hal)
    ref = leaves[0]
    g = aln.open_genome(ref)
    parts = []
    for k, seq in enumerate(g.seq_names):
        out = str(d / ("seq%d.wig" % k))
        port_cli.run(["--device", "cpu", "--refSequence", seq, hal, ref, mod,
                      out])
        parts.append(open(out, "rb").read())
    mp_out = str(d / "mp.wig")
    _run_port("halPhyloPMP", ["--device", "cpu", "--numProc", "2", hal, ref,
                              mod, mp_out], REPO)
    assert open(mp_out, "rb").read() == b"".join(parts)

    tree_dir = d / "tree"
    _run_port("halTreePhyloP", ["--device", "cpu", "--numProc", "2", hal,
                                mod, str(tree_dir)], REPO)
    assert sorted(os.listdir(tree_dir)) == sorted(
        "%s_phyloP.wig" % n for n in leaves)
    for leaf in leaves[:2]:
        out = str(d / ("leaf_%s.wig" % leaf))
        port_cli.run(["--device", "cpu", hal, leaf, mod, out])
        assert (open(tree_dir / ("%s_phyloP.wig" % leaf), "rb").read()
                == open(out, "rb").read())


def test_cuda_without_card_raises(cli_fixture, monkeypatch, capsys):
    from hal_tpu_torch.tools import halPhyloP as port_cli

    hal, mod, leaves, d = cli_fixture
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [hal, leaves[0], mod, str(d / "never.wig")]
    with pytest.raises(HalError, match="no CUDA device"):
        port_cli.run(argv)
    assert port_cli.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (d / "never.wig").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        phylop.PhyloPScorer(open_alignment(hal),
                            phylop.NeutralModel.from_mod_file(mod))
    with pytest.raises(ValueError, match="cuda or cpu"):
        phylop.PhyloPScorer(open_alignment(hal),
                            phylop.NeutralModel.from_mod_file(mod),
                            device="on")


@pytest.mark.cuda
def test_cuda_phylop_kernel_equals_plain(tmp_path):
    """The fit kernel and its likelihood entry against the plain version on
    the card: log-likelihoods within rtol 1e-5 of the float64 plain version
    (the float32 one, JAX's arithmetic, is itself up to ~2e-5 off it),
    scores within the float32 tolerance of each other and of the float64
    numpy fit; the fit deterministic, and bit-identical in both launch
    shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pm, _jm, li = models(tmp_path, BINARY8, seed=41)
    pats = patterns(8, 3000, 42)
    for mode, sub in (("CONACC", None), ("CON", None), ("ACC", None),
                      ("NNEUT", None),
                      ("CONACC", frozenset(pm.tree.preorder("I2")))):
        dev = DevicePhyloP(pm, li, mode, sub, device="cuda")
        codes, prog = dev.codes(pats), dev.program()
        rng = np.random.default_rng(43)
        s = torch.from_numpy(rng.uniform(0.1, 3.0, 3000)).float().cuda()
        ss = torch.from_numpy(rng.uniform(0.5, 2.0, 3000)).float().cuda()
        before = pf.phylop_lnl.launches
        got = pf.phylop_lnl(codes, s, ss, prog)
        torch.cuda.synchronize()
        assert pf.phylop_lnl.launches == before + 1
        prog64 = DevicePhyloP(pm, li, mode, sub, dtype=torch.float64,
                              device="cuda").program()
        want = pf.lnl_plain(codes, s.double(), ss.double(), prog64)
        # relative to |lnl| >= 1: the all-missing column's lnl is 0 up to
        # rounding
        rel = ((got.double() - want).abs()
               / want.abs().clamp(min=1)).max().item()
        assert rel <= 1e-5, rel
        before = pf.phylop_fit.launches
        k = dev.score_patterns(pats)
        assert pf.phylop_fit.launches == before + 1
        exact = phylop.score_patterns(pm, li, pats, mode, sub_nodes=sub)
        assert_f32_agree(k, exact, mode)
        # the kernel's and the plain fit's optima are equally good
        fit_k = pf.phylop_fit(codes, prog, mode, bool(sub))
        fit_p = pf.fit_plain(codes, prog, mode, bool(sub))
        at_k = pf.lnl_plain(codes, fit_k[1], fit_k[2], prog)
        at_p = pf.lnl_plain(codes, fit_p[1], fit_p[2], prog)
        assert (at_k - at_p).abs().max().item() < 1e-2
        # both launch shapes give the same bits, and so does a second call
        one = pf._fit_kernel(codes, prog, mode, bool(sub), False)
        two = pf._fit_kernel(codes, prog, mode, bool(sub), True)
        again = pf._fit_kernel(codes, prog, mode, bool(sub), False)
        assert all(torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, k)
                   for a, b, c, k in zip(one, two, again, fit_k))

"""Port of hal_tpu/tools/ancestorsML.py whose Felsenstein pruning pass runs
on a torch device, with --device {cuda,cpu} (default cuda; a declared
divergence: the original runs in numpy on the host).

The operations are the original's, in float64: the leaf likelihoods
(a lowercase base counts as its uppercase base, any other base 0.25 in
every column), per child the Jukes-Cantor matrix P computed by numpy on
the host (_jc_matrix, shipped to the device), M = Lc @ P.T, the child's
message mapped to the parent's positions, L *= contrib and the
renormalisation with its zero guard.  The original maps the message with
a Python loop over the parent's aligned bottom segments; here one pass
does it: marks at the bottom segments' starts, kernels.cummax_i32 for
each position's segment, then gathers through bot_child, top_start and
top_parent_reversed (a reversed block takes its rows backwards and its
columns as [3, 2, 1, 0]).  The scan is int32, so a genome of 2^31 bases
or more raises.  The row sums are written out in numpy's order
((a0 + a1) + a2) + a3.  run() computes the posterior, argmax and
confidence on the device and copies back only the new bases (uint8);
--printWrites counts the changed bases with the same upper-casing as the
original's np.char.upper, on the host in numpy.  --device cuda without a
card raises HalError; nothing falls back to the CPU.

ancestorsML — maximum-likelihood re-estimation of ancestral bases
(reference modify/ancestorsML.cpp: per-site Felsenstein pruning with a
phast substitution model; gated behind ENABLE_PHYLOP).

hal_tpu implements the Felsenstein pruning natively (vectorized over
sites) with a Jukes-Cantor model when no phast .mod is parseable; phast is
not required."""

from __future__ import annotations

import sys

import numpy as np

from hal_tpu_torch.constants import NULL_INDEX
from hal_tpu_torch.tools import HalError, add_storage_options, make_parser, tool_main
from hal_tpu_torch.tools._device import add_device_option, require_device
from hal_tpu_torch.tools._modify_common import open_for_update, save_back

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_MAX_LENGTH = (1 << 31) - 1  # positions and rows are int32


def _jc_matrix(t: float, rate: float = 1.0) -> np.ndarray:
    """Jukes-Cantor transition probabilities."""
    p_same = 0.25 + 0.75 * np.exp(-4.0 * rate * t / 3.0)
    p_diff = 0.25 - 0.25 * np.exp(-4.0 * rate * t / 3.0)
    m = np.full((4, 4), p_diff)
    np.fill_diagonal(m, p_same)
    return m


def _leaf_table():
    """256 x 4 float64: the leaf likelihood row of each byte."""
    import torch

    table = torch.full((256, 4), 0.25, dtype=torch.float64)
    for bi, b in enumerate(BASES):
        for code in (int(b), int(b) + 32):  # upper and lower case
            table[code] = 0.0
            table[code, bi] = 1.0
    return table


def _row_sums(L):
    """Per-row sums of an (n, 4) tensor in numpy's order for a row of 4."""
    return ((L[:, 0] + L[:, 1]) + L[:, 2]) + L[:, 3]


def _as_device(a, device, dtype=None):
    import torch

    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a memory map or a view of one
        a = a.copy()
    t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _check_length(name: str, n: int) -> None:
    if n > _MAX_LENGTH:
        raise HalError("ancestorsML: genome %s has %d bases; the device pass "
                       "indexes positions in int32 (at most %d)"
                       % (name, n, _MAX_LENGTH))


def _child_rows(g, cg, slot: int, n: int, device):
    """For every position of parent g: the row of child cg's message
    (int32, -1 where the bottom segment has no child at `slot`) and
    whether the block is reversed."""
    import torch

    from hal_tpu_torch.ops import kernels

    def unaligned():
        return (torch.full((n,), -1, dtype=torch.int32, device=device),
                torch.zeros(n, dtype=torch.bool, device=device))

    n_bot = g.num_bottom_segments
    if n_bot == 0:
        return unaligned()
    starts = _as_device(np.asarray(g.bot_start[:n_bot + 1]), device,
                        torch.int32)
    keep = starts[1:] > starts[:-1]  # a position lies in a segment of length > 0
    segs = torch.arange(n_bot, dtype=torch.int32, device=device)[keep]
    marks = torch.zeros(n, dtype=torch.int32, device=device)
    marks[starts[:-1][keep].long()] = segs
    j = kernels.cummax_i32(marks).long()
    del marks, segs, keep
    child = _as_device(np.asarray(g.bot_child[:n_bot, slot]), device)[j]
    has = child != NULL_INDEX
    if not bool(has.any()):  # cg's tables go unread; cg may be empty
        return unaligned()
    c = child.clamp_min(0)
    del child
    top_start = _as_device(np.asarray(cg.top_start), device, torch.int32)
    rev = _as_device(np.asarray(cg.top_parent_reversed), device,
                     torch.bool)[c] & has
    lo = starts[j]
    off = torch.arange(n, dtype=torch.int32, device=device) - lo
    span = starts[j + 1] - lo
    del lo, j
    off = torch.where(rev, span - 1 - off, off)
    del span
    rows = torch.where(has, top_start[c] + off, -1)
    return rows, rev


def _likelihoods_for(aln, name: str, device):
    """Per-site conditional likelihoods L[pos, base] (float64, on device)
    of the subtree below each position of genome `name` (Felsenstein
    pruning over whole tensors)."""
    import torch

    device = torch.device(device)
    g = aln.open_genome(name)
    n = g.length
    _check_length(name, n)
    if not aln.tree.children(name):
        bases = _as_device(g.get_dna(0, n), device, torch.int32)
        return _leaf_table().to(device).index_select(0, bases)
    L = torch.ones((n, 4), dtype=torch.float64, device=device)
    for child in aln.tree.children(name):
        cg = aln.open_genome(child)
        slot = aln.tree.child_index(name, child)
        Lc = _likelihoods_for(aln, child, device)
        P = _as_device(_jc_matrix(max(aln.tree.branch_length(child), 1e-5)),
                       device)
        # message per child position: M = Lc @ P.T ; map to parent positions
        M = Lc @ P.T
        del Lc
        rows, rev = _child_rows(g, cg, slot, n, device)
        if M.shape[0]:
            contrib = M.index_select(0, rows.clamp_min(0))
        else:  # an empty child: no row to gather, every position the prior
            contrib = torch.full((n, 4), 0.25, dtype=M.dtype, device=device)
        del M
        # reverse complement: A<->T, C<->G column swap
        flip = rev.nonzero().squeeze(1)
        contrib[flip] = contrib[flip].flip(1)
        del flip, rev
        contrib[rows < 0] = 0.25  # unaligned children contribute prior
        del rows
        L.mul_(contrib)
        del contrib
        # renormalize to avoid underflow
        s = _row_sums(L)
        s[s == 0] = 1.0
        L.div_(s[:, None])
        del s
    return L


def _posterior_calls(L, threshold: float) -> np.ndarray:
    """The new bases (uint8, on the host) from the likelihoods."""
    import torch

    post = L / torch.clamp(_row_sums(L), min=1e-300)[:, None]
    best = torch.argmax(post, dim=1)
    conf = post.gather(1, best[:, None])[:, 0]
    del post
    new = _as_device(BASES, L.device)[best]
    new[conf < threshold] = ord("N")
    return new.cpu().numpy()


def run(argv=None):
    p = make_parser("ancestorsML", "Re-estimate ancestral nucleotides by maximum likelihood")
    p.add_argument("halFile")
    p.add_argument("genome", help="ancestral genome to re-estimate")
    p.add_argument("--model", default="", help="phast .mod file (JC used if absent)")
    p.add_argument("--thresholdN", type=float, default=0.9,
                   help="write N when the best base posterior is below this")
    p.add_argument("--printWrites", action="store_true")
    add_storage_options(p)
    add_device_option(p)
    o = p.parse_args(argv)
    require_device(o.device)
    aln, fmt = open_for_update(o.halFile)
    if not aln.tree.children(o.genome):
        raise HalError("genome %s is not ancestral" % o.genome)
    g = aln.open_genome(o.genome)
    L = _likelihoods_for(aln, o.genome, o.device)
    new = _posterior_calls(L, o.thresholdN)
    del L
    old = g.get_dna(0, g.length)
    up = np.where((old >= 97) & (old <= 122), old - 32, old)
    changed = int((up != new).sum()) if g.length else 0
    g.set_dna(0, new)
    if o.printWrites:
        sys.stderr.write("ancestorsML: rewrote %d/%d bases of %s\n"
                         % (changed, g.length, o.genome))
    save_back(aln, o.halFile, fmt)


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

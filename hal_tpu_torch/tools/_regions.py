"""Batched mapping shared by the port's region and SNP tools
(findRegionsExclusivelyInGroup, halSingleCopyRegionsExtract, hal4dExtract
--conserved, halSnps, halContiguousRegions).  Their originals call
segmap_host.map_source once for each window, sequence or base; here every
interval of one (source, target, dupes, coalescence limit) path goes
through one BatchMapper dispatch on the tool's --device, and nothing maps
on the host."""

from __future__ import annotations

import numpy as np

from hal_tpu_torch.ops import segmap_host as sm
from hal_tpu_torch.ops.liftover_bulk import atomize_by_owner
from hal_tpu_torch.ops.segmap_torch import BatchMapper, start_cap_mult

WINDOW = 1 << 20


def windows(gs: int, ge: int, width: int = WINDOW):
    """(lo, hi) int64 arrays of the originals' window walk over [gs, ge)."""
    lo = np.arange(gs, max(ge, gs), width, dtype=np.int64)
    return lo, np.minimum(lo + width, ge)


def map_by_owner(aln, src: str, tgt: str, lo, hi, *, device,
                 do_dupes: bool = True, coalescence_limit: str | None = None,
                 ordered: bool = False, atomize: bool = True):
    """Fragments of every interval [lo[k], hi[k]) of src mapped to tgt, from
    one BatchMapper dispatch on `device` (owner k is interval k).  The
    mapper builds map_source's paralogy branches (host_paralogies), which
    only a coalescence limit above the MRCA reaches.

    Returns (frags, bounds): an sm.Fragments sorted by owner, owner k's
    rows being frags[bounds[k]:bounds[k + 1]].  atomize: each owner's
    fragments atomized and deduped as map_source's are (the same set; the
    raw device fragments otherwise, duplicates included).  ordered: each
    owner's rows in map_source's order too (BatchMapper.dispatch(ordered=
    True), whose order atomize_by_owner keeps)."""
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    if len(lo) == 0:
        return sm.Fragments.empty(), np.zeros(1, np.int64)
    sg = aln.open_genome(src)
    mapper = BatchMapper(aln, src, tgt, do_dupes=do_dupes,
                         coalescence_limit=coalescence_limit,
                         host_paralogies=True, device=device)
    s_lo, s_hi, t_lo, t_hi, rev, owner = mapper.decode(mapper.dispatch(
        lo, hi, cap_mult=start_cap_mult(sg, lo, hi), ordered=ordered))
    rev = rev.astype(np.uint8)
    if atomize:
        scale = int(max(sg.length, aln.open_genome(tgt).length) + 2)
        s_lo, s_hi, t_lo, t_hi, rev, owner = atomize_by_owner(
            s_lo, s_hi, t_lo, t_hi, rev, owner, scale)
    if not ordered:
        order = np.argsort(owner, kind="stable")
        s_lo, s_hi, t_lo, t_hi, rev, owner = (
            a[order] for a in (s_lo, s_hi, t_lo, t_hi, rev, owner))
    bounds = np.searchsorted(owner, np.arange(len(lo) + 1), side="left")
    return sm.Fragments(s_lo, s_hi, t_lo, t_hi, rev), bounds


def owner_slice(frags: sm.Fragments, bounds, k: int) -> sm.Fragments:
    """Owner k's rows of map_by_owner's result."""
    return frags.select(slice(int(bounds[k]), int(bounds[k + 1])))


def window_counts(mapped, k: int, pos: int, n: int) -> np.ndarray:
    """For each base of owner k's window [pos, pos + n), the number of its
    fragments (map_by_owner's result) whose source interval covers it."""
    frags, bounds = mapped
    a, b = int(bounds[k]), int(bounds[k + 1])
    d = np.zeros(n + 1, np.int64)
    np.add.at(d, frags.src_lo[a:b] - pos, 1)
    np.add.at(d, frags.src_hi[a:b] - pos, -1)
    return np.cumsum(d[:n])

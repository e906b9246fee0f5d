"""The plain references against the port at tiny sizes on the CPU: the
batched mapper against BatchMapper and against per-interval map_source,
the BED reference against Liftover.convert_batched, the MAF reference
against the device column engine with the native assembler."""

import io

import numpy as np
import pytest

from hal_bench import gen, traffic as tr
from hal_bench.port import port_alignment
from hal_bench.reference import mapper, segmap_host
from hal_bench.reference.liftover_bed import lift_bed


def _aln(seed, mean_degree=1.5, dna=False):
    return gen.create_random_alignment(
        seed=seed, max_genomes=10, min_genomes=7, mean_degree=mean_degree,
        max_branch_length=0.9, min_segment_length=20, max_segment_length=30,
        min_segments=300, max_segments=400, store_dna=dna,
        dna_device="cpu" if dna else None)


def _pairs(m):
    a, b = tr.deepest_leaf_pair(m)
    root = m.root_name
    leaf = [n for n in m.genome_names() if m.tree.is_leaf(n)][0]
    # deepest leaves, leaf to root (up only), root to leaf (down only)
    return [(a, b), (leaf, root), (root, leaf)]


def _intervals(m, src, seed, n=300):
    rng = np.random.default_rng(seed)
    length = m.open_genome(src).length
    lo = rng.integers(0, length - 60, n)
    return lo, lo + rng.integers(1, 60, n)


@pytest.mark.parametrize("seed,mean_degree", [(0, 1.5), (1, 1.5), (2, 1.0),
                                              (3, 0.8)])
def test_mapper_equals_batch_mapper_and_map_source(seed, mean_degree):
    from hal_tpu_torch.ops.segmap_torch import BatchMapper

    m = _aln(seed, mean_degree)
    aln = port_alignment(m)
    scale = max(m.open_genome(n).length for n in m.genome_names()) + 2
    for src, tgt in _pairs(m):
        lo, hi = _intervals(m, src, seed)
        want = mapper.canonical(mapper.map_intervals(m, src, tgt, lo, hi),
                                scale)
        bm = BatchMapper(aln, src, tgt, device="cpu")
        got = mapper.canonical(np.stack(bm.decode(bm.dispatch(lo, hi))),
                               scale)
        assert want.shape[1] > 0
        assert mapper.mismatches(want, got) == 0
        for k in range(0, len(lo), 7):
            f = segmap_host.map_source(m, src, lo[k:k + 1], hi[k:k + 1], tgt)
            one = np.stack([f.src_lo, f.src_hi, f.tgt_lo, f.tgt_hi,
                            f.rev.astype(np.int64), np.full(len(f), k)])
            assert mapper.mismatches(mapper.canonical(one, scale),
                                     want[:, want[5] == k]) == 0


def test_mismatches_counts_every_difference():
    m = _aln(4)
    src, tgt = tr.deepest_leaf_pair(m)
    lo, hi = _intervals(m, src, 4)
    scale = 10 ** 7
    want = mapper.canonical(mapper.map_intervals(m, src, tgt, lo, hi), scale)
    bad = want.copy()
    bad[2, 0] += 1
    assert mapper.mismatches(want, bad) == 2
    assert mapper.mismatches(want, want[:, 1:]) == 1
    # a duplicated fragment is the same canonical set
    dup = np.concatenate([want, want[:, :5]], axis=1)
    assert mapper.mismatches(want, mapper.canonical(dup, scale)) == 0


@pytest.mark.parametrize("seed", [0, 5])
def test_bed_reference_equals_convert_batched(seed):
    from hal_tpu_torch.ops.liftover import Liftover

    m = _aln(seed)
    src, tgt = tr.deepest_leaf_pair(m)
    lo, hi = _intervals(m, src, seed, 400)
    names, scores, strands = tr.bed_fields(seed, len(lo))
    strands[::11] = "."
    chrom = m.open_genome(src).seq_names[0]
    lines = [(chrom, int(a), int(b), n, int(s), str(d))
             for a, b, n, s, d in zip(lo, hi, names, scores, strands)]
    text = "".join("%s\t%d\t%d\t%s\t%d\t%s\n" % x for x in lines)
    out = io.StringIO()
    Liftover(port_alignment(m), src, tgt, device="cpu").convert_batched(
        io.StringIO(text), out, batch_size=128)
    want = lift_bed(m, src, tgt, lines)
    assert want and out.getvalue() == want
    assert lift_bed(m, src, tgt, lines, do_dupes=False) != want


def test_maf_reference_equals_device_engine_and_native_assembly():
    from hal_tpu_torch.ops.column_native import maybe_native_exporter
    from hal_tpu_torch.ops.column_torch import DeviceColumnEngine

    from hal_bench.reference.column_exact import iter_slices_exact
    from hal_bench.reference.maf_builder import MafBlockBuilder

    m = _aln(11, dna=True)
    aln = port_alignment(m)
    ref = [n for n in m.genome_names() if m.tree.is_leaf(n)][0]
    eng = DeviceColumnEngine(aln, ref, device="cpu")
    length = m.open_genome(ref).length
    for gs, ge in [(0, length // 3), (length // 5, length - 3)]:
        ex = maybe_native_exporter(aln, ref)
        got = eng.export_native(ex, gs, ge) + ex.finish()
        b = MafBlockBuilder(m, ref, ucsc_names=True)
        blocks = list(b.feed(iter_slices_exact(m, ref, gs, ge)))
        last = b.flush_end()
        want = "".join(x + "\n" for x in blocks + ([last] if last else []))
        assert got and got == want.encode()

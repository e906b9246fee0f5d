"""Driver of hal_tpu_torch.ops.segmap_torch.BatchMapper, the bulk mapping
entry that every lifting tool of the port shares (halLiftover through
Liftover._mapped_chunks, the analysis, region and editing tools).

The mapper, with its path tables, is built in set-up, as a long-lived tool
holds it.  A request is one batch of intervals of the source genome,
dispatched with the starting capacity the tools give it
(start_cap_mult) and decoded to numpy fragments in host memory.  Batch
k+1 is dispatched before batch k is decoded, as _mapped_chunks does.

Correct: the fragments of every sampled request, atomized per interval and
deduplicated (reference.mapper.canonical), equal the plain mapper's.
Control: the mapper with paralogies not traversed (do_dupes=False), where
the configuration traverses them.
"""

from __future__ import annotations

import numpy as np

from hal_bench import traffic as tr
from hal_bench.port import port_alignment
from hal_bench.reference import mapper as ref

PIPELINE = 2


class Driver:
    LIMITS = {"fragments_mismatched": 0}

    def __init__(self, model, traffic, seed, device, control=False):
        self.model = model
        self.seed = seed
        self.device = device
        self.control = control
        self.n = int(traffic["intervals"])
        self.src, self.tgt = tr.deepest_leaf_pair(model)
        g = model.open_genome(self.src)
        self.lo, self.hi = tr.interval_pool(seed, int(g.length), traffic)
        self.scale = max(int(model.open_genome(n).length)
                         for n in model.genome_names()) + 2

    def setup(self):
        from hal_tpu_torch.ops import segmap_torch

        self._segmap = segmap_torch
        self.aln = port_alignment(self.model)
        self.src_genome = self.aln.open_genome(self.src)
        self.mapper = segmap_torch.BatchMapper(self.aln, self.src, self.tgt,
                                  do_dupes=not self.control,
                                  device=self.device)

    def inputs(self, k):
        s = tr.pool_slice(self.seed, k, len(self.lo), self.n)
        return self.lo[s], self.hi[s]

    def units(self, inp):
        return len(inp[0])

    def submit(self, inp):
        lo, hi = inp
        cap = self._segmap.start_cap_mult(self.src_genome, lo, hi)
        return self.mapper.dispatch(lo, hi, cap_mult=cap)

    def complete(self, handle):
        return self.mapper.decode(handle)

    def release(self):
        self.mapper = self.aln = self.src_genome = None

    def check(self, inp, out):
        want = ref.canonical(ref.map_intervals(self.model, self.src,
                                               self.tgt, *inp), self.scale)
        got = ref.canonical(np.stack([np.asarray(a, np.int64) for a in out]),
                            self.scale)
        return {"fragments_mismatched": ref.mismatches(want, got)}

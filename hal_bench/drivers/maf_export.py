"""Driver of hal2maf's device engine: one reference window exported as the
CLI's device path exports a region, column_torch.DeviceColumnEngine
.export_native through a column_native.NativeMafExporter of its own, then
the exporter's finish.

The engine (its traversal programs, level tables and host twin) is built
in set-up.  A request is one window of the traffic's width at a
seed-drawn, unaligned start, exported as a hal2maf run over that one
region would: the MAF entry machine keeps its entries from one region to
the next, so each request gets a new exporter and its bytes depend on
nothing but the window.  The engine sizes its capacities on the first
window of a width (warm-up) and re-sizes on overflow.  All genomes are in
scope.

Correct: the MAF bytes of every sampled window equal, line for line, the
plain reference's (the frozen exact column walker and block builder,
reference.column_exact and reference.maf_builder).  Control: duplications
left out (no_dupes), where the configuration keeps them.
"""

from __future__ import annotations

from hal_bench import traffic as tr
from hal_bench.port import port_alignment
from hal_bench.reference.column_exact import iter_slices_exact
from hal_bench.reference.maf_builder import MafBlockBuilder

PIPELINE = 1
MAX_BLOCK_LEN = 1000  # hal2maf's default --maxBlockLen


class Driver:
    LIMITS = {"maf_lines_differing": 0}

    def __init__(self, model, traffic, seed, device, control=False):
        self.model = model
        self.seed = seed
        self.device = device
        self.control = control
        self.width = int(traffic["window"])
        self.ref = tr.longest_leaf(model)
        self.length = int(model.open_genome(self.ref).length)

    def setup(self):
        from hal_tpu_torch.ops import column_native
        from hal_tpu_torch.ops.column_torch import DeviceColumnEngine

        if not column_native.available():
            raise RuntimeError("the native MAF assembler is not available")
        self._native = column_native
        self.aln = port_alignment(self.model)
        self.engine = DeviceColumnEngine(self.aln, self.ref,
                                         no_dupes=self.control,
                                         device=self.device)

    def inputs(self, k):
        gs = tr.window_start(self.seed, k, self.length, self.width)
        return gs, gs + self.width

    def units(self, inp):
        return inp[1] - inp[0]

    def submit(self, inp):
        ex = self._native.maybe_native_exporter(
            self.aln, self.ref, no_dupes=self.control,
            max_block_len=MAX_BLOCK_LEN)
        try:
            return self.engine.export_native(ex, *inp) + ex.finish()
        finally:
            ex.close()

    def complete(self, handle):
        return handle

    def release(self):
        self.engine = self.aln = None

    def check(self, inp, out):
        builder = MafBlockBuilder(self.model, self.ref,
                                  max_block_len=MAX_BLOCK_LEN,
                                  ucsc_names=True)
        blocks = list(builder.feed(iter_slices_exact(self.model, self.ref,
                                                     *inp)))
        last = builder.flush_end()
        if last:
            blocks.append(last)
        want = "".join(b + "\n" for b in blocks).encode().splitlines()
        got = out.splitlines()
        differ = sum(a != b for a, b in zip(want, got))
        return {"maf_lines_differing": differ + abs(len(want) - len(got))}

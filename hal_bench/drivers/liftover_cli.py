"""Driver of halLiftover's entry: hal_tpu_torch.ops.liftover.Liftover
.convert_batched over in-memory BED6 text, as the halLiftover CLI calls it
with its default --batchSize.

The Liftover is built in set-up (the alignment open, as a CLI run has it).
A request is one call: BED text in, BED text out; the call builds its own
segment mapper, maps the chunk on the device and runs the per-line host
pipeline, as a CLI run over that many lines does.

Correct: the BED text of every sampled request equals, line for line, what
the plain reference (reference.liftover_bed) writes for the same lines.
Control: paralogies not traversed (traverse_dupes=False), where the
configuration traverses them.
"""

from __future__ import annotations

import io

from hal_bench import traffic as tr
from hal_bench.port import port_alignment
from hal_bench.reference.liftover_bed import lift_bed

PIPELINE = 1


class Driver:
    LIMITS = {"bed_lines_differing": 0}

    def __init__(self, model, traffic, seed, device, control=False):
        self.model = model
        self.seed = seed
        self.device = device
        self.control = control
        self.n = int(traffic["lines"])
        self.batch_size = int(traffic["batch_size"])
        self.src, self.tgt = tr.deepest_leaf_pair(model)
        g = model.open_genome(self.src)
        lo, hi = tr.interval_pool(seed, int(g.length), traffic)
        names, scores, strands = tr.bed_fields(seed, len(lo))
        # the generator makes one sequence a genome
        chrom = g.seq_names[0]
        self.lines = [(chrom, int(a), int(b), n, int(s), str(d)) for
                      a, b, n, s, d in zip(lo, hi, names, scores, strands)]
        self.text = ["%s\t%d\t%d\t%s\t%d\t%s\n" % x for x in self.lines]

    def setup(self):
        from hal_tpu_torch.ops.liftover import Liftover

        self.aln = port_alignment(self.model)
        self.lift = Liftover(self.aln, self.src, self.tgt,
                             traverse_dupes=not self.control,
                             device=self.device)

    def inputs(self, k):
        return tr.pool_slice(self.seed, k, len(self.lines), self.n)

    def units(self, inp):
        return inp.stop - inp.start

    def submit(self, inp):
        out = io.StringIO()
        self.lift.convert_batched(io.StringIO("".join(self.text[inp])), out,
                                  batch_size=self.batch_size)
        return out.getvalue()

    def complete(self, handle):
        return handle

    def release(self):
        self.lift = self.aln = None

    def check(self, inp, out):
        want = lift_bed(self.model, self.src, self.tgt,
                        self.lines[inp]).splitlines()
        got = out.splitlines()
        differ = sum(a != b for a, b in zip(want, got))
        return {"bed_lines_differing": differ + abs(len(want) - len(got))}

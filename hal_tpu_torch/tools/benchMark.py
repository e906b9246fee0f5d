"""Port copy of hal_tpu/tools/benchMark.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

benchMark — storage parameter sweep
(reference benchmarks/benchMark.py:23-50: times generation + consumption
across hdf5 chunk sizes x compression levels; prints
`chunk, comp, time(gen), time(cons), fsize(k)`)."""

from __future__ import annotations

import os
import sys
import tempfile
import time

from hal_tpu_torch.randgen import create_random_alignment
from hal_tpu_torch.storage import open_alignment as _open, save_alignment
from hal_tpu_torch.tools import make_parser, tool_main


def _du(path):
    if os.path.isdir(path):
        return sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(path) for f in fs)
    return os.path.getsize(path)


def run(argv=None):
    p = make_parser("benchMark", "Sweep storage parameters, timing create+read")
    p.add_argument("--chunks", default="1000,10000,100000")
    p.add_argument("--compressions", default="0,2,5")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--maxGenomes", type=int, default=6)
    p.add_argument("--maxSegments", type=int, default=200)
    p.add_argument("--formats", default="hdf5,halz")
    o = p.parse_args(argv)
    aln = create_random_alignment(seed=o.seed, max_genomes=o.maxGenomes,
                                  min_segments=10, max_segments=o.maxSegments,
                                  min_segment_length=10, max_segment_length=100)
    tmp = tempfile.mkdtemp(prefix="halbench_")
    sys.stdout.write("format, chunk, comp, time(gen), time(cons), fsize(k)\n")
    for fmt in o.formats.split(","):
        sweeps = [(int(c), int(z)) for c in o.chunks.split(",")
                  for z in o.compressions.split(",")] if fmt == "hdf5" else [(0, 0)]
        for chunk, comp in sweeps:
            path = os.path.join(tmp, "b_%s_%d_%d.%s" % (fmt, chunk, comp,
                                                        "hal" if fmt == "hdf5" else "halz"))
            t0 = time.time()
            kw = dict(fmt=fmt)
            if fmt == "hdf5":
                kw.update(chunk=chunk, compression=comp)
            save_alignment(aln, path, **kw)
            t_gen = time.time() - t0
            t0 = time.time()
            b = _open(path)
            for n in b.genome_names():
                g = b.open_genome(n)
                _ = g.top_start.sum() + g.bot_start.sum()
                if g.dna.size:
                    _ = int(g.dna[:: max(len(g.dna) // 100, 1)].sum())
            t_cons = time.time() - t0
            sys.stdout.write("%s, %d, %d, %.3f, %.3f, %d\n"
                             % (fmt, chunk, comp, t_gen, t_cons, _du(path) // 1024))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

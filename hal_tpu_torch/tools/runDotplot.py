"""Port copy of hal_tpu/tools/runDotplot.py (numpy only; imports pointing
at hal_tpu_torch; its jobs run the port's halStats and halLiftover), with
one declared divergence: --device {cuda,cpu} (default cuda), passed to
its halLiftover job, which then maps on that device.  The TSV is the
original's.

runDotplot — dotplot points from a liftover PSL
(reference extra/runDotplot.py: liftover -> PSL -> R dotplot; here the
PSL is produced natively and points are emitted as TSV, with a PNG when
matplotlib is importable)."""

from __future__ import annotations

import subprocess
import sys
import tempfile

from hal_tpu_torch.tools import make_parser, tool_main
from hal_tpu_torch.tools._device import add_device_option, require_device


def run(argv=None):
    p = make_parser("runDotplot", "Generate dotplot points for two genome sequences")
    p.add_argument("hal")
    p.add_argument("srcGenome")
    p.add_argument("srcChrom")
    p.add_argument("tgtGenome")
    p.add_argument("--out", default="stdout", help="tsv output (or stdout)")
    p.add_argument("--png", default="", help="optional PNG path (needs matplotlib)")
    add_device_option(p)
    o = p.parse_args(argv)
    require_device(o.device)

    with tempfile.NamedTemporaryFile("w", suffix=".bed", delete=False) as bed:
        proc = subprocess.run([sys.executable, "-m", "hal_tpu_torch.tools.halStats",
                               o.hal, "--chromSizes", o.srcGenome],
                              capture_output=True, text=True, check=True)
        size = dict(l.split("\t") for l in proc.stdout.splitlines())[o.srcChrom]
        bed.write("%s\t0\t%s\n" % (o.srcChrom, size))
        bed_path = bed.name
    psl = subprocess.run([sys.executable, "-m", "hal_tpu_torch.tools.halLiftover",
                          o.hal, o.srcGenome, bed_path, o.tgtGenome, "stdout",
                          "--outPSL", "--device", o.device],
                         capture_output=True, text=True, check=True)
    out = sys.stdout if o.out in ("stdout", "-") else open(o.out, "w")
    pts = []
    out.write("qName\tqPos\ttName\ttPos\n")
    for line in psl.stdout.splitlines():
        f = line.split("\t")
        if len(f) < 21:
            continue
        sizes = [int(x) for x in f[18].rstrip(",").split(",")]
        q_starts = [int(x) for x in f[19].rstrip(",").split(",")]
        t_starts = [int(x) for x in f[20].rstrip(",").split(",")]
        for s, q, t in zip(sizes, q_starts, t_starts):
            out.write("%s\t%d\t%s\t%d\n" % (f[9], q, f[13], t))
            pts.append((q, t))
    if o.png:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            xs, ys = zip(*pts) if pts else ([], [])
            plt.figure(figsize=(6, 6))
            plt.scatter(xs, ys, s=1)
            plt.xlabel("%s.%s" % (o.srcGenome, o.srcChrom))
            plt.ylabel(o.tgtGenome)
            plt.savefig(o.png, dpi=150)
        except ImportError:
            sys.stderr.write("runDotplot: matplotlib not available; skipped PNG\n")


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

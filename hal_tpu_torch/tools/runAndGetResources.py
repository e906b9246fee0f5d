"""Port copy of hal_tpu/tools/runAndGetResources.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

runAndGetResources — time + peak RSS capture for a command
(reference benchmarks/runAndGetResources.py, psutil-based)."""

from __future__ import annotations

import resource
import subprocess
import sys
import time

from hal_tpu_torch.tools import make_parser, tool_main


def run(argv=None):
    p = make_parser("runAndGetResources", "Run a command, print (time, max RSS kb)")
    p.add_argument("command", nargs=argparse_REMAINDER_sentinel())
    o = p.parse_args(argv)
    t0 = time.time()
    proc = subprocess.run(" ".join(o.command), shell=True)
    dt = time.time() - t0
    rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    sys.stdout.write("(%.3f, %d)\n" % (dt, rss))
    if proc.returncode != 0:
        sys.exit(proc.returncode)


def argparse_REMAINDER_sentinel():
    import argparse

    return argparse.REMAINDER


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

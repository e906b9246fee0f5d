"""Run one cell of the benchmark of hal_tpu_torch (the PyTorch and CUDA
port) once, on the CUDA devices of this machine:

    python hal_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The run makes the cell's alignment and requests from the seed, builds and
warms the entry the cell drives (set-up), measures for `--seconds`,
checks a sample of the window's outputs against the plain reference
(hal_bench/reference), and prints one JSON object as the last line of
standard output: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (spans, counters and the profiler's
device trace).  The numbers compared with the reference and their limits
are the last lines of standard error and the result's last key.

It exits with an error, and prints no result, without a CUDA device, with
fewer devices than the cell asks for, or when the process holds JAX, the
JAX package or its scripts once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# PyTorch's own kernel cache (jiterator) in a fixed place inside the
# checkout; the port's nvcc and g++ builds go to hal_tpu_torch/build/
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                      os.path.join(ROOT, ".bench_cache", "torch_kernels"))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from hal_bench import harness

    chips = int(harness.cell_entry(a.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write("hal_bench: the cell needs %d CUDA device(s); "
                         "found %d\n" % (chips, torch.cuda.device_count()
                                         if torch.cuda.is_available() else 0))
        return 2
    result = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                              t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        sys.stderr.write("hal_bench: the process holds %s\n" % ", ".join(bad))
        return 3
    lat = result.pop("latencies_ms")
    sys.stderr.write("latencies_ms %s\n" % " ".join("%.1f" % x for x in lat))
    for name, c in result["checks"].items():
        sys.stderr.write("check %s %d limit %d (%d requests)\n"
                         % (name, c["value"], c["limit"], c["requests"]))
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of a cell's correctness check, on the card at the cell's own
size: the cell's driver with one guarantee of the configuration broken
(paralogies not traversed, duplications left out; see each driver's
docstring), checked against the same reference as the timed path.  Each
seed's run has to come out not correct.  With --sound, each seed is also
run as the benchmark runs it, in the same process, for the readings of
sound runs.  The benchmark's own runs never run it.

    python hal_bench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10 [--sound]

Prints one JSON line a run: the workload, seed, kind, correct and the
numbers compared.
"""

import time

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sound", action="store_true")
    a = p.parse_args(argv)

    import torch

    from hal_bench import harness

    if not torch.cuda.is_available():
        sys.stderr.write("hal_bench control: no CUDA device\n")
        return 2
    kinds = ([False] if a.sound else []) + [True]
    for seed in (int(s) for s in a.seeds.split(",")):
        for control in kinds:
            r = harness.run_cell(a.workload, seed, a.seconds, False,
                                 t_start=time.perf_counter(),
                                 control=control)
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "kind": "control" if control else "sound",
                              "correct": r["correct"],
                              "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

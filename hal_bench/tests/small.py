"""Tiny sizes of the benchmark's cells for the CPU tests: the same
generator, traffic and drivers with fewer segments, intervals and
columns."""

SMALL_2K = {"min_segments": 300, "max_segments": 340}
CONFIG = {"lift.bulk-1m": SMALL_2K, "lift.cli-16k": SMALL_2K,
          "maf.window-4m": {"min_segments": 2048, "max_segments": 2100}}
TRAFFIC = {"lift.bulk-1m": {"intervals": 512, "pool": 4096},
           "lift.cli-16k": {"lines": 256, "pool": 4096, "batch_size": 256},
           "maf.window-4m": {"window": 50000}}
CELLS = tuple(CONFIG)


def run_small(cell, seed, *, seconds=0.5, trace=False, control=False,
              device="cpu"):
    import time

    from hal_bench import harness

    return harness.run_cell(cell, seed, seconds, trace,
                            t_start=time.perf_counter(), device=device,
                            control=control, config_patch=CONFIG[cell],
                            traffic_patch=TRAFFIC[cell])

"""hal_tpu_torch — hal_tpu's device paths (batched liftover, alignment
depth, the hal2maf column engine, the phyloP fit, the sharded steps) in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package hal_tpu stays the reference.  This package imports
nothing of it and never imports jax: it keeps its own numpy-only copies of
the host modules it needs, each named after the module it copies and held
equal to it by tests/test_torch_host_copies.py.  Module names mirror
hal_tpu's so each counterpart is easy to find:

  constants, dna, tree, genome, alignment, randgen
                        copies of the genome model and its random fixtures
  storage/              copies of open_alignment / save_alignment (halz,
                        mmap, HDF5 with h5py imported lazily; no URLs)
  io/bed.py             copy of read_bed, BedLine, PSLInfo
  ops/segmap_host.py    copy of the host mapper and Fragments
  ops/tables.py         numpy host helpers of segmap_jax (copies)
  ops/kernels.py        the CUDA kernels' wrappers + plain versions
                        (hal_tpu/ops/pallas_kernels.py)
  ops/segmap_torch.py   the batched segment mapper (ops/segmap_jax.py)
  ops/liftover_bulk.py  bulk BED liftover: the host halves copied, the
                        device branches on the torch mapper
  ops/liftover.py       a copy of hal_tpu's Liftover whose
                        convert_batched runs the torch mapper
  ops/depth.py, ops/column_torch.py
                        the depth engine and the device column engine
                        (ops/depth.py, ops/column_jax.py)
  phylop.py             copy of the phyloP host side; PhyloPScorer runs
                        its columns and fits on a torch device
  ops/phylop_fit.py     the fit's edge program, plain version and kernel
                        wrappers (phylop_jax.py's traced program)
  phylop_torch.py       DevicePhyloP (phylop_jax.py)
  parallel/mp.py        copy of the process-parallel helpers
  io/bbi.py, assemblyhub.py, blockviz.py, ops/{lod,rearrangement}.py
                        copies of the assembly hub's writers, track
                        generators, LOD extraction and browser queries
  ops/liftover_baseline.py
                        copy of the C++ single-core liftover anchor's
                        binding (its library built at first use)
  parallel/mesh.py      a mesh of P processes x L local shards and its
                        collectives over torch.distributed (jax.sharding)
  parallel/sharded.py, parallel/ring_sharded.py, parallel/distributed.py
                        the sharded steps (hal_tpu/parallel/*)
  graft_entry.py        entry() and dryrun_multichip (__graft_entry__.py)
  tools/__init__.py     copy of the tools' parser and error conventions
  tools/*.py            the CLIs, with --device {cuda,cpu}
  csrc/*.cu             the CUDA sources, built by ops/_build.py

When the environment variable HAL_TPU_TORCH_LAUNCH_LOG names a file, every
process that imports this package appends one JSON line to it at exit:
{"argv", "pid", "start", "end" (wall-clock seconds), "launches"}, where
launches is hal_tpu_torch.ops.kernels.launches() if the process imported
the kernels' module, else null (it launched none).  A tool that runs the
port's tools as jobs in other processes (hal2assemblyHub, halLodBenchmark,
hal2mafMP) sets it to see each job's seconds and which kernels it launched.
"""

import atexit as _atexit
import os as _os
import time as _time

LAUNCH_LOG_ENV = "HAL_TPU_TORCH_LAUNCH_LOG"


def _log_process(path: str, start: float) -> None:
    import json
    import sys

    kernels = sys.modules.get("hal_tpu_torch.ops.kernels")
    line = json.dumps({"argv": sys.argv, "pid": _os.getpid(), "start": start,
                       "end": _time.time(),
                       "launches": kernels.launches() if kernels else None})
    with open(path, "a") as f:  # one short append a process
        f.write(line + "\n")


if _os.environ.get(LAUNCH_LOG_ENV):
    _atexit.register(_log_process, _os.environ[LAUNCH_LOG_ENV], _time.time())


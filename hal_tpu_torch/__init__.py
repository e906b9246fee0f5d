"""hal_tpu_torch — hal_tpu's device paths (batched liftover, alignment
depth, the hal2maf column engine, the phyloP fit) in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

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
  tools/__init__.py     copy of the tools' parser and error conventions
  tools/*.py            the CLIs, with --device {cuda,cpu}
  csrc/*.cu             the CUDA sources, built by ops/_build.py
"""

"""The port of hal_tpu.parallel: the sharded steps over torch.distributed
(mesh, sharded, ring_sharded, distributed) and a copy of the
process-parallel helpers (mp)."""

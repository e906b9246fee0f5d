"""Process-parallel helpers of the port (copies of hal_tpu.parallel's
host modules)."""

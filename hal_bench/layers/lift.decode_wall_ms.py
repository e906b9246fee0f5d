"""lift.decode_wall_ms: host milliseconds a request spends in
segmap_torch.BatchMapper.decode (the overflow check and capacity retries,
the fragments' copy to the host and their numpy conversion), its wait on
the device included."""

WRAPS = [("hal_tpu_torch.ops.segmap_torch", "BatchMapper.decode")]


def read(run):
    return run.per_request_ms(run.span_s("BatchMapper.decode"))

"""lift.cap_sizing_ms: host milliseconds a request spends choosing the
mapper's starting capacity (segmap_torch.start_cap_mult: a host
searchsorted of every interval's ends in the source genome's segment
grids), as the batch driver and Liftover._mapped_chunks call it.  Both
module attributes are wrapped; a call goes through one of them, and both
record spans of the one name."""

WRAPS = [("hal_tpu_torch.ops.segmap_torch", "start_cap_mult"),
         ("hal_tpu_torch.ops.liftover", "start_cap_mult")]


def read(run):
    return run.per_request_ms(run.span_s("start_cap_mult"))

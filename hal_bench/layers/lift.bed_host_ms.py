"""lift.bed_host_ms: host milliseconds a request spends in halLiftover's
BED front end (ops/liftover.Liftover.convert_batched: read_bed, the
interval enumeration, the per-owner atomize of _chunk_cache, the per-line
visit_line and _emit), taken as the request's time less the time inside
the segment mapper: its construction, dispatch and decode, and the
capacity sizing (start_cap_mult) that _mapped_chunks calls."""

_M = "hal_tpu_torch.ops.segmap_torch"
WRAPS = [(_M, "BatchMapper.__init__"), (_M, "BatchMapper.dispatch"),
         (_M, "BatchMapper.decode"),
         ("hal_tpu_torch.ops.liftover", "start_cap_mult")]


def read(run):
    inside = sum(run.span_s(w[1]) for w in WRAPS)
    return run.per_request_ms(run.request_time_s() - inside)

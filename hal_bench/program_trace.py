"""The port's own spans and counters (hal_tpu_torch.tracing) in a traced
run: the per-layer readers that read them import this module, and only
they, so tracing is on in traced runs alone, from the readers' load after
warm-up to the first harvest.

harvest(run), once a run, takes what the tracer recorded, turns it off,
clips the spans to the window and appends them to run.spans, beside the
spans the harness's wrappers record: the breakdown's idle gaps then name
the innermost step inside the port.  A checkout whose port has no tracer
records nothing, and the readers return None.
"""

from __future__ import annotations

try:
    from hal_tpu_torch import tracing
except ImportError:     # a port without the tracer
    tracing = None

# device activities that are copies, not kernels
COPIES = ("Memcpy", "Memset")


def enable() -> None:
    """Tracing on, with nothing left over from an earlier run of the same
    process; every reader calls it when it is loaded."""
    if tracing is not None:
        tracing.take()
        tracing.enable()


enable()


def harvest(run) -> tuple[list, dict]:
    """(spans clipped to the window, counters) of the port's tracer for
    this run; the spans are appended to run.spans on the first call."""
    got = getattr(run, "program_trace", None)
    if got is None:
        spans, counts = [], {}
        if tracing is not None:
            spans, counts = tracing.take()
            tracing.disable()
        spans = [(n, max(s, run.w0), min(e, run.w1)) for n, s, e in spans
                 if e > run.w0 and s < run.w1]
        run.spans.extend(spans)
        got = run.program_trace = (spans, counts)
    return got


def span_s(run, *names: str) -> float | None:
    """Seconds of the window in the port's spans `names`; None where the
    port recorded none of them."""
    spans, _counts = harvest(run)
    if not any(n in names for n, _s, _e in spans):
        return None
    return sum(e - s for n, s, e in spans if n in names)


def per_request_ms(run, *names: str) -> float | None:
    s = span_s(run, *names)
    return None if s is None else run.per_request_ms(s)


def counter(run, name: str) -> int | None:
    return harvest(run)[1].get(name)


def device_kernels(run) -> int | None:
    """Device kernels of the window (activities other than copies); None
    without a device trace."""
    if run.device is None:
        return None
    return sum(1 for n, _s, _e in run.device
               if not any(c in n for c in COPIES))

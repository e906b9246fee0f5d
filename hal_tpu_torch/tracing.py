"""Host spans and counters recorded inside the port, off unless a caller
turns them on.

    from hal_tpu_torch import tracing

    tracing.enable()
    with tracing.span("column.drain"):
        ...
    if tracing.on:
        tracing.count("column.frag_cols", int(tots.sum()))
    spans, counts = tracing.take()

A span is (name, start, end) on `clock`, time.perf_counter, the clock a
caller's own host timings and a device trace tied to them use; it is
recorded when its block ends, an exception included.  A counter adds up
the numbers given under its name.  take() hands both over and clears
them.

Off, span() returns one shared no-op context and count() returns at once;
call sites compute a counter's value only when `on` is set.  A span reads
nothing from the device (no synchronize, no .item()), so the device's
timeline is the same with tracing on or off.  Recording is for one host
thread: spans of that thread nest.
"""

from __future__ import annotations

import contextlib
import time

on = False
clock = time.perf_counter

_spans: list[tuple[str, float, float]] = []
_counts: dict[str, int] = {}


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = clock()

    def __exit__(self, *exc):
        _spans.append((self.name, self.t0, clock()))
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records (name, start, end) when tracing is on."""
    return _Span(name) if on else _OFF


def count(name: str, n: int) -> None:
    """Adds n to counter `name` when tracing is on."""
    if on:
        _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def take() -> tuple[list[tuple[str, float, float]], dict[str, int]]:
    """The spans and counters recorded so far, which are then cleared."""
    spans, counts = list(_spans), dict(_counts)
    _spans.clear()
    _counts.clear()
    return spans, counts

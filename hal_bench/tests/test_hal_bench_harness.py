"""The harness's arithmetic on a made-up run: rates over the window, the
device time of kernels and of copies apart, busy and idle time from a device trace, and the idle time by the
innermost host span open while the device was idle."""

import pytest

from hal_bench import harness
from hal_bench.harness import Run


def _run():
    r = Run(setup_s=3.0, w0=0.0, w1=10.0,
            records=[(k, k * 0.5, k * 0.5 + 1.0 + 0.1 * k, 100)
                     for k in range(19)])
    r.spans = [("outer", 1.0, 9.0), ("inner", 2.0, 4.0), ("inner", 5.0, 6.0)]
    r.device = [("k1", 0.5, 1.5), ("k2", 3.0, 3.5), ("k3", 5.5, 7.0),
                ("k2", 3.2, 3.4)]
    return r


def test_busy_idle_and_breakdown():
    r = _run()
    assert r.busy_s() == pytest.approx(3.0)
    assert r.idle_pct() == pytest.approx(70.0)
    b = r.breakdown()
    assert dict(map(tuple, b["device_ops"])) == pytest.approx(
        {"k1": 1.0, "k2": 0.7, "k3": 1.5})
    assert dict(map(tuple, b["idle_gaps"])) == pytest.approx(
        {"outer": 3.5, "inner": 2.0, "harness loop": 1.5})
    assert r.span_s("inner") == pytest.approx(3.0)


def test_end_to_end_readers():
    r = _run()
    rate = harness.load_module("end_to_end", "intervals_per_s").read(r)
    assert rate == pytest.approx(1900 / 10.0)
    assert harness.load_module("end_to_end", "setup_s").read(r) == 3.0


def test_reservoir_is_drawn_from_the_seed():
    a, b = harness.Reservoir(2, 5), harness.Reservoir(2, 5)
    for k in range(50):
        a.offer(k, k)
        b.offer(k, k)
    assert a.items == b.items and len(a.items) == 2


def test_device_time_of_kernels_and_copies_apart():
    r = _run()
    r.device += [("Memcpy DtoH (Device -> Pageable)", 8.0, 8.5),
                 ("Memset (Device)", 9.0, 9.1)]
    kern = harness.load_module("layers", "lift.map_device_ms").read(r)
    copy = harness.load_module("layers", "lift.copy_device_ms").read(r)
    assert kern == pytest.approx(1e3 * 3.2 / 19)
    assert copy == pytest.approx(1e3 * 0.6 / 19)

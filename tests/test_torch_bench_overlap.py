"""The port's benchOverlap (hal_tpu_torch.tools.benchOverlap) on the CPU,
held against hal_tpu.tools.benchOverlap run with the same arguments: the
same JSON keys, wire_mb and iters (the times are the host's own and are not
compared); the overlapped schedule's drained wires equal the serial
schedule's for the same seeds, bit for bit.  The card's stream schedule is
a test marked cuda."""

import json

import numpy as np
import pytest
import torch

from hal_tpu_torch.tools import HalError
from hal_tpu_torch.tools import benchOverlap as port_tool

ARGS = ["--mb", "0.05", "--iters", "3", "--matmul", "32", "--chains", "2"]


def _json_line(out: str) -> dict:
    lines = [x for x in out.splitlines() if x.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


def test_bench_overlap_json_equals_jax(capsys):
    from hal_tpu.tools import benchOverlap as jax_tool

    jax_tool.main(ARGS)
    cap = capsys.readouterr()
    want = _json_line(cap.out)
    port_tool.run(ARGS + ["--device", "cpu"])
    cap = capsys.readouterr()
    got = _json_line(cap.out)
    assert list(got) == list(want)
    assert got["wire_mb"] == want["wire_mb"] and got["iters"] == want["iters"]
    assert got["verdict"] in ("overlaps", "serializes")
    for line in ("compute-only:", "drain-only:", "serial (compute all, "
                 "drain all):", "overlapped (drain thread):", "verdict: "
                 "transfer", "wires checked"):
        assert line in cap.err, line


def _schedules_agree(device):
    s = port_tool.Schedules(torch.device(device), 5000, 24, 2)
    seeds = [0, 3, 250]
    _t, serial, s_heads = s.serial(seeds)
    _t, over, o_heads = s.overlapped(seeds)
    assert len(over) == len(serial) == len(seeds)
    for a, b, ha, hb, k in zip(serial, over, s_heads, o_heads, seeds):
        assert a.device.type == b.device.type == "cpu"
        assert ha.item() == hb.item()
        assert np.array_equal(a.numpy(), b.numpy()), k
        port_tool.check_wire(b, hb, "overlapped")
        # k + arange to float32 precision (the clamped base is <= 1e-3)
        assert abs(float(b[0]) - k) <= 1e-3
    # the wires differ from batch to batch
    assert not np.array_equal(over[0].numpy(), over[1].numpy())


def test_overlapped_wires_equal_serial_cpu():
    _schedules_agree("cpu")


def test_check_wire_rejects_a_stale_buffer():
    s = port_tool.Schedules(torch.device("cpu"), 100, 8, 1)
    _t, drained, heads = s.serial([1, 2])
    port_tool.check_wire(drained[0], heads[0], "serial")
    with pytest.raises(HalError, match="not base"):
        port_tool.check_wire(drained[1], heads[0], "serial")


def test_cuda_without_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HalError, match="no CUDA device"):
        port_tool.run(ARGS)
    assert port_tool.main(ARGS + ["--device", "cuda"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.cuda
def test_cuda_stream_schedule_wires():
    """On the card: the overlapped schedule (copy stream, pinned buffers,
    the drain thread on the copies' events) drains the serial schedule's
    wires, and the tool runs end to end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _schedules_agree("cuda")
    port_tool.run(ARGS + ["--device", "cuda"])

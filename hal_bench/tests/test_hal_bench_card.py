"""The cells at tiny sizes on the card: correct, and a traced run reads
its device metrics (the profiler's trace tied to the host clock).  Run on
a machine with a card: python -m pytest hal_bench/tests -m cuda."""

import pytest

from small import CELLS, run_small


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run_small(cell, 2 ** 31 + 7, seconds=1.0, device="cuda")
    assert r["correct"], r["checks"]
    t = run_small(cell, 2 ** 31 + 8, seconds=1.0, trace=True, device="cuda")
    assert t["correct"], t["checks"]
    assert 0 < t["device"]["busy_s"] <= t["device"]["window_s"]
    idle = [v["value"] for k, v in t["metrics"].items()
            if k.endswith("device_idle_pct")]
    assert idle and 0 <= idle[0] < 100
    assert t["breakdown"]["device_ops"]

"""Each cell driven through the harness at a tiny size on the CPU (the
port's plain versions; the harness's look for a chip is skipped): sound
runs come out correct; the control (a guarantee of the configuration
broken) and each fault planted under the timed path come out not
correct, or fail the run outright (a fragment that lies outside the
target genome stops the BED front end)."""

import numpy as np
import pytest

from small import CELLS, run_small

SEG = "hal_tpu_torch.ops.segmap_torch"


def _decode_unchanged(orig):
    """A mapper whose levels return their state unchanged: the fragments
    are the batch's own intervals."""
    def decode(self, pend):
        lo, hi, own = (t.cpu().numpy().astype(np.int64) for t in pend[4:7])
        return lo, hi, lo, hi, np.zeros_like(lo), own
    return decode


def _decode_half(orig):
    """Half of the batch left out."""
    def decode(self, pend):
        out = orig(self, pend)
        n = int(pend[4].shape[0])
        keep = out[5] < n // 2
        return tuple(a[keep] for a in out)
    return decode


def _decode_altered(orig):
    """One fragment moved by one base where it is produced."""
    def decode(self, pend):
        out = [a.copy() for a in orig(self, pend)]
        out[2][0] += 1
        out[3][0] += 1
        return tuple(out)
    return decode


def _frags_unchanged(orig):
    """A column engine whose programs return their state unchanged: only
    the reference's own rows."""
    def window_frags(self, gs, ge):
        out = orig(self, gs, ge)
        return {t: (p if t == self.ref else []) for t, p in out.items()}
    return window_frags


def _frags_half(orig):
    """Half of each program's fragments left out."""
    def window_frags(self, gs, ge):
        out = orig(self, gs, ge)
        half = {}
        for t, parts in out.items():
            half[t] = []
            for o, st in parts:
                keep = np.arange(len(st.s_lo)) < max(len(st.s_lo) // 2, 1)
                half[t].append((o, st.select(keep)))
        return half
    return window_frags


def _maf_altered(orig):
    """One base of the assembled MAF changed."""
    def export_frags(self, *a, **kw):
        b = bytearray(orig(self, *a, **kw))
        i = b.index(b"\ns ") + 3
        i = b.index(b"\n", i) - 1
        b[i] = ord("A") if b[i] != ord("A") else ord("C")
        return bytes(b)
    return export_frags


FAULTS = {
    "lift.bulk-1m": [(SEG, "BatchMapper", "decode", f) for f in
                     (_decode_unchanged, _decode_half, _decode_altered)],
    "lift.cli-16k": [(SEG, "BatchMapper", "decode", f) for f in
                     (_decode_unchanged, _decode_half, _decode_altered)],
    "maf.window-4m": [
        ("hal_tpu_torch.ops.column_torch", "DeviceColumnEngine",
         "window_frags", _frags_unchanged),
        ("hal_tpu_torch.ops.column_torch", "DeviceColumnEngine",
         "window_frags", _frags_half),
        ("hal_tpu_torch.ops.column_native", "NativeMafExporter",
         "export_frags", _maf_altered)],
}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run_small(cell, 2 ** 31 + 99)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    assert list(r)[-1] == "checks"
    m = r["metrics"]
    assert "setup_s" in m and len(m) >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_span_metrics(cell):
    r = run_small(cell, 17, trace=True)
    assert r["correct"]
    assert r["metrics"]
    assert all(v["value"] >= 0 for v in r["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = run_small(cell, 23, control=True)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell,fault", [
    (c, i) for c in CELLS for i in range(len(FAULTS[c]))])
def test_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib

    module, cls, attr, make = FAULTS[cell][fault]
    klass = getattr(importlib.import_module(module), cls)
    monkeypatch.setattr(klass, attr, make(getattr(klass, attr)))
    try:
        r = run_small(cell, 31)
    except (IndexError, ValueError, RuntimeError):
        return  # the run fails outright: no result, not correct
    assert not r["correct"], (cell, make.__name__)

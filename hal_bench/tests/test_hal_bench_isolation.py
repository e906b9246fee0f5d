"""What the benchmark's processes load: no JAX, no JAX package, neither of
its scripts (bench.py, chip_smoke.py), compared by whole top-level
names; and the reference loads nothing of the port."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent

DRIVE = """
import json, sys
sys.path[:0] = [%r, %r]
from small import run_small, CELLS
import hal_bench.run  # the entry's own imports
for cell in CELLS:
    run_small(cell, 5, seconds=0.2)
    run_small(cell, 5, seconds=0.2, trace=True)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, %r)
import hal_bench.gen
import hal_bench.reference.column_exact, hal_bench.reference.liftover_bed
import hal_bench.reference.maf_builder, hal_bench.reference.mapper
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    names = _top_level(DRIVE % (str(ROOT), str(HERE)))
    assert "hal_tpu_torch" in names and "hal_bench" in names
    assert not names & {"jax", "jaxlib", "flax", "hal_tpu", "bench",
                        "chip_smoke"}


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level(REFERENCE % str(ROOT))
    assert not names & {"hal_tpu_torch", "hal_tpu", "jax", "torch"}


def test_the_harness_names_forbidden_modules_by_whole_top_level_name(
        monkeypatch):
    from hal_bench import harness

    monkeypatch.setitem(sys.modules, "hal_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "benchmarks", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hal_tpu.ops", sys)
    assert harness.forbidden_modules() == ["hal_tpu"]


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "hal_bench/run.py", "--workload", "maf.window-4m",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

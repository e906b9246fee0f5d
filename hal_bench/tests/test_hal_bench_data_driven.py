"""A later change adds a cell, a traffic mix or a metric as new files and a
BENCHMARK.json entry: the harness finds them by name, with no existing
file of hal_bench edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DRIVE = """
import json, sys, time
sys.path[:0] = [%r, %r]
from hal_bench import harness
r = harness.run_cell("maf.window-64k", 9, 0.2, False,
                     t_start=time.perf_counter(), device="cpu",
                     config_patch={"min_segments": 2048,
                                   "max_segments": 2100})
print(json.dumps(r))
"""


def test_new_traffic_file_and_cell_are_found(tmp_path):
    shutil.copytree(ROOT / "hal_bench", tmp_path / "hal_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "hal_bench").rglob("*")
              if p.is_file()}
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "maf.window-64k",
                           "config": "mammal10-dna128",
                           "traffic": "window-64k", "chips": 1,
                           "why": "small regions"})
    for e in m["end_to_end"]:
        if "workloads" in e and "maf.window-4m" in e["workloads"]:
            e["workloads"].append("maf.window-64k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    (tmp_path / "hal_bench" / "traffic" / "window-64k.json").write_text(
        json.dumps({"driver": "maf_export", "window": 65536,
                    "warmup": 1, "check_requests": 1}))
    out = subprocess.run(
        [sys.executable, "-c", DRIVE % (str(tmp_path), str(ROOT))],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert set(r["metrics"]) == {"columns_per_s", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p

"""Port copy of hal_tpu/parallel/mp.py (the same code; the halStats calls
run the port's tool, hal_tpu_torch.tools.halStats).

Process-parallel orchestration helpers.

Parity with the reference's Python layer (stats/halStats.py:20-117): a
shell-command pool primitive plus programmatic wrappers over halStats
output, used by the *MP tools (hal2mafMP, halPhyloPMP, halLodInterpolate
--numProc).  On a TPU host the preferred scaling path is jax.sharding
(hal_tpu.parallel.sharded); these exist for CLI-compatible workflows."""

from __future__ import annotations

import multiprocessing
import subprocess
import sys


def run_shell_command(cmd: str) -> str:
    proc = subprocess.run(cmd, shell=True, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("Command %s failed: %s" % (cmd, proc.stderr))
    return proc.stdout


def run_parallel_shell_commands(cmds: list[str], num_proc: int = 1) -> list[str]:
    """reference runParallelShellCommands (stats/halStats.py:33-48)."""
    if num_proc <= 1 or len(cmds) <= 1:
        return [run_shell_command(c) for c in cmds]
    with multiprocessing.Pool(min(num_proc, len(cmds))) as pool:
        return pool.map(run_shell_command, cmds)


def _hal_stats(hal_path: str, *args: str) -> str:
    return run_shell_command(
        "%s -m hal_tpu_torch.tools.halStats %s %s" % (sys.executable, hal_path, " ".join(args)))


def get_hal_genomes(hal_path: str) -> list[str]:
    return _hal_stats(hal_path, "--genomes").split()


def get_hal_root_name(hal_path: str) -> str:
    return _hal_stats(hal_path, "--root").strip()


def get_hal_parent_name(hal_path: str, genome: str) -> str:
    return _hal_stats(hal_path, "--parent", genome).strip()


def get_hal_child_names(hal_path: str, genome: str) -> list[str]:
    return _hal_stats(hal_path, "--children", genome).split()


def get_hal_sequences(hal_path: str, genome: str) -> list[str]:
    out = _hal_stats(hal_path, "--sequences", genome).strip()
    return out.split(",") if out else []


def get_hal_num_segments(hal_path: str, genome: str) -> tuple[int, int]:
    parts = _hal_stats(hal_path, "--numSegments", genome).split()
    return int(parts[0]), int(parts[1])


def get_hal_stats(hal_path: str) -> list[tuple]:
    """Rows of the default table: (name, children, length, sequences, top, bottom)."""
    rows = []
    for line in _hal_stats(hal_path).splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 6 and parts[1].isdigit():
            rows.append((parts[0], int(parts[1]), int(parts[2]), int(parts[3]),
                         int(parts[4]), int(parts[5])))
    return rows


def get_hal_genome_length(hal_path: str, genome: str) -> int:
    for row in get_hal_stats(hal_path):
        if row[0] == genome:
            return row[2]
    raise KeyError(genome)


def get_hal_tree(hal_path: str) -> str:
    return _hal_stats(hal_path, "--tree").strip()

"""Port copy of hal_tpu/__main__.py (numpy only; imports pointing at
hal_tpu_torch, and its usage lines name `python -m hal_tpu_torch`).

Tool dispatcher: `python -m hal_tpu_torch <tool> [args...]`.

Lists every available CLI tool (the reference ships ~40 binaries into bin/;
here each is a module under hal_tpu_torch.tools)."""

from __future__ import annotations

import importlib
import pkgutil
import sys


def available_tools() -> list[str]:
    import hal_tpu_torch.tools as tools_pkg

    return sorted(
        m.name for m in pkgutil.iter_modules(tools_pkg.__path__) if not m.name.startswith("_")
    )


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        sys.stderr.write("usage: python -m hal_tpu_torch <tool> [args...]\n\ntools:\n")
        for t in available_tools():
            sys.stderr.write("  %s\n" % t)
        return 0 if len(sys.argv) >= 2 else 1
    tool = sys.argv[1]
    if tool not in available_tools():
        sys.stderr.write("unknown tool: %s (see `python -m hal_tpu_torch --help`)\n" % tool)
        return 1
    mod = importlib.import_module("hal_tpu_torch.tools." + tool)
    return mod.main(sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main())

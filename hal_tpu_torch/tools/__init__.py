"""Port copy of hal_tpu/tools/__init__.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

CLI tools — one module per reference binary (inventory: SURVEY.md §2.3).

Conventions mirror the reference's CLParser (api/inc/halCLParser.h:33):
positional arguments + --options; storage-driver options are injected into
every parser; every main wraps work in the reference's error convention
("hal exception caught: ..." to stderr, exit 1 —
liftover/impl/halLiftoverMain.cpp:143-148).

The port's tools run as `python -m hal_tpu_torch.tools.<tool>`.
"""

from __future__ import annotations

import argparse
import sys


class HalError(Exception):
    """User-facing error (reference hal_exception, api/inc/halDefs.h:52)."""


def make_parser(prog: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=description)
    return p


def add_storage_options(p: argparse.ArgumentParser, write: bool = False) -> None:
    """Storage-driver option injection (reference Hdf5Alignment::defineOptions
    api/hdf5_impl/hdf5Alignment.cpp:105-129, MMapAlignment::defineOptions
    api/mmap_impl/mmapAlignment.cpp:44-63)."""
    g = p.add_argument_group("storage options")
    if write:
        g.add_argument("--format", choices=["hdf5", "halz"], default=None,
                       help="output storage format (default: by file extension)")
        g.add_argument("--hdf5Chunk", type=int, default=1000, help="hdf5 chunk size")
        g.add_argument("--hdf5Compression", type=int, default=2,
                       help="hdf5 deflate level (0-9)")
    g.add_argument("--inMemory", action="store_true",
                   help="load all arrays fully into memory (halz mmap off)")


def save_kwargs(opts) -> dict:
    """Translate parsed storage options into save_alignment kwargs."""
    out = {}
    fmt = getattr(opts, "format", None)
    if fmt:
        out["fmt"] = fmt
    if fmt == "hdf5":
        out["chunk"] = getattr(opts, "hdf5Chunk", 1000)
        out["compression"] = getattr(opts, "hdf5Compression", 2)
    return out


def tool_main(run, argv=None) -> int:
    """Error-handling wrapper shared by every tool main."""
    try:
        run(argv)
        return 0
    except BrokenPipeError:
        return 0
    except (HalError, KeyError, ValueError, IOError, AssertionError) as e:
        sys.stderr.write("hal exception caught: %s\n" % e)
        return 1


def out_stream(path: str | None):
    if path in (None, "stdout", "-"):
        return sys.stdout
    return open(path, "w")

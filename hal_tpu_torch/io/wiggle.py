"""Port copy of hal_tpu/io/wiggle.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

Wiggle (fixedStep/variableStep) parsing and emission
(reference liftover/impl/halWiggleScanner.cpp, halWiggleLiftover.cpp).

Genome-scale wiggles are parsed/emitted by the native runtime when built
(native/libhaltpu.so: ht_parse_fixed_values / ht_parse_varstep_values /
ht_format_wiggle_values); the pure-Python paths below are the fallback and
the correctness oracle."""

from __future__ import annotations

import numpy as np


def _native():
    from hal_tpu_torch import native

    return native if native.available() else None


def read_wiggle_bytes(data: bytes):
    """Fast whole-buffer reader: locate the (rare) header lines in Python,
    parse the dense numeric chunks natively.  Yields the same batches as
    read_wiggle."""
    nat = _native()
    headers = []  # (offset_of_line, end_of_line)
    off = 0
    while True:
        f = data.find(b"fixedStep", off)
        v = data.find(b"variableStep", off)
        nxt = min(x for x in (f, v) if x >= 0) if (f >= 0 or v >= 0) else -1
        if nxt < 0:
            break
        eol = data.find(b"\n", nxt)
        eol = len(data) if eol < 0 else eol
        # header must start a line
        if nxt == 0 or data[nxt - 1:nxt] == b"\n":
            headers.append((nxt, eol))
        off = eol + 1
    for k, (h, eol) in enumerate(headers):
        head = data[h:eol].split()
        kv = dict(x.split(b"=", 1) for x in head[1:] if b"=" in x)
        seq = kv.get(b"chrom", b"").decode()
        fixed = head[0] == b"fixedStep"
        start = int(kv.get(b"start", b"1")) - 1
        step = int(kv.get(b"step", b"1"))
        span = int(kv.get(b"span", b"1"))
        chunk = data[eol + 1: headers[k + 1][0] if k + 1 < len(headers) else len(data)]
        if fixed:
            vals = (nat.parse_fixed_values(chunk) if nat else
                    np.array([float(x) for x in chunk.split()], np.float64))
            base = start + np.arange(len(vals), dtype=np.int64) * step
            pos = base
        else:
            if nat:
                pos, vals = nat.parse_varstep_values(chunk)
            else:
                toks = chunk.split()
                pos = np.array([int(x) for x in toks[0::2]], np.int64) - 1
                vals = np.array([float(x) for x in toks[1::2]], np.float64)
        if span > 1:
            pos = (pos[:, None] + np.arange(span)).reshape(-1)
            vals = np.repeat(vals, span)
        if len(pos):
            yield seq, pos, vals


def read_wiggle(stream):
    """Yield (sequence_name, positions ndarray, values ndarray) batches, one
    per header block.  Positions are 0-based sequence-relative."""
    if hasattr(stream, "buffer") or hasattr(stream, "read"):
        # seekable real files take the whole-buffer fast path
        try:
            data = stream.buffer.read() if hasattr(stream, "buffer") else stream.read()
            if isinstance(data, str):
                data = data.encode()
            yield from read_wiggle_bytes(data)
            return
        except (AttributeError, OSError):
            pass
    yield from _read_wiggle_lines(stream)


def _read_wiggle_lines(stream):
    """Line-by-line fallback parser (the correctness oracle)."""
    seq = None
    fixed = True
    start = 0
    step = 1
    span = 1
    positions: list[int] = []
    values: list[float] = []

    def flush():
        nonlocal positions, values
        if seq is not None and positions:
            yield_batch = (seq, np.asarray(positions, np.int64), np.asarray(values, np.float64))
            positions, values = [], []
            return yield_batch
        positions, values = [], []
        return None

    for line in stream:
        s = line.strip()
        if not s or s.startswith("#") or s.startswith("track") or s.startswith("browser"):
            continue
        f = s.split()
        if f[0] in ("fixedStep", "variableStep"):
            b = flush()
            if b:
                yield b
            kv = dict(x.split("=", 1) for x in f[1:] if "=" in x)
            seq = kv.get("chrom")
            fixed = f[0] == "fixedStep"
            start = int(kv.get("start", 1)) - 1
            step = int(kv.get("step", 1))
            span = int(kv.get("span", 1))
            n = 0
        else:
            if seq is None:
                raise ValueError("wiggle value before header: " + s)
            if fixed:
                v = float(f[0])
                for k in range(span):
                    positions.append(start + k)
                    values.append(v)
                start += step
            else:
                p = int(f[0]) - 1
                v = float(f[1])
                for k in range(span):
                    positions.append(p + k)
                    values.append(v)
    b = flush()
    if b:
        yield b


def write_wiggle_runs(out, seq_name: str, positions: np.ndarray, values: np.ndarray):
    """Emit fixedStep step=1 blocks over runs of consecutive positions."""
    if len(positions) == 0:
        return
    order = np.argsort(positions, kind="stable")
    p = positions[order]
    v = values[order]
    # last value wins on duplicates
    keep = np.concatenate([p[1:] != p[:-1], [True]])
    p, v = p[keep], v[keep]
    brk = np.concatenate([[True], p[1:] != p[:-1] + 1])
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], len(p))
    nat = _native()
    for a, b in zip(starts, ends):
        out.write("fixedStep chrom=%s start=%d step=1\n" % (seq_name, int(p[a]) + 1))
        if nat:
            out.write(nat.format_wiggle_values(v[a:b]).decode())
        else:
            out.write("\n".join("%g" % x for x in v[a:b]))
            out.write("\n")

"""The port's fragment assembler, NativeMafExporter.export_frags of
hal_tpu_torch.ops.column_native (its own engine copy plans a window's
blocks, then writes their text once into an exact-size buffer), held
byte-equal to the JAX package's exporter, which builds the original
engine (native/column_engine.cpp) and writes its text as it goes.

Each case feeds both exporters the same fragment tables, window after
window through one exporter, then finish(): the bytes of every call must
be equal.  The tables come from the port's DeviceColumnEngine on the CPU,
from the host twin (_target_frags_host), and from hand-made and random
tables that make sure of the block machine's rarer paths: a block left
open across calls, --maxBlockLen cuts, reversed rows, several sequences
a genome, paralogous rows (one key twice in a column), a late joiner
(an entry kept idle, then fed mid-block), more than ten idle blocks
(last_used eviction), empty reference blocks dropped and an empty
window."""

import numpy as np
import pytest

from hal_tpu.ops import column_native as jax_cn
from hal_tpu.randgen import create_random_alignment as jax_random_alignment
from hal_tpu_torch import tracing
from hal_tpu_torch.ops import column_native as port_cn
from hal_tpu_torch.ops import column_torch as ct
from hal_tpu_torch.randgen import create_random_alignment

SMALL = dict(seed=11, max_genomes=7, min_genomes=5, min_segments=6,
             max_segments=30, min_segment_length=3, max_segment_length=12)
LONG = dict(seed=5, max_genomes=6, min_genomes=5, min_segments=40,
            max_segments=60, min_segment_length=10, max_segment_length=20)


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _pair(kw):
    return create_random_alignment(**kw), jax_random_alignment(**kw)


def _leaf(aln):
    return [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)
            and aln.open_genome(n).length][0]


def _edges(ge, n):
    return [ge * i // n for i in range(n + 1)]


def _engine_windows(aln, ref, n):
    eng = ct.DeviceColumnEngine(aln, ref, device="cpu")
    e = _edges(int(aln.open_genome(ref).length), n)
    return [(a, b, eng.window_frags(a, b)) for a, b in zip(e, e[1:])]


def _host_windows(aln, ref, n):
    sim = ct.ColumnHostSim(aln)
    programs = ct.build_programs(aln, ref, set(aln.genome_names()),
                                 aln.root_name)
    e = _edges(int(aln.open_genome(ref).length), n)
    return [(a, b, ct._target_frags_host(sim, programs, a, b))
            for a, b in zip(e, e[1:])]


def _st(rows):
    """_St of (s_lo, t_lo, ln, rev) rows, keyed in their order."""
    a = np.array(rows, np.int64).reshape(-1, 4)
    return ct._St(a[:, 0].copy(), a[:, 1].copy(), a[:, 2].copy(),
                  a[:, 3].astype(np.uint8), np.arange(len(a), dtype=np.int64))


def _rows(aln, windows):
    """Each window's cut intervals as lists of (genome, sequence, rev),
    in the assembler's row order."""
    gid = {n: i for i, n in enumerate(sorted(aln.genome_names()))}
    out = []
    for gs, ge, frags in windows:
        cols = []
        for t in sorted(frags):
            g = aln.open_genome(t)
            for o, st in frags[t]:
                for i in range(len(st.s_lo)):
                    seq = int(np.searchsorted(g.seq_start, st.t_lo[i],
                                              side="right")) - 1
                    cols.append((gid[t], seq, o, int(st.key[i]),
                                 int(st.s_lo[i]), int(st.ln[i]),
                                 int(st.rev[i])))
        cols.sort(key=lambda r: r[:4])
        cuts = sorted({gs, ge} | {r[4] for r in cols}
                      | {r[4] + r[5] for r in cols})
        cuts = [c for c in cuts if gs <= c <= ge]
        out += [[(r[0], r[1], r[6]) for r in cols if r[4] <= a < r[4] + r[5]]
                for a in cuts[:-1]]
    return out


def _reversed(aln, windows):
    return any(r[2] for iv in _rows(aln, windows) for r in iv)


def _multi_sequence(aln, windows):
    return any(r[1] > 0 for iv in _rows(aln, windows) for r in iv)


def _paralogous(aln, windows):
    return any(len({r[:2] for r in iv}) < len(iv)
               for iv in _rows(aln, windows))


def _blocks(maf):
    return [b for b in maf.decode().split("\n\n") if b.startswith("a\n")]


# ------------------------------------------------------------- the cases

def _left_open(out, staged):
    """Every call but the last left a block open for the next."""
    return out and all(n > 0 for n in staged[:-1])


def case_engine_two_windows():
    port, jaxa = _pair(SMALL)
    ref = _leaf(port)
    return port, jaxa, ref, _engine_windows(port, ref, 2), {}, _left_open


def case_engine_three_windows():
    port, jaxa = _pair(LONG)
    ref = _leaf(port)
    return port, jaxa, ref, _engine_windows(port, ref, 3), {}, _left_open


def case_max_block_len_7():
    port, jaxa = _pair(LONG)
    ref = _leaf(port)
    return (port, jaxa, ref, _host_windows(port, ref, 2),
            dict(max_block_len=7), lambda out, _s: len(_blocks(out)) > 20)


def case_max_block_len_1000():
    port, jaxa = _pair(SMALL)
    ref = _leaf(port)
    return (port, jaxa, ref, _host_windows(port, ref, 1),
            dict(max_block_len=1000), None)


def case_reversed_rows():
    port, jaxa = _pair(dict(SMALL, seed=42))
    ref = _leaf(port)
    w = _host_windows(port, ref, 2)
    assert _reversed(port, w)
    return port, jaxa, ref, w, {}, None


def case_multi_sequence():
    from test_torch_column import _multi_sequence as build

    port, jaxa = build("hal_tpu_torch"), build("hal_tpu")
    w = _engine_windows(port, "Anc", 2)
    assert _multi_sequence(port, w) and _reversed(port, w)
    return port, jaxa, "Anc", w, dict(max_block_len=3), None


def case_paralogous_rows():
    for seed in range(11, 60):
        port, jaxa = _pair(dict(SMALL, seed=seed))
        ref = _leaf(port)
        w = _host_windows(port, ref, 2)
        if _paralogous(port, w):
            return port, jaxa, ref, w, {}, None
    raise AssertionError("no seed with a key twice in a column")


def _three_leaves():
    port, jaxa = _pair(LONG)
    leaves = [n for n in sorted(port.genome_names())
              if port.tree.is_leaf(n)]
    return port, jaxa, leaves[0], leaves[1], leaves[2]


def case_late_joiner():
    """B feeds block 1, idles while A's jump opens block 2, then joins
    block 2 mid-way: its line there is ten '-', then ten bases."""
    port, jaxa, ref, a, b = _three_leaves()
    frags = {ref: [(0, _st([(0, 0, 30, 0)]))],
             a: [(0, _st([(0, 100, 10, 0), (10, 200, 20, 0)]))],
             b: [(0, _st([(0, 50, 10, 0), (20, 300, 10, 1)]))]}

    def joined(out, _staged):
        second = _blocks(out)[1].split("\n")
        text = [ln.split("\t")[-1] for ln in second if b in ln]
        return len(text) == 1 and text[0][:10] == "-" * 10 and \
            "-" not in text[0][10:]
    return port, jaxa, ref, [(0, 30, frags)], {}, joined


def case_idle_eviction():
    """B feeds block 1, then idles for fourteen blocks (A jumps every ten
    columns), past last_used's limit of ten, then comes back."""
    port, jaxa, ref, a, b = _three_leaves()
    n = 16
    frags = {ref: [(0, _st([(0, 0, 10 * n, 0)]))],
             a: [(0, _st([(10 * i, 20 * i, 10, 0) for i in range(n)]))],
             b: [(0, _st([(0, 5, 10, 0), (10 * (n - 1), 40, 10, 0)]))]}
    return (port, jaxa, ref, [(0, 10 * n, frags)], {},
            lambda out, _s: len(_blocks(out)) == n)


def case_keep_empty_ref_blocks_false():
    """A's jumps open a block every ten columns, two of them where the
    reference has no row: they print the reference's all-'-' line unless
    keep_empty_ref_blocks is off."""
    port, jaxa, ref, a, b = _three_leaves()
    frags = {ref: [(0, _st([(0, 0, 10, 0), (30, 60, 10, 0)]))],
             a: [(0, _st([(10 * i, 100 * (i + 1), 10, 0)
                          for i in range(4)]))],
             b: [(0, _st([(5, 50, 30, 1)]))]}
    windows = [(0, 20, frags), (20, 40, frags)]
    full = port_cn.NativeMafExporter(port, ref)
    kept = b"".join(full.export_frags(*w) for w in windows) + full.finish()
    full.close()

    def dropped(out, _staged):
        return len(_blocks(out)) == 3 and len(_blocks(kept)) == 5
    return (port, jaxa, ref, windows, dict(keep_empty_ref_blocks=False),
            dropped)


def case_random_tables():
    """Dense random tables, the reference sparse among them, through
    three windows at --maxBlockLen 7, without empty reference blocks."""
    port, jaxa = _pair(LONG)
    ref = _leaf(port)
    rng = np.random.default_rng(7)
    width = 600
    frags = {}
    for t in sorted(port.genome_names()):
        length = int(port.open_genome(t).length)
        if length < 40:
            continue
        n = 12 if t == ref else 60
        ln = rng.integers(1, 21, n)
        s = rng.integers(0, width - 20, n)
        tl = np.array([rng.integers(0, length - k) for k in ln])
        frags[t] = [(o, _st(np.stack([s[m], tl[m], ln[m],
                                      rng.integers(0, 2, m.sum())], 1)))
                    for o, m in enumerate((np.arange(n) % 2 == 0,
                                           np.arange(n) % 2 == 1))]
    windows = [(a, b, {t: [(o, st.select((st.s_lo >= a)
                                         & (st.s_lo + st.ln <= b)))
                           for o, st in parts]
                       for t, parts in frags.items()})
               for a, b in ((0, 200), (200, 400), (400, width))]
    assert _reversed(port, windows) and _paralogous(port, windows)
    return (port, jaxa, ref, windows,
            dict(max_block_len=7, keep_empty_ref_blocks=False), None)


def case_empty_window():
    port, jaxa = _pair(SMALL)
    ref = _leaf(port)
    empty = {t: [(0, _st([]))] for t in port.genome_names()}
    return (port, jaxa, ref, [(0, 10, {}), (10, 20, empty)], {},
            lambda out, staged: out == b"" and staged == [])


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_frags_equals_original(case):
    if not (port_cn.available() and jax_cn.available()):
        pytest.skip("native column engine not built")
    port, jaxa, ref, windows, kw, check = CASES[case]()
    ex = port_cn.NativeMafExporter(port, ref, **kw)
    jex = jax_cn.NativeMafExporter(jaxa, ref, **kw)
    got, staged = [], []
    try:
        for w in windows:
            tracing.enable()
            got.append(ex.export_frags(*w))
            tracing.disable()
            counts = tracing.take()[1]
            if counts:
                staged.append(counts["assembly.staged_cols"])
        got.append(ex.finish())
        want = [jex.export_frags(*w) for w in windows] + [jex.finish()]
    finally:
        ex.close()
        jex.close()
    assert got == want
    assert (check or (lambda out, _s: out))(b"".join(got), staged), case


def test_exporters_in_threads_write_the_originals_bytes():
    """Exporters made, used and freed on four threads at once (ctypes lets
    go of the GIL in each call, so plans and writes of several engines
    overlap): every one writes the original's bytes."""
    from concurrent.futures import ThreadPoolExecutor

    if not (port_cn.available() and jax_cn.available()):
        pytest.skip("native column engine not built")
    port, jaxa = _pair(LONG)
    ref = _leaf(port)
    windows = _engine_windows(port, ref, 3)
    jex = jax_cn.NativeMafExporter(jaxa, ref, max_block_len=7)
    want = b"".join(jex.export_frags(*w) for w in windows) + jex.finish()
    jex.close()

    def export(_):
        ex = port_cn.NativeMafExporter(port, ref, max_block_len=7)
        try:
            return b"".join(ex.export_frags(*w) for w in windows) + \
                ex.finish()
        finally:
            ex.close()
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(export, range(16)))
    assert got == [want] * 16 and want


ASAN_SCRIPT = """
from hal_tpu_torch.ops import column_native as cn
from hal_tpu_torch.ops import column_torch as ct
from hal_tpu_torch.randgen import create_random_alignment

assert cn.available()
aln = create_random_alignment(**%r)
ref = [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)][0]
ge = int(aln.open_genome(ref).length)
eng = ct.DeviceColumnEngine(aln, ref, device="cpu")
edges = [0, ge // 3, 2 * ge // 3, ge]
for kw in ({}, dict(keep_empty_ref_blocks=False), dict(max_block_len=7)):
    ex = cn.NativeMafExporter(aln, ref, **kw)
    out = b"".join(eng.export_native(ex, a, b)
                   for a, b in zip(edges, edges[1:])) + ex.finish()
    assert out
    ex.close()
for kw in ({}, dict(max_ref_gap=4), dict(unique=True)):
    ex = cn.NativeMafExporter(aln, ref, **kw)
    out = b"".join(ex.export(a, b)
                   for a, b in zip(edges, edges[1:])) + ex.finish()
    assert out
    ex.close()
ex = cn.NativeMafExporter(aln, ref, global_mode=True)
leaves = [n for n in sorted(aln.genome_names()) if aln.tree.is_leaf(n)]
out = b""
for leaf in leaves[:2]:
    ex.set_ref(leaf)
    out += ex.export(0, int(aln.open_genome(leaf).length)) + ex.finish()
assert out
ex.close()
print("PORT-COLUMN-ASAN-OK")
""" % LONG


def test_export_frags_under_asan(tmp_path):
    """The port's engine copy built with AddressSanitizer and UBSan, its
    fragment assembler driven over three windows through one exporter
    (blocks left open across calls), without empty reference blocks and
    at --maxBlockLen 7, then its host DFS path (export over the same three
    windows, then finish) with the defaults, --maxRefGap 4 and --unique,
    and --global over two leaves through set_ref: an access outside the
    planned offsets aborts."""
    import os
    import shutil
    import subprocess
    import sys

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ compiler")
    libasan = subprocess.run([gxx, "-print-file-name=libasan.so"],
                             capture_output=True, text=True).stdout.strip()
    if not libasan or not os.path.exists(libasan):
        pytest.skip("libasan not found")
    lib = tmp_path / "column_engine_asan.so"
    subprocess.run([gxx, "-O1", "-g", "-fPIC", "-std=c++17", "-Wall",
                    "-fsanitize=address,undefined", "-shared", "-o",
                    str(lib), str(port_cn.SOURCE)], check=True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, HALTPU_COLUMN_LIB=str(lib), LD_PRELOAD=libasan,
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run([sys.executable, "-c", ASAN_SCRIPT],
                       capture_output=True, env=env, timeout=600, cwd=repo)
    assert r.returncode == 0, (r.stdout + r.stderr).decode()[-3000:]
    assert b"PORT-COLUMN-ASAN-OK" in r.stdout

"""hal_tpu_torch.ops.kernels: the plain versions equal numpy and the JAX
package's CPU path; the wrappers route CPU tensors to them and check
their inputs; the CUDA kernels equal the plain versions on a card.
Tolerance: exact equality (integer outputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hal_tpu.ops import segmap_jax as sj
from hal_tpu_torch.ops import kernels as K
from hal_tpu_torch.ops import segmap_torch as st

LENGTHS = [1, 2, 7, 1000, 2048, 2049, 65537]
# the CUDA scan's tile: kThreads x kItems = 256 x 64 elements (csrc/scan.cu)
SCAN_TILE = 16384
TILE_EDGES = [SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1, 2 * SCAN_TILE + 1]
I32 = np.iinfo(np.int32)


def _grid_and_queries(rng, n, nq, lo=-(1 << 30), hi=1 << 30):
    grid = np.sort(rng.integers(lo, hi, n))
    if n > 10:
        grid[n // 3:n // 3 + 4] = grid[n // 3]  # duplicate entries
    q = rng.integers(int(grid[0]) - 50, int(grid[-1]) + 50, nq)
    q[:4] = [grid[0] - 1, grid[0], grid[-1], grid[-1] + 1]
    return grid, q


@pytest.mark.parametrize("n", [1, 3, 500, 3000, 65536])
def test_searchsorted_plain_equals_numpy_and_jax(n):
    rng = np.random.default_rng(n)
    grid, q = _grid_and_queries(rng, n, 4099)
    grid = grid.astype(np.int32)
    q = q.astype(np.int32)
    want = np.searchsorted(grid, q, side="right")
    got = K.searchsorted_right(torch.from_numpy(grid), torch.from_numpy(q))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(K.searchsorted_right_plain(
        torch.from_numpy(grid), torch.from_numpy(q)).numpy(), want)
    jx = sj._searchsorted_right(jnp.asarray(grid), jnp.asarray(q))
    assert np.array_equal(np.asarray(jx), got.numpy())


def test_searchsorted_uint32_bias_equals_jax():
    """uint32-range coordinates held as int64 take the kernel branch through
    the 2^31 bias; results equal the JAX package's uint32 searchsorted."""
    rng = np.random.default_rng(7)
    grid, q = _grid_and_queries(rng, 3000, 5000, lo=0, hi=(1 << 32) - 2)
    q = np.clip(q, 0, (1 << 32) - 2)
    q[4:8] = [0, (1 << 31) - 1, 1 << 31, (1 << 32) - 2]
    got = st._searchsorted_right(torch.from_numpy(grid.astype(np.int64)),
                                 torch.from_numpy(q.astype(np.int64)),
                                 u32=True)
    assert got.dtype == torch.int64
    want = sj._searchsorted_right(jnp.asarray(grid, jnp.uint32),
                                  jnp.asarray(q, jnp.uint32))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert np.array_equal(got.numpy(), np.searchsorted(grid, q, side="right"))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 63, 64, 65, 1000, 65537])
def test_fence_tables_equal_numpy_slicing(n):
    """fence_tables(grid) = (grid[::8], grid[::64]) as contiguous int32
    tensors, at lengths around the sector (8) and fences8-sector (64)
    edges; search_tables(grid) is fences8 and the breadth-first tree of
    the top level; the kernel's wrapper with them equals numpy."""
    rng = np.random.default_rng(n)
    grid, q = _grid_and_queries(rng, n, 777)
    grid = grid.astype(np.int32)
    g_t = torch.from_numpy(grid)
    f8, f64 = K.fence_tables(g_t)
    for f, step in ((f8, 8), (f64, 64)):
        assert f.dtype == torch.int32 and f.is_contiguous()
        assert np.array_equal(f.numpy(), grid[::step])
    assert len(f8) == (n + 7) // 8 and len(f64) == (n + 63) // 64
    tables = K.search_tables(g_t)
    assert np.array_equal(tables[0].numpy(), grid[::8])
    assert np.array_equal(tables[1].numpy(), _eytzinger(grid[::8]))
    got = K.searchsorted_right(g_t, torch.from_numpy(q.astype(np.int32)),
                               tables)
    assert np.array_equal(got.numpy(), np.searchsorted(grid, q, side="right"))


def _eytzinger(top):
    """The perfect binary search tree over a sorted table in breadth-first
    order, filled by an in-order walk: h = len(top).bit_length(),
    max(2^h, 4) words, word 0 unused, INT32_MAX past the keys."""
    h = len(top).bit_length()
    out = np.full(max(1 << h, 4), I32.max, np.int64)
    keys = iter(list(top) + [I32.max] * ((1 << h) - 1 - len(top)))

    def fill(k):
        if k < (1 << h):
            fill(2 * k)
            out[k] = next(keys)
            fill(2 * k + 1)

    fill(1)
    return out


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 7, 8, 100, 8191, 8192, 18432])
def test_search_tree_equals_inorder_fill(m):
    """search_tree() equals the breadth-first tree filled by an in-order
    walk (the layout csrc/searchsorted.cu stages in shared memory)."""
    top = np.sort(np.random.default_rng(m).integers(-1000, 1000, m))
    got = K.search_tree(torch.from_numpy(top.astype(np.int32)))
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert np.array_equal(got.numpy(), _eytzinger(top))


def _emulate_kernel(grid, q, f8, tree, cap):
    """csrc/searchsorted.cu's arithmetic in numpy: h descent steps of the
    staged tree, one sector of fences8 where the tree holds fences64, one
    sector of the grid."""
    n, n8 = len(grid), len(f8)
    two = n8 > cap
    m = (n + 63) // 64 if two else n8
    h = m.bit_length()
    k = np.ones(len(q), np.int64)
    for _ in range(h):
        k = 2 * k + (tree[k] <= q)
    s = np.minimum(k - (1 << h), m)
    k = np.where(s > 0, s - 1, 0)

    def sector_count(a, base):
        idx = base[:, None] + np.arange(8)
        return ((a[np.minimum(idx, len(a) - 1)] <= q[:, None])
                & (idx < len(a))).sum(1)

    if two:
        c = sector_count(f8, 8 * k)
        k = np.where(c > 0, 8 * k + c - 1, 0)
    return np.where(s == 0, 0, 8 * k + sector_count(grid, 8 * k))


@pytest.mark.parametrize("cap", [K.SEARCH_TREE_CAP, 3, 15])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 63, 64, 65, 1000, 3000, 65537])
def test_kernel_arithmetic_equals_numpy(monkeypatch, n, cap):
    """The kernel's descent over search_tables(), emulated in numpy, equals
    np.searchsorted at grids around the sector and fence edges, with
    duplicate runs across them, exact hits, INT32_MIN and INT32_MAX - 1;
    a small tree cap forces the two-level path (fences64 on top)."""
    monkeypatch.setattr(K, "SEARCH_TREE_CAP", cap)
    rng = np.random.default_rng(n + cap)
    grid, q = _grid_and_queries(rng, n, 3001)
    for e in (8, 64, 512):
        if e + 5 < n:
            grid[e - 3:e + 5] = grid[e - 3]
    grid = grid.astype(np.int32)
    q = q.astype(np.int32)
    q[4:6] = [I32.min, I32.max - 1]
    q[6:6 + min(n, 1000)] = grid[:1000]
    f8, tree = (t.numpy() for t in K.search_tables(torch.from_numpy(grid)))
    m = len(f8) if len(f8) <= cap else (n + 63) // 64
    assert len(tree) == max(1 << m.bit_length(), 4)
    got = _emulate_kernel(grid.astype(np.int64), q.astype(np.int64),
                          f8.astype(np.int64), tree.astype(np.int64), cap)
    assert np.array_equal(got, np.searchsorted(grid, q, side="right"))


def test_levels_carry_fence_tables():
    """PathData.build and PathData.from_numpy (over segmap_jax's Levels)
    fill grid_i32 and the fence tables of every kernel level: the grid
    itself on int32 paths, its 2^31-biased copy on uint32-range ones."""
    from test_torch_segmap import _big_genome, _runs_fixture

    aln, src, tgt, _lo, _hi = _runs_fixture(3)
    big = _big_genome()[0]
    bl = [n for n in big.genome_names() if big.tree.is_leaf(n)]
    for a, s_, t_ in ((aln, src, tgt), (big, bl[0], bl[-1])):
        pj = sj.PathData.build(a, s_, t_)
        for pt in (st.PathData.build(a, s_, t_, device="cpu"),
                   st.PathData.from_numpy(pj.levels, pj.n_up,
                                          device="cpu")):
            for lv in pt.levels:
                g = lv.grid.numpy().astype(np.int64)
                want = g - (1 << 31) if lv.u32 else g
                assert lv.grid_i32.dtype == torch.int32
                assert np.array_equal(lv.grid_i32.numpy(), want)
                if not lv.u32:
                    assert lv.grid_i32 is lv.grid
                assert np.array_equal(lv.fences8.numpy(), want[::8])
                assert np.array_equal(lv.search_tree.numpy(),
                                      _eytzinger(want[::8]))


def test_searchsorted_u32_plain_equals_numpy_biased():
    """The uint32 entry's plain version: int64 queries clamped to
    [0, 2^32 - 1] and biased, searched in the biased int32 grid, equal
    np.searchsorted on the biased values; the masked slots' out-of-range
    queries (negative, >= 2^32) clamp to the ends."""
    rng = np.random.default_rng(13)
    grid = np.sort(rng.integers(0, (1 << 32) - 2, 4000))
    grid[100:140] = grid[100]  # duplicates across sector and fence edges
    q = rng.integers(-(1 << 33), 1 << 33, 9000)
    q[:8] = [-1, 0, (1 << 31) - 1, 1 << 31, (1 << 32) - 2, (1 << 32) - 1,
             1 << 32, -(1 << 40)]
    q[8:16] = grid[[0, 1, 99, 100, 139, 140, -2, -1]]
    gb = K.bias_u32(torch.from_numpy(grid))
    assert gb.dtype == torch.int32
    assert np.array_equal(gb.numpy(), (grid - (1 << 31)).astype(np.int32))
    got = K.searchsorted_right_u32(gb, torch.from_numpy(q))
    assert got.dtype == torch.int64
    qc = np.clip(q, 0, (1 << 32) - 1) - (1 << 31)
    want = np.searchsorted(grid - (1 << 31), qc, side="right")
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        K.searchsorted_right_u32_plain(gb, torch.from_numpy(q)).numpy(), want)
    with pytest.raises(TypeError):
        K.searchsorted_right_u32(gb, torch.from_numpy(q).int())


def _scan_inputs(rng, n):
    """(cumsum input, cummax input) pairs at length n: small values; sums
    that cross +-2^31 every few items; INT32_MIN / INT32_MAX."""
    x = rng.integers(0, 5, n).astype(np.int32)
    x[::5] = rng.integers(-100, 100, len(x[::5]))
    y = rng.integers(-(1 << 31) + 1, (1 << 31) - 1, n).astype(np.int32)
    wrap = np.full(n, 1 << 30, np.int32)
    wrap[::3] = -(1 << 30) - 7
    ext = rng.integers(-5, 5, n).astype(np.int32)
    ext[rng.random(n) < 0.05] = I32.min
    ext[:2] = I32.min
    ext[n // 2] = I32.max
    return (x, y), (wrap, ext)


@pytest.mark.parametrize("n", LENGTHS + TILE_EDGES)
def test_scans_plain_equal_numpy_and_jax(n):
    rng = np.random.default_rng(n)
    for x, y in _scan_inputs(rng, n):
        cs = K.cumsum_i32(torch.from_numpy(x))
        cm = K.cummax_i32(torch.from_numpy(y))
        assert cs.dtype == torch.int32 and cm.dtype == torch.int32
        assert np.array_equal(cs.numpy(), np.cumsum(x, dtype=np.int32))
        assert np.array_equal(cm.numpy(), np.maximum.accumulate(y))
        assert np.array_equal(cs.numpy(), np.asarray(
            jnp.cumsum(jnp.asarray(x), dtype=jnp.int32)))
        assert np.array_equal(cm.numpy(),
                              np.asarray(jax.lax.cummax(jnp.asarray(y))))


def test_wrappers_check_inputs():
    g = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        K.searchsorted_right(g.long(), g)
    with pytest.raises(TypeError):
        K.cumsum_i32(g.float())
    with pytest.raises(ValueError):
        K.cummax_i32(g.view(2, 5))
    with pytest.raises(ValueError):
        K.cumsum_i32(torch.arange(20, dtype=torch.int32)[::2])
    before = K.launches()
    K.searchsorted_right(g, g)
    K.cumsum_i32(g)
    K.cummax_i32(g)
    assert K.launches() == before  # CPU tensors launch no kernel


_FAKE_NVCC = r"""#!/bin/sh
# stands in for nvcc: an object per source, each waiting until every
# source's compile has started, then a link that concatenates them
out=""; prev=""; compile=0
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  [ "$a" = "-c" ] && compile=1
  prev="$a"
done
src="$a"
if [ $compile = 1 ]; then
  case "$src" in *bad.cu) echo "bad.cu(1): error: no" >&2; exit 2;; esac
  touch "STARTED/$(basename "$out")"
  n=0
  while [ "$(ls STARTED | wc -l)" -lt NSRC ]; do
    sleep 0.05; n=$((n + 1)); [ $n -gt 600 ] && exit 3
  done
  echo "ptxas info    : Used 7 registers, used 1 barriers" >&2
  echo "$src" > "$out"
else
  shift 3; cat "$@" > "$out"
fi
"""


def test_build_compiles_each_source_in_parallel(monkeypatch, tmp_path):
    """_build.build starts one nvcc per source, all together (each fake
    compile waits until all have started), links their objects into one
    library, keeps ptxas's lines, and leaves no object behind; a failed
    compile raises with its message."""
    from hal_tpu_torch.ops import _build

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a", "b", "c"):
        (csrc / ("%s.cu" % name)).write_text("// %s\n" % name)
    nvcc = tmp_path / "nvcc"
    (tmp_path / "started").mkdir()
    nvcc.write_text(_FAKE_NVCC.replace("NSRC", "3").replace(
        "STARTED", str(tmp_path / "started")))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    so = _build.build()
    assert so == _build.library_path() and so.parent == build
    assert so.read_text().split() == [str(csrc / n) for n in
                                      ("a.cu", "b.cu", "c.cu")]
    assert _build.BUILD_LOG == ["ptxas info    : Used 7 registers, used 1 "
                                "barriers"] * 3
    assert not list(build.glob("*.o")) and not list(build.glob("*.tmp*"))
    assert _build.build() == so  # found, not rebuilt
    (csrc / "bad.cu").write_text("// bad\n")
    with pytest.raises(RuntimeError, match="bad.cu.*error: no"):
        _build.build()
    assert not list(build.glob("*.o")) and not list(build.glob("*.so.tmp*"))


def test_expand_owner_equals_jax():
    """_expand_owner (cumsum + scatter-max + cummax) equals segmap_jax's,
    including counts that overflow the capacity."""
    rng = np.random.default_rng(11)
    for n, cap in ((1, 16), (37, 64), (500, 512), (500, 256)):
        counts = rng.integers(0, 4, n).astype(np.int32)
        own, off, tot = st._expand_owner(torch.from_numpy(counts), cap)
        jo, joff, jtot = sj._expand_owner(jnp.asarray(counts), cap)
        assert np.array_equal(own.numpy(), np.asarray(jo))
        assert np.array_equal(off.numpy(), np.asarray(joff))
        assert int(tot) == int(jtot)


@pytest.mark.cuda
def test_cuda_kernels_equal_plain():
    """Each CUDA kernel equals its plain version on the card (built from
    hal_tpu_torch/csrc with nvcc at first use)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    for n in (1, 7, 8, 9, 63, 64, 65, 3000, 65536, 65537, 1179648):
        grid, q = _grid_and_queries(rng, n, (1 << 16) + 3)
        g_t = torch.from_numpy(grid.astype(np.int32)).to(dev)
        q_t = torch.from_numpy(q.astype(np.int32)).to(dev)
        before = K.searchsorted_right.launches
        assert torch.equal(K.searchsorted_right(g_t, q_t),
                           K.searchsorted_right_plain(g_t, q_t))
        assert K.searchsorted_right.launches == before + 1
        assert torch.equal(K.searchsorted_right(g_t[1:], q_t[1:]),
                           K.searchsorted_right_plain(g_t[1:], q_t[1:]))
        gu, qu = _grid_and_queries(rng, n, 5001, lo=0, hi=(1 << 32) - 2)
        qu[-4:] = [-5, 1 << 32, (1 << 32) + 9, -(1 << 40)]
        gb = K.bias_u32(torch.from_numpy(gu).to(dev))
        qu_t = torch.from_numpy(qu).to(dev)
        assert torch.equal(K.searchsorted_right_u32(gb, qu_t),
                           K.searchsorted_right_u32_plain(gb, qu_t))
    for n in LENGTHS + TILE_EDGES + [33 * SCAN_TILE + 5, 1310720]:
        x = torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32)).to(dev)
        assert torch.equal(K.cumsum_i32(x), K.cumsum_i32_plain(x))
        assert torch.equal(K.cummax_i32(x), K.cummax_i32_plain(x))
        for a, b in _scan_inputs(rng, n):
            a_t = torch.from_numpy(a).to(dev)
            b_t = torch.from_numpy(b).to(dev)
            assert np.array_equal(K.cumsum_i32(a_t).cpu().numpy(),
                                  np.cumsum(a, dtype=np.int32))
            assert np.array_equal(K.cummax_i32(b_t).cpu().numpy(),
                                  np.maximum.accumulate(b))
    x = torch.from_numpy(rng.integers(-9, 9, 70001).astype(np.int32)).to(dev)
    want = K.cumsum_i32_plain(x)
    for _ in range(200):  # reused status state
        assert torch.equal(K.cumsum_i32(x), want)
    y = x.clone()
    K._scan_cuda("cumsum_i32", y, out=y)  # in place
    assert torch.equal(y, want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = K.cumsum_i32(x)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(got, want)
    torch.cuda.synchronize()

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
    for n in (1, 3000, 65536):
        grid, q = _grid_and_queries(rng, n, 1 << 16)
        g_t = torch.from_numpy(grid.astype(np.int32)).to(dev)
        q_t = torch.from_numpy(q.astype(np.int32)).to(dev)
        before = K.searchsorted_right.launches
        assert torch.equal(K.searchsorted_right(g_t, q_t),
                           K.searchsorted_right_plain(g_t, q_t))
        assert K.searchsorted_right.launches == before + 1
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

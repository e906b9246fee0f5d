"""Hand-written Hopper kernels of the segment mapper, with their plain
PyTorch versions — the counterpart of hal_tpu.ops.pallas_kernels — and the
registry of every kernel wrapper's launch count (the phyloP fit's wrappers
live in hal_tpu_torch.ops.phylop_fit).

Each wrapper checks device, dtype and contiguity.  A tensor on the CPU
takes the plain version; a CUDA tensor launches the CUDA kernel
(hal_tpu_torch/csrc, built by hal_tpu_torch.ops._build) on the current
stream, or raises.  Nothing catches a failed build or launch.

Each wrapper carries `launches`, a plain integer that grows by one each
time the wrapper launches its kernel, so a run can show that it went
through the kernel; reset_launches() sets them all to 0.

A port-only diagnostic carries the counts out of other processes: when the
environment variable HAL_TPU_TORCH_LAUNCH_LOG names a file, each process
appends its argv, its seconds and launches() to it at exit (see
hal_tpu_torch/__init__.py).
"""

from __future__ import annotations

import functools
import threading

import torch

# the phyloP fit's kernel and its likelihood entry (csrc/phylop_fit.cu)
from hal_tpu_torch.ops.phylop_fit import phylop_fit, phylop_lnl


def _check(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise TypeError("%s: expected int32, got %s" % (name, t.dtype))
    if t.dim() != 1:
        raise ValueError("%s: expected a 1-D tensor, got shape %s"
                         % (name, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s: expected a contiguous tensor" % name)
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (name, t.device))


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError("%s: CUDA launch failed (cudaError %d)"
                           % (name, err))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------- searchsorted

# the most keys of the top tree one block stages in shared memory (kTreeCap
# of csrc/searchsorted.cu); the kernel takes grids of up to 64 times as many
SEARCH_TREE_CAP = (1 << 15) - 1
SEARCH_GRID_LIMIT = 64 * SEARCH_TREE_CAP
_U32 = 0xFFFFFFFF
_BIAS = 1 << 31
_I32_MAX = (1 << 31) - 1


def fence_tables(grid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(fences8, fences64) = (grid[::8], grid[::64]) of a sorted 1-D int32
    grid as contiguous tensors: the two upper levels of the searchsorted
    kernel's sector B-tree."""
    f8 = grid[::8].contiguous()
    return f8, f8[::8].contiguous()


@functools.lru_cache(maxsize=None)
def _tree_ranks(h: int, device: torch.device) -> torch.Tensor:
    """For each word k of a breadth-first perfect tree of height h (max(2^h,
    4) words, word 0 unused), the in-order rank of node k; 2^h for the
    unused words.  Read only."""
    rank = torch.full((max(1 << h, 4),), 1 << h, dtype=torch.int64)
    for d in range(h):
        k = torch.arange(1 << d, 2 << d)
        rank[k] = ((2 * (k - (1 << d)) + 1) << (h - 1 - d)) - 1
    return rank.to(device)


def search_tree(top: torch.Tensor) -> torch.Tensor:
    """A sorted 1-D int32 table of m >= 1 keys as the perfect binary search
    tree in breadth-first order that the searchsorted kernel stages in
    shared memory: h = m.bit_length(), word k in [1, 2^h) holds the key of
    in-order rank k's node (INT32_MAX past the m keys), word 0 is unused."""
    m = top.shape[0]
    pad = torch.cat([top, top.new_full((1,), _I32_MAX)])
    return pad[_tree_ranks(m.bit_length(), top.device).clamp(max=m)]


def search_tables(grid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(fences8, tree): what the searchsorted kernel reads beside the grid,
    built once per grid — fences8 from L2, and search_tree() of its top
    level (fences8 while it has at most SEARCH_TREE_CAP keys, else
    fences64) staged in shared memory."""
    f8, f64 = fence_tables(grid)
    return f8, search_tree(f8 if f8.shape[0] <= SEARCH_TREE_CAP else f64)


def bias_u32(grid: torch.Tensor) -> torch.Tensor:
    """A uint32-range int64 grid as int32 under the order-preserving 2^31
    bias (segmap_jax's x ^ 2^31), the form searchsorted_right_u32 searches."""
    return (grid - _BIAS).to(torch.int32)


def searchsorted_right_plain(grid: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """searchsorted(grid, q, side='right') as int32."""
    return torch.searchsorted(grid, q, right=True, out_int32=True)


def searchsorted_right_u32_plain(grid: torch.Tensor,
                                 q: torch.Tensor) -> torch.Tensor:
    """searchsorted_right_u32's plain version: int64 queries clamped to
    [0, 2^32 - 1], biased by 2^31, searched in the biased int32 grid; the
    result as int64."""
    qx = (q.clamp(0, _U32) - _BIAS).to(torch.int32)
    return searchsorted_right_plain(grid, qx).to(q.dtype)


def _searchsorted_cuda(grid, q, tables, q_i64: int) -> torch.Tensor:
    """Launch the sector B-tree kernel on the current stream (no count:
    the public wrappers count)."""
    n = grid.shape[0]
    if n > SEARCH_GRID_LIMIT:
        raise ValueError("searchsorted_right: grid of %d entries exceeds the "
                         "kernel's %d" % (n, SEARCH_GRID_LIMIT))
    if n == 0:
        return torch.zeros_like(q)
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return _searchsorted_cuda(grid, q, tables, q_i64)
    if grid.data_ptr() % 32:
        grid = grid.clone()  # sectors are grid-relative: align a view
    f8, tree = search_tables(grid) if tables is None else tables
    n8 = (n + 7) // 8
    m = n8 if n8 <= SEARCH_TREE_CAP else (n + 63) // 64
    for name, t, size in (("fences8", f8, n8),
                          ("tree", tree, max(1 << m.bit_length(), 4))):
        _check("searchsorted_right " + name, t)
        if t.shape[0] != size or t.data_ptr() % 16 or t.device != q.device:
            raise ValueError("searchsorted_right: %s is not search_tables() "
                             "of this grid" % name)
    from hal_tpu_torch.ops._build import library

    out = torch.empty_like(q)
    err = library().hal_searchsorted_right(
        grid.data_ptr(), n, f8.data_ptr(), tree.data_ptr(), q.data_ptr(),
        out.data_ptr(), q.shape[0], q_i64,
        torch._C._cuda_getCurrentRawStream(q.device.index))
    _raise_on("searchsorted_right", err)
    return out


def _check_search(grid, q, q_dtype) -> None:
    _check("searchsorted_right grid", grid)
    if q.dtype != q_dtype:
        raise TypeError("searchsorted_right q: expected %s, got %s"
                        % (q_dtype, q.dtype))
    if q.dim() != 1 or not q.is_contiguous():
        raise ValueError("searchsorted_right q: expected a contiguous 1-D "
                         "tensor")
    if grid.device != q.device:
        raise ValueError("searchsorted_right: grid on %s, queries on %s"
                         % (grid.device, q.device))


def searchsorted_right(grid: torch.Tensor, q: torch.Tensor,
                       tables=None) -> torch.Tensor:
    """out[i] = #{j : grid[j] <= q[i]} as int32, for a sorted int32 grid of
    at most SEARCH_GRID_LIMIT entries and int32 queries — replaces
    pallas_kernels.searchsorted_right.  tables: search_tables(grid), built
    here when not given.  Queries equal to INT32_MAX never occur on the
    mapper's path (see csrc/searchsorted.cu)."""
    _check_search(grid, q, torch.int32)
    if q.device.type == "cpu":
        return searchsorted_right_plain(grid, q)
    out = _searchsorted_cuda(grid, q, tables, 0)
    searchsorted_right.launches += 1
    return out


searchsorted_right.launches = 0


def searchsorted_right_u32(grid: torch.Tensor, q: torch.Tensor,
                           tables=None) -> torch.Tensor:
    """The uint32-range entry of the same kernel: grid is bias_u32() of the
    level's grid, q int64 coordinates; each query is clamped to
    [0, 2^32 - 1] and biased in registers, and the result is int64.  Counts
    its launches on searchsorted_right (one kernel)."""
    _check_search(grid, q, torch.int64)
    if q.device.type == "cpu":
        return searchsorted_right_u32_plain(grid, q)
    out = _searchsorted_cuda(grid, q, tables, 1)
    searchsorted_right.launches += 1
    return out


# ------------------------------------------------------------------- scans

def cumsum_i32_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32)


def cummax_i32_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


_EPOCH_END = 1 << 30  # epochs live in 30 bits of a status word
# per (device index, stream): [status buffer, tiles consumed, last epoch]
_scan_states: dict = {}
# calls hold the lock from reserving tiles to the launch, so that on each
# stream the launches come in the order their tile ranges were reserved
_scan_lock = threading.Lock()
_scan_bound = None


def _scan_binding():
    """The scan entries of the kernel library and its tile size, looked up
    once."""
    global _scan_bound
    if _scan_bound is None:
        from hal_tpu_torch.ops._build import library

        lib = library()
        _scan_bound = ({"cumsum_i32": lib.hal_cumsum_i32,
                        "cummax_i32": lib.hal_cummax_i32}, lib.hal_scan_tile())
    return _scan_bound


def _scan_cuda(name: str, x: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the single-pass scan `name` of x into out (a new tensor unless
    given; may be x itself) on the current stream.  Counts no launch: the
    public wrappers do.

    The kernel's status words and tile counter live in one int64 buffer per
    (device, stream), zeroed when allocated and never cleared between
    calls: each call gets the next epoch and the number of tiles that the
    calls before it consumed (csrc/scan.cu)."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _scan_cuda(name, x, out)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("%s: the scan's tile counter cannot be captured "
                           "in a CUDA graph" % name)
    fns, tile = _scan_binding()
    n = x.shape[0]
    tiles = -(-n // tile)
    if out is None:
        out = torch.empty_like(x)
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # which costs more host time per call than all the rest of this wrapper
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    key = (x.device.index, stream)
    with _scan_lock:
        state = _scan_states.get(key)
        if state is None or state[0].shape[0] <= tiles:
            words = 1 << max(10, tiles.bit_length())  # > tiles: counter + words
            state = _scan_states[key] = [
                torch.zeros(words, dtype=torch.int64, device=x.device), 0, 0]
        elif state[2] + 1 == _EPOCH_END:
            state[0].zero_()
            state[1] = state[2] = 0
        state[2] += 1
        err = fns[name](x.data_ptr(), out.data_ptr(), n, state[0].data_ptr(),
                        state[1], state[2], stream)
        if err:
            del _scan_states[key]
        state[1] += tiles
    _raise_on(name, err)
    return out


def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum of a 1-D int32 tensor — replaces
    pallas_kernels.cumsum_i32."""
    _check("cumsum_i32", x)
    if x.device.type == "cpu":
        return cumsum_i32_plain(x)
    if x.shape[0] == 0:
        return x.clone()
    out = _scan_cuda("cumsum_i32", x)
    cumsum_i32.launches += 1
    return out


cumsum_i32.launches = 0


def cummax_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of a 1-D int32 tensor — replaces
    pallas_kernels.cummax_i32."""
    _check("cummax_i32", x)
    if x.device.type == "cpu":
        return cummax_i32_plain(x)
    if x.shape[0] == 0:
        return x.clone()
    out = _scan_cuda("cummax_i32", x)
    cummax_i32.launches += 1
    return out


cummax_i32.launches = 0

KERNELS = (searchsorted_right, cumsum_i32, cummax_i32, phylop_fit, phylop_lnl)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


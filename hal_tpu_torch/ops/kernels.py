"""Hand-written Hopper kernels of the segment mapper, with their plain
PyTorch versions — the counterpart of hal_tpu.ops.pallas_kernels.

Each wrapper checks device, dtype and contiguity.  A tensor on the CPU
takes the plain version; a CUDA tensor launches the CUDA kernel
(hal_tpu_torch/csrc, built by hal_tpu_torch.ops._build) on the current
stream, or raises.  Nothing catches a failed build or launch.

Each wrapper carries `launches`, a plain integer that grows by one each
time the wrapper launches its kernel, so a run can show that it went
through the kernel; reset_launches() sets them all to 0.
"""

from __future__ import annotations

import threading

import torch


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

def searchsorted_right_plain(grid: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """searchsorted(grid, q, side='right') as int32."""
    return torch.searchsorted(grid, q, right=True, out_int32=True)


def searchsorted_right(grid: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """out[i] = #{j : grid[j] <= q[i]} for a sorted int32 grid of at most
    2^31 - 1 entries (the mapper passes <= 65,536) — replaces
    pallas_kernels.searchsorted_right.  Queries equal to INT32_MAX never
    occur on the mapper's path (see csrc/searchsorted.cu)."""
    _check("searchsorted_right grid", grid)
    _check("searchsorted_right q", q)
    if grid.device != q.device:
        raise ValueError("searchsorted_right: grid on %s, queries on %s"
                         % (grid.device, q.device))
    if q.device.type == "cpu":
        return searchsorted_right_plain(grid, q)
    from hal_tpu_torch.ops._build import library

    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library().hal_searchsorted_right_i32(
            grid.data_ptr(), grid.shape[0], q.data_ptr(), out.data_ptr(),
            q.shape[0], _stream(q))
    _raise_on("searchsorted_right", err)
    searchsorted_right.launches += 1
    return out


searchsorted_right.launches = 0


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

KERNELS = (searchsorted_right, cumsum_i32, cummax_i32)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}

"""lift.kernel_roofline_pct: the hand kernels' share of their roofline on
the mapper's path: the bytes their calls need (hal_bench.peaks, counted
from the shapes of every call of kernels.searchsorted_right,
searchsorted_right_u32, cumsum_i32 and cummax_i32 as segmap_torch makes
them) over the H100's 3.35 TB/s, divided by the profiler's device time of
those kernels (searchsorted_right_kernel, scan_kernel)."""

from hal_bench import peaks

_K = "hal_tpu_torch.ops.kernels"
WRAPS = [(_K, "searchsorted_right", peaks.searchsorted_bytes),
         (_K, "searchsorted_right_u32", peaks.searchsorted_bytes),
         (_K, "cumsum_i32", peaks.scan_bytes),
         (_K, "cummax_i32", peaks.scan_bytes)]
KERNELS = ("searchsorted_right_kernel", "scan_kernel")


def read(run):
    if run.device is None:
        return None
    t = sum(run.device_s(k) for k in KERNELS)
    nbytes = sum(sum(run.calls.get(w[1], ())) for w in WRAPS)
    if not t or not nbytes:
        return None
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / t

"""benchOverlap on the torch port — hal_tpu.tools.benchOverlap's measure of
whether draining result buffers to the host can overlap device compute.
The same device program and the same wire bytes go through the original's
four schedules, with its stderr lines, JSON keys and verdict:

  compute-only   K compute chains, then one synchronize
  drain-only     K fresh wire buffers, made and synced first, each copied
                 into pageable host memory by .cpu() (the counterpart of
                 np.asarray); the same K copies into pinned buffers are
                 timed beside it on stderr
  serial         compute all, then drain all (bench.py's schedule)
  overlapped     wire k goes to pinned buffer k on a copy stream that waits
                 on an event recorded after wire k; one drain thread waits
                 on each copy's event, and does nothing else, while the
                 main thread dispatches batch k + 1

A drain thread that called .cpu() would wait on the whole default stream,
and so would measure serialisation by construction: the copy stream, the
pinned buffers and the per-copy events are what let a copy run while the
next chain computes.

The chain is torch.matmul in float32 with TF32 off (torch's default on the
card, set here), so every product is full float32; JAX's default precision
on a TPU multiplies float32 in bfloat16 passes, so a chain is not the same
work as the original's there.  The wire's base is clamped to +-1e6 before
its 1e-9 scale: the chain overflows to inf for seeds >= 1 at the default
sizes, which would make every wire inf; clamped, wire k is k + arange to
float32 precision, distinct per batch.  Each schedule's first drained wire
must equal its head (base + k, read from the device) + arange in float32,
so no time can be of a copy that did not happen.

--device cpu runs the same schedules with no streams (the drain is a
copy), as the tests do.

    python -m hal_tpu_torch.tools.benchOverlap --device cuda
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time

import numpy as np
import torch

from hal_tpu_torch.tools import HalError, make_parser, tool_main


def check_wire(got: torch.Tensor, head: torch.Tensor, what: str) -> None:
    """A drained wire equals its head + arange in float32, bit for bit."""
    want = np.float32(head.item()) + np.arange(got.numel(), dtype=np.float32)
    if not np.array_equal(got.numpy(), want):
        raise HalError("benchOverlap: the %s schedule's drained wire is not "
                       "base + k + arange" % what)


class Schedules:
    """The device program (a chain of float32 matmuls on an m x m matrix)
    and the wire (n_wire float32 values that depend on the chain's result)
    under the four schedules.  Each schedule takes the seeds of its batches
    and returns (seconds, drained wires as CPU tensors, heads)."""

    def __init__(self, device: torch.device, n_wire: int, m: int,
                 chains: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.n_wire = n_wire
        self.chains = chains
        self.x = torch.ones((m, m), dtype=torch.float32, device=device)
        self.pinned: list = []
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def compute(self, seed: float) -> torch.Tensor:
        a = self.x + seed
        for _ in range(self.chains):
            a = torch.matmul(a, a) * 1e-4
        return a

    def make_wire(self, a: torch.Tensor, k: float):
        """A fresh buffer per k; it depends on `a`, so it cannot run before
        the compute.  Returns (wire, head = base + k)."""
        head = a[0, :8].sum().clamp(-1e6, 1e6) * 1e-9 + k
        return head + torch.arange(self.n_wire, dtype=torch.float32,
                                   device=self.device), head

    @staticmethod
    def drain(w: torch.Tensor) -> torch.Tensor:
        """Pageable host copy (a forced copy on the CPU as well)."""
        return w.to("cpu", copy=True)

    def pinned_buffers(self, n: int) -> list:
        while len(self.pinned) < n:
            self.pinned.append(torch.empty(self.n_wire, dtype=torch.float32,
                                           pin_memory=True))
        return self.pinned[:n]

    def compute_only(self, seeds) -> float:
        t0 = time.perf_counter()
        for k in seeds:
            a = self.compute(float(k))
        self.sync()
        self.last = a
        return time.perf_counter() - t0

    def drain_only(self, seeds, pinned: bool = False):
        """Wires made from the last compute-only result and synced, then
        timed first copies: pageable (.cpu()), or into pinned buffers."""
        wires = [self.make_wire(self.last, float(k)) for k in seeds]
        self.sync()
        if pinned:
            bufs = self.pinned_buffers(len(wires))
            t0 = time.perf_counter()
            for buf, (wv, _h) in zip(bufs, wires):
                buf.copy_(wv)
            out = bufs
        else:
            t0 = time.perf_counter()
            out = [self.drain(wv) for wv, _h in wires]
        return time.perf_counter() - t0, out, [h for _w, h in wires]

    def serial(self, seeds):
        """bench.py's schedule: compute all, then drain all."""
        t0 = time.perf_counter()
        wires = []
        for k in seeds:
            wires.append(self.make_wire(self.compute(float(k)), float(k)))
        self.sync()
        out = [self.drain(wv) for wv, _h in wires]
        return time.perf_counter() - t0, out, [h for _w, h in wires]

    def overlapped(self, seeds):
        """One drain thread; the main thread keeps dispatching.  On the
        card, wire k is copied to pinned buffer k on the copy stream after
        an event recorded behind it, and the drain thread only waits on
        that copy's event."""
        seeds = list(seeds)
        bufs = self.pinned_buffers(len(seeds)) if self.cuda else []
        for buf in bufs:
            buf.zero_()
        q: "queue.Queue" = queue.Queue()
        done: list = []
        errors: list = []

        def drainer():
            try:
                while True:
                    item = q.get()
                    if item is None:
                        return
                    if self.cuda:
                        k, copied = item
                        copied.synchronize()  # releases the GIL meanwhile
                        done.append(bufs[k])
                    else:
                        done.append(self.drain(item))
            except Exception as e:  # re-raised by the main thread
                errors.append(e)

        heads = []
        th = threading.Thread(target=drainer)
        th.start()
        t0 = time.perf_counter()
        try:
            for k, seed in enumerate(seeds):
                wv, head = self.make_wire(self.compute(float(seed)),
                                          float(seed))
                heads.append(head)
                if not self.cuda:
                    q.put(wv)
                    continue
                ready = torch.cuda.Event()
                ready.record()
                with torch.cuda.stream(self.copy_stream):
                    self.copy_stream.wait_event(ready)
                    bufs[k].copy_(wv, non_blocking=True)
                    wv.record_stream(self.copy_stream)
                    copied = torch.cuda.Event()
                    copied.record(self.copy_stream)
                q.put((k, copied))
        finally:
            q.put(None)
            th.join()
        seconds = time.perf_counter() - t0
        if errors:
            raise errors[0]
        if len(done) != len(seeds):
            raise HalError("benchOverlap: the drain thread drained %d of %d "
                           "wires" % (len(done), len(seeds)))
        return seconds, done, heads


def run(argv=None):
    p = make_parser("benchOverlap", "Copy/compute overlap of the result "
                    "drain against device compute")
    p.add_argument("--mb", type=float, default=8.0, help="wire MB per batch")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--matmul", type=int, default=8192)
    p.add_argument("--chains", type=int, default=16)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device (cpu: the same schedules, no streams)")
    o = p.parse_args(argv)

    if o.device == "cuda" and not torch.cuda.is_available():
        raise HalError("--device cuda: no CUDA device is available "
                       "(--device cpu runs the schedules on the CPU)")
    dev = torch.device(o.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    sys.stderr.write("device: %s\n" % (torch.cuda.get_device_name(dev)
                                       if dev.type == "cuda" else "cpu"))
    K = o.iters
    s = Schedules(dev, int(o.mb * 1e6) // 4, o.matmul, o.chains)

    t0 = time.perf_counter()
    s.make_wire(s.compute(0.0), 0.0)
    s.sync()
    sys.stderr.write("warm: %.1fs\n" % (time.perf_counter() - t0))

    t_compute = s.compute_only(range(K))
    sys.stderr.write("compute-only: %.2fs (%.3fs/batch)\n"
                     % (t_compute, t_compute / K))

    t_drain, drained, heads = s.drain_only(range(100, 100 + K))
    check_wire(drained[0], heads[0], "drain-only")
    tot = sum(d.numel() * d.element_size() for d in drained)
    del drained
    sys.stderr.write("drain-only: %.2fs (%.1f MB at %.1f MB/s)\n"
                     % (t_drain, tot / 1e6, tot / t_drain / 1e6))
    if s.cuda:
        t_pinned, drained, heads = s.drain_only(range(100, 100 + K),
                                                pinned=True)
        check_wire(drained[0], heads[0], "drain-only (pinned)")
        sys.stderr.write("drain-only into pinned buffers: %.4fs (%.1f MB at "
                         "%.1f MB/s); pageable %.4fs at %.1f MB/s\n"
                         % (t_pinned, tot / 1e6, tot / t_pinned / 1e6,
                            t_drain, tot / t_drain / 1e6))

    t_serial, drained, heads = s.serial(range(200, 200 + K))
    check_wire(drained[0], heads[0], "serial")
    del drained
    sys.stderr.write("serial (compute all, drain all): %.2fs\n" % t_serial)

    t_overlap, drained, heads = s.overlapped(range(300, 300 + K))
    check_wire(drained[0], heads[0], "overlapped")
    sys.stderr.write("overlapped (drain thread): %.2fs\n" % t_overlap)
    sys.stderr.write("wires checked: the first of each schedule equals "
                     "base + k + arange\n")

    best = max(t_compute, t_drain)
    verdict = ("overlaps" if t_overlap < 0.75 * (t_compute + t_drain)
               else "serializes")
    sys.stderr.write("verdict: transfer %s with compute "
                     "(overlap %.2fs vs serial-sum %.2fs, ideal %.2fs)\n"
                     % (verdict, t_overlap, t_compute + t_drain, best))
    print(json.dumps({
        "wire_mb": round(tot / 1e6, 1), "iters": K,
        "t_compute_s": round(t_compute, 6), "t_drain_s": round(t_drain, 6),
        "t_serial_s": round(t_serial, 6), "t_overlap_s": round(t_overlap, 6),
        "overlap_efficiency": round(
            (t_compute + t_drain - t_overlap) / max(t_drain, 1e-9), 3),
        "verdict": verdict,
    }))


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())

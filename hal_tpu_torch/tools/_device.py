"""The --device option of the port's tools that lift on the batched mapper
(a divergence from their hal_tpu originals, which lift on the host)."""

from __future__ import annotations

from hal_tpu_torch.tools import HalError


def add_device_option(p) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device of the batched liftover (cpu runs "
                        "the kernels' plain versions)")


def require_device(device: str) -> None:
    """Raise HalError for --device cuda where no CUDA device is available;
    nothing falls back to the CPU."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise HalError("--device cuda: no CUDA device is available "
                       "(--device cpu runs the port on the CPU)")

"""The device rule of the port's entry points (``run_federated``,
``Model.init``): ``device=None`` means ``"cuda"``, and asking for CUDA
where there is none raises instead of carrying on on the CPU.  And the
dtype rule of the arithmetic that the reference pins to fp32 (Adam's
moments, FedAvg's sums, RoPE, the DP clip): fp32, or fp64 for fp64
tensors, so that a plain run from fp64 weights stays fp64 end to end.
And ``upload``, the host-to-card copy that does not wait for the card."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but is not available "
                           "(pass device='cpu' to run on the CPU)")
    return device


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 for float32 and narrower floats, float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def upload(x: torch.Tensor, device) -> torch.Tensor:
    """The host tensor ``x`` on ``device``.  To CUDA it goes through
    pinned memory without blocking, so the host does not wait for the
    work already queued on the stream (a blocking copy from pageable
    memory synchronises it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)

"""The device rule of the port's entry points (``run_federated``,
``Model.init``): ``device=None`` means ``"cuda"``, and asking for CUDA
where there is none raises instead of carrying on on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but is not available "
                           "(pass device='cpu' to run on the CPU)")
    return device

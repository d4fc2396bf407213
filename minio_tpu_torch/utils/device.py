"""Device selection for the port's entry points.

Every entry point takes `device=` and defaults to "cuda". When CUDA is
absent and the caller did not ask for "cpu", it raises: the port never
moves to the CPU on its own, so a run that reports device numbers really
ran on the card.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceUnavailable(RuntimeError):
    """CUDA was asked for (the default) and torch sees no CUDA device."""


def resolve(device: "str | torch.device" = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to `device` for a long-lived cache entry. On CUDA
    the copy completes before return, so the cached tensor is safe to read
    from any stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return t

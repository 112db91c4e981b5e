"""Device resolution shared by every entry point of the package."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; anything else is taken as given.

    An entry point called without a device on a machine without CUDA raises:
    it never carries on silently on the CPU.  The tests pass "cpu".
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)

"""Where the port's tensors go: the card unless the caller asks for the CPU.

A leaf module (it imports only torch), so the key packers of ``core`` and
``ops`` and the server of ``compilation`` share one rule.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """None means CUDA, and CUDA must then be available; a bare "cuda"
    gets the current device's index, as tensors report it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's "
                "plain PyTorch path on the host")
        if device.index is None:     # tensors report cuda:<index>
            device = torch.device("cuda", torch.cuda.current_device())
    return device

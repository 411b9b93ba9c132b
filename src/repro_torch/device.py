"""Device resolution shared by every entry point of the port.

Entry points take ``device=`` and default to ``"cuda"``.  A CUDA request on
a machine without a card raises here instead of falling back to the CPU:
the CPU runs only when the caller names it.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA card is "
            "available; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; "
                         "expected 'cuda' or 'cpu'")
    return dev

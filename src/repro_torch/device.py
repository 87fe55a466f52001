"""The port's device rule: every entry point takes `device=`, default
"cuda", and raises when there is no card; nothing moves to the CPU on its
own."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' (the default) but CUDA is not available — pass "
            "device='cpu' to run on the CPU")
    return dev

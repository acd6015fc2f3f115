"""The device rule every state-making entry point follows.

Entry points take ``device=`` and default to ``"cuda"``.  With no CUDA
device they raise instead of quietly running on the CPU: a caller that
wants the CPU (the tests, the plain kernel versions) says so with
``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a `torch.device`; raises when CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available()"
            f" is False; pass device='cpu' to run the plain torch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; expected "
                         f"'cuda' or 'cpu'")
    return dev

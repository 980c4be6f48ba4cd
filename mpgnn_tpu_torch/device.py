"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the GPU (``cuda``).

    There is no silent fallback: asking for the GPU on a machine without
    CUDA raises, and a caller that wants the CPU says ``device='cpu'``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev

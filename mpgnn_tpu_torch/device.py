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


def free_memory_bytes(device: torch.device) -> int:
    """Bytes of the card's memory free for new tensors: what CUDA
    reports free, plus what PyTorch's caching allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + (torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))

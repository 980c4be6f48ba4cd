"""Initial parameters made by the benchmark on the device from the seed,
in one draw, and handed alike to the program and the reference: glorot
U(-s, s), s = sqrt(6 / (fan_in + fan_out)) over the last two axes, for
conv weights; U(-1/sqrt(in), 1/sqrt(in)) for a linear layer's weight and
bias; zeros for conv biases (the program's own init conventions)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, kind), kind one of 'glorot', 'linear' (fan-in from the
# shape's last axis), 'linear_bias:<fan_in>', 'zeros'
Spec = List[Tuple[str, tuple, str]]


def drop_seed(seed: int) -> int:
    """The seed of the dropout generator of a run seeded with ``seed``."""
    return (seed * 2654435761 + 1) % (1 << 62)


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _ in spec]
    draw = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        u = draw[at:at + size].view(shape) * 2.0 - 1.0
        at += size
        if kind == "glorot":
            b = math.sqrt(6.0 / (shape[-2] + shape[-1]))
        elif kind == "linear":
            b = 1.0 / math.sqrt(shape[-1])
        elif kind.startswith("linear_bias:"):
            b = 1.0 / math.sqrt(int(kind.split(":")[1]))
        else:
            b = 0.0
        out[name] = (u * b).contiguous()
    return out

"""RelConv, the single-relation RGCN convolution:

    out = mean_aggregate_r(x) @ weight + x @ root + bias

The aggregation is done by the caller (``models.mpgnn.hop_aggregate``), so
the module only holds the transform. Weights keep the reference's
[in, out] layout.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn


class RelConvParams(NamedTuple):
    weight: torch.Tensor  # [in, out]
    root: torch.Tensor    # [in, out]
    bias: torch.Tensor    # [out]


def uniform(shape: Sequence[int], bound: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-bound, bound) on the CPU, drawn from ``generator``."""
    return torch.rand(tuple(shape), generator=generator) * (2 * bound) - bound


def glorot(shape: Sequence[int],
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """PyG glorot: U(-s, s), s = sqrt(6 / (fan_in + fan_out))."""
    return uniform(shape, math.sqrt(6.0 / (shape[-2] + shape[-1])), generator)


def init_relconv(in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None) -> RelConvParams:
    """glorot(weight), glorot(root), zeros(bias)."""
    return RelConvParams(
        weight=glorot((in_dim, out_dim), generator),
        root=glorot((in_dim, out_dim), generator),
        bias=torch.zeros(out_dim),
    )


def relconv_transform(conv, aggregated: torch.Tensor,
                      h: torch.Tensor) -> torch.Tensor:
    """Pre-activation output ``aggregated @ weight + h @ root + bias`` for a
    ``RelConv`` or ``RelConvParams``."""
    return aggregated @ conv.weight + h @ conv.root + conv.bias


class RelConv(nn.Module):
    """The plain-weight RelConv; ``forward(aggregated, h)`` is
    ``relconv_transform``."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_dim, out_dim, device=device))
        self.root = nn.Parameter(torch.empty(in_dim, out_dim, device=device))
        self.bias = nn.Parameter(torch.empty(out_dim, device=device))

    @torch.no_grad()
    def load_params(self, params: RelConvParams) -> None:
        self.weight.copy_(params.weight)
        self.root.copy_(params.root)
        self.bias.copy_(params.bias)

    def forward(self, aggregated: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return relconv_transform(self, aggregated, h)

"""MPNetm, the metapath GNN (the reference's model.py:179-228).

Per metapath m, a stack of single-relation RelConvs: hop j aggregates only
relation metapaths[m][j]; the first hop maps input_dim -> hidden, later
hops hidden -> hidden, each followed by ReLU. The per-metapath embeddings
are concatenated, then fc1 -> ReLU -> fc2 -> log_softmax. With
``train=True`` dropout follows every hop, as in the reference
(model.py:210-214).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.models.relconv import RelConv, init_relconv, uniform
from mpgnn_tpu_torch.ops.conv import dense_conv
from mpgnn_tpu_torch.ops.csr import csr_mean_aggregate
from mpgnn_tpu_torch.ops.spmm import rel_mean_aggregate


def hop_aggregate(h: torch.Tensor, op: Tuple, num_nodes: int) -> torch.Tensor:
    """One hop's relation-masked mean aggregation. ``op`` is a tagged tuple
    from ``train.loops.build_hop_arrays``:

      ('segment', src, dst, inv_deg)  gather + index_add_ segment mean
      ('csr', fwd, bwd)               the sorted-CSR kernels (ops/csr.py)

    Both compute the same mean, with zero rows for edgeless sources. A
    ``('fused', operand)`` hop has no separate aggregation: its kernel
    (ops/conv.py) runs the whole conv."""
    kind = op[0]
    if kind == "segment":
        _, src, dst, inv = op
        return rel_mean_aggregate(h, src, dst, num_nodes, inv_count=inv)
    if kind == "csr":
        _, fwd, bwd = op
        return csr_mean_aggregate(h, fwd, bwd)
    raise ValueError(f"unknown hop op {kind!r}")


class MPNetm(nn.Module):
    """Parameters: ``convs[m][j]`` (RelConv), ``fc1`` and ``fc2``
    (nn.Linear). Built empty; ``init_mpgnn`` or ``weights.params_from_jax``
    fills them."""

    def __init__(self, input_dim: int, hidden_dim: int, num_classes: int,
                 metapath_lengths: Sequence[int], device=None):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.ModuleList(
                RelConv(input_dim if j == 0 else hidden_dim, hidden_dim,
                        device=device)
                for j in range(n)
            )
            for n in metapath_lengths
        )
        self.fc1 = nn.utils.skip_init(
            nn.Linear, hidden_dim * len(metapath_lengths), hidden_dim,
            device=device)
        self.fc2 = nn.utils.skip_init(nn.Linear, hidden_dim, num_classes,
                                      device=device)

    def forward(self, x: torch.Tensor, hop_ops, *,
                dropout_rate: float = 0.6,
                generator: Optional[torch.Generator] = None,
                train: bool = False,
                first_hop_agg: Optional[List] = None) -> torch.Tensor:
        """[N, C] log-probabilities; ``hop_ops[m][j]`` is hop j of metapath
        m (``build_hop_arrays``).

        With ``train`` and ``dropout_rate > 0`` each hop's output is kept
        with probability 1 - p and scaled by 1 / (1 - p); the masks are
        drawn from ``generator`` (on x's device), one draw per hop in hop
        order. ``first_hop_agg`` (``precompute_first_hop``) holds each
        metapath's cached hop-0 aggregation, or None to compute it."""
        num_nodes = x.shape[0]
        embeddings = []
        for i, (stack, ops) in enumerate(zip(self.convs, hop_ops)):
            h = x
            for j, (conv, op) in enumerate(zip(stack, ops)):
                cached = first_hop_agg[i] if j == 0 and first_hop_agg else None
                if cached is not None:
                    h = torch.relu(conv(cached, h))
                elif op[0] == "fused":
                    h = dense_conv(op[1], h, conv.weight, conv.root, conv.bias)
                else:
                    h = torch.relu(conv(hop_aggregate(h, op, num_nodes), h))
                if train and dropout_rate > 0.0:
                    keep = torch.rand(h.shape, generator=generator,
                                      device=h.device) < 1.0 - dropout_rate
                    h = torch.where(keep, h / (1.0 - dropout_rate),
                                    torch.zeros_like(h))
            embeddings.append(h)
        h = torch.relu(self.fc1(torch.cat(embeddings, dim=1)))
        h = self.fc2(h)
        return torch.log_softmax(h.float(), dim=1)


@torch.no_grad()
def precompute_first_hop(x: torch.Tensor, hop_ops) -> List:
    """Per-metapath hop-0 aggregation of the input features, which are
    constant for a whole training run (dropout comes after each conv), so it
    is computed once outside the epoch loop. None for a fused hop, whose
    kernel owns its aggregation: it runs on x every epoch."""
    return [None if ops[0][0] == "fused"
            else hop_aggregate(x, ops[0], x.shape[0]) for ops in hop_ops]


@torch.no_grad()
def init_mpgnn(
    input_dim: int,
    hidden_dim: int,
    num_classes: int,
    metapaths: Sequence[Sequence[int]],
    generator: Optional[torch.Generator] = None,
    device=None,
) -> MPNetm:
    """An MPNetm with one conv stack per metapath, initialized like the
    reference: glorot conv weights, zero conv biases, and torch.nn.Linear's
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for fc1 and fc2. Draws come from
    ``generator`` (a CPU generator; seed 0 when None), so one seed gives the
    same parameters on every device."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = MPNetm(input_dim, hidden_dim, num_classes,
                   [len(mp) for mp in metapaths], device=device)
    for stack in model.convs:
        for conv in stack:
            conv.load_params(init_relconv(conv.weight.shape[0],
                                          conv.weight.shape[1], generator))
    for fc in (model.fc1, model.fc2):
        bound = 1.0 / math.sqrt(fc.in_features)
        fc.weight.copy_(uniform(fc.weight.shape, bound, generator))
        fc.bias.copy_(uniform(fc.bias.shape, bound, generator))
    return model

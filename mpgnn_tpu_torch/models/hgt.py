"""HGT, the Heterogeneous Graph Transformer (Hu, Dong, Wang and Sun, WWW
2020, arXiv:2003.01332), on the port's attention kernel (K6,
``ops/attention.py``).

Nodes are numbered type by type: type tau holds the rows ``offsets[tau]``
.. ``offsets[tau + 1]``, so each typed linear is one product a type on a
contiguous block of rows (``typed_linear``). A layer, for target t, source
s, edge e of relation r and head i (d_k = hidden / heads):

    K(s) = K-Linear_tau(s)(H[s]),  Q(t) = Q-Linear_tau(t)(H[t]),
    V(s) = V-Linear_tau(s)(H[s])
    ATT(e)_i = K(s)_i W^ATT_{r,i} Q(t)_i^T mu_{r,i} / sqrt(d_k)
    H~[t]_i = sum over s in N(t) of softmax(ATT)_i V(s)_i W^MSG_{r,i}
    H'[t] = alpha_tau A-Linear_tau(GELU(H~[t])) + (1 - alpha_tau) H[t]

with the softmax over all of t's edges, every relation at once (eq. 3-4),
and alpha_tau = sigmoid(skip_tau), the gated skip of the authors' pyHGT
and of PyG's ``HGTConv``. Before layer 0 a typed Linear and ReLU take the
features to the hidden width; after the last layer a Linear gives the
classes, then log_softmax (PyG's ``hgt_dblp.py``). No relative temporal
encoding, no LayerNorm, no dropout.

N(t) follows the port's direction: relation r's edges (t, s) write t's
row, as an R-GCN term does. A training step's last layer runs at the
loss's rows alone: its blockings (``ops.attention.attention_blockings`` at
those rows) give Q, the attention, A-Linear and the gate on T rows, while
K and V still come from every node. Each layer's typed projections and
A-Linear with its gate are timed as the span ``hgt.typed``, its attention
(the relation products and K6) as ``hgt.attention``, a last layer at the
loss's rows as ``model.row_tail``; the build as ``model.init``."""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.models.mpgnn import init_linear_
from mpgnn_tpu_torch.ops.attention import AttentionBlockings, hgt_attention
from mpgnn_tpu_torch.utils.prof import span


def _types(offsets: Sequence[int]):
    return enumerate(zip(offsets[:-1], offsets[1:]))


class _TypedLinear(torch.autograd.Function):
    """[n, out]: rows ``offsets[tau]`` .. ``offsets[tau + 1]`` of ``h``
    times ``w[tau]`` plus ``b[tau]``, each type's product written into its
    rows of one output; the backward's products and sums per type too."""

    @staticmethod
    def forward(ctx, h, w, b, offsets):
        out = h.new_empty((h.shape[0], w.shape[2]))
        for t, (a, z) in _types(offsets):
            if z > a:
                torch.addmm(b[t], h[a:z], w[t], out=out[a:z])
        ctx.save_for_backward(h, w)
        ctx.offsets = offsets
        return out

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.contiguous()
        gh = torch.empty_like(h) if ctx.needs_input_grad[0] else None
        gw = torch.zeros_like(w)
        gb = g.new_zeros((w.shape[0], w.shape[2]))
        for t, (a, z) in _types(ctx.offsets):
            if z > a:
                if gh is not None:
                    torch.mm(g[a:z], w[t].t(), out=gh[a:z])
                torch.mm(h[a:z].t(), g[a:z], out=gw[t])
                torch.sum(g[a:z], 0, out=gb[t])
        return gh, gw, gb, None


def typed_linear(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 offsets: Sequence[int]) -> torch.Tensor:
    """Each type's Linear on its rows of ``h`` (``w`` [types, in, out],
    ``b`` [types, out]; ``offsets`` the types' row ranges)."""
    return _TypedLinear.apply(h, w, b, tuple(offsets))


class _Gate(torch.autograd.Function):
    """``alpha_tau a + (1 - alpha_tau) h`` on each type's rows, alpha =
    sigmoid(skip); the skips' gradients are per-type sums, in a fixed
    order."""

    @staticmethod
    def forward(ctx, a, h, skip, offsets):
        alpha = torch.sigmoid(skip)
        out = torch.empty_like(a)
        for t, (lo, hi) in _types(offsets):
            if hi > lo:
                torch.mul(a[lo:hi], alpha[t], out=out[lo:hi]).add_(
                    h[lo:hi] * (1.0 - alpha[t]))
        ctx.save_for_backward(a, h, alpha)
        ctx.offsets = offsets
        return out

    @staticmethod
    def backward(ctx, g):
        a, h, alpha = ctx.saved_tensors
        ga, gh = torch.empty_like(a), torch.empty_like(h)
        gs = torch.zeros_like(alpha)
        for t, (lo, hi) in _types(ctx.offsets):
            if hi > lo:
                gt = g[lo:hi]
                torch.mul(gt, alpha[t], out=ga[lo:hi])
                torch.mul(gt, 1.0 - alpha[t], out=gh[lo:hi])
                gs[t] = ((a[lo:hi] - h[lo:hi]) * gt).sum() \
                    * alpha[t] * (1.0 - alpha[t])
        return ga, gh, gs, None


class HgtLayer(nn.Module):
    """One HGT layer's parameters: typed K/Q/V/A Linears ([types, D, D]
    and [types, D]), per-relation per-head W^ATT and W^MSG ([R, H, d_k,
    d_k]), mu [R, H] and skip [types]."""

    def __init__(self, hidden: int, num_types: int, num_rel: int,
                 heads: int, device=None):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} is not a multiple of {heads} "
                             f"heads")
        dk = hidden // heads
        self.heads = heads

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        for name in ("k", "q", "v", "a"):
            setattr(self, f"{name}_w", p(num_types, hidden, hidden))
            setattr(self, f"{name}_b", p(num_types, hidden))
        self.att = p(num_rel, heads, dk, dk)
        self.msg = p(num_rel, heads, dk, dk)
        self.mu = p(num_rel, heads)
        self.skip = p(num_types)

    def forward(self, h: torch.Tensor, blk: AttentionBlockings,
                offsets: Sequence[int], row_offsets: Sequence[int]
                ) -> torch.Tensor:
        """H' at ``blk``'s target rows (every row, or ``blk.rows``, whose
        types' ranges are ``row_offsets``) from H [N, D] of every node
        (types' ranges ``offsets``)."""
        hq = h if blk.rows is None else h.index_select(0, blk.rows)
        with span("hgt.typed"):
            k = typed_linear(h, self.k_w, self.k_b, offsets)
            v = typed_linear(h, self.v_w, self.v_b, offsets)
            q = typed_linear(hq, self.q_w, self.q_b, row_offsets)
        with span("hgt.attention"):
            dk = h.shape[1] // self.heads
            att = self.att * (self.mu / math.sqrt(dk))[:, :, None, None]
            o = hgt_attention(q, k, v, att, self.msg, blk)
        with span("hgt.typed"):
            a = typed_linear(F.gelu(o), self.a_w, self.a_b, row_offsets)
            return _Gate.apply(a, hq, self.skip, tuple(row_offsets))


class HgtNet(nn.Module):
    """HGT over ``num_types`` node types and ``num_rel`` relations: a
    typed input Linear with ReLU, ``layers`` HGT layers of width
    ``hidden`` in ``heads`` heads, a Linear head, log_softmax. Its
    parameters: ``inp_w`` [types, in, D], ``inp_b``, ``layers.<l>.*``
    (``HgtLayer``) and ``linear``."""

    def __init__(self, input_dim: int, hidden: int, num_types: int,
                 num_rel: int, num_classes: int, layers: int = 3,
                 heads: int = 8, device=None):
        super().__init__()
        with span("model.init"):
            self.inp_w = nn.Parameter(torch.empty(
                (num_types, input_dim, hidden), device=device))
            self.inp_b = nn.Parameter(torch.empty((num_types, hidden),
                                                  device=device))
            self.layers = nn.ModuleList(
                HgtLayer(hidden, num_types, num_rel, heads, device=device)
                for _ in range(layers))
            self.linear = nn.utils.skip_init(nn.Linear, hidden, num_classes,
                                             device=device)

    def forward(self, x: torch.Tensor, blks: Sequence[AttentionBlockings],
                offsets: Sequence[int],
                row_offsets: Optional[Sequence[int]] = None
                ) -> torch.Tensor:
        """Log-probabilities at the last layer's target rows: [N, C], or
        with a last blocking at rows (``blk.rows``, of the types' ranges
        ``row_offsets`` among them) [T, C] in their order, that layer then
        timed as ``model.row_tail``. ``blks[l]`` is layer l's; x [N, F]
        in the types' order (``offsets``)."""
        if len(blks) != len(self.layers):
            raise ValueError(f"{len(self.layers)} layers take as many "
                             f"blockings, not {len(blks)}")
        if any(b.rows is not None for b in blks[:-1]):
            raise ValueError("only the last layer runs at given rows")
        with span("hgt.typed"):
            h = torch.relu(typed_linear(x, self.inp_w, self.inp_b, offsets))
        for layer, blk in zip(self.layers, blks):
            cut = blk.rows is not None
            with span("model.row_tail") if cut else contextlib.nullcontext():
                h = layer(h, blk, offsets, row_offsets if cut else offsets)
        return torch.log_softmax(self.linear(h), dim=1)


@torch.no_grad()
def init_hgt_net(input_dim: int, hidden: int, num_types: int, num_rel: int,
                 num_classes: int, layers: int = 3, heads: int = 8,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> HgtNet:
    """An ``HgtNet`` drawn from ``generator`` (seed 0 when None): glorot
    matrices (U(-s, s), s = sqrt(6 / (fan_in + fan_out)) over the last two
    axes), zero biases, mu and skip 1 (pyHGT's), the head as
    ``init_linear_``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = HgtNet(input_dim, hidden, num_types, num_rel, num_classes,
                   layers, heads, device=device)
    for name, p in model.named_parameters():
        if name.startswith("linear."):
            continue
        if name.endswith(("_w", "att", "msg")):
            s = math.sqrt(6.0 / (p.shape[-2] + p.shape[-1]))
            u = torch.rand(p.shape, generator=generator) * 2.0 - 1.0
            p.copy_(u * s)
        elif name.endswith(("mu", "skip")):
            p.fill_(1.0)
        else:
            p.zero_()
    init_linear_(model.linear, generator)
    return model

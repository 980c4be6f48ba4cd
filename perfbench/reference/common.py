"""Plain PyTorch pieces the references share: the working precision, the
mean aggregation from raw edge lists, Adam with L2 decay, and the
comparison of two runs' steps. Nothing here imports the program."""

from __future__ import annotations

from typing import Dict, List

import torch

PRECISIONS = ("float64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (10 mantissa bits, to nearest), as
    the tensor cores read a float32 operand with TF32 on."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """``a @ b`` with every product's operands rounded to TF32, in the
    forward and in both gradients, as the tensor cores run all three with
    TF32 on."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(b).T, tf32(a).T @ g


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in the working precision: float64, or float32 with TF32
    products (the operands rounded first, on any device)."""
    if precision == "tf32":
        return _Tf32Matmul.apply(a, b)
    return a @ b


class _MeanAggregate(torch.autograd.Function):
    """out[s] = mean over edges (s, d) of h[d]; the backward adds each
    source's gradient over its degree back into h[d] along the same edges.
    It keeps only the edge lists and the degrees (``index_add`` under
    autograd would keep its gathered [E, F] source, which at ogbn-mag's
    size does not fit on the card in float64)."""

    @staticmethod
    def forward(ctx, h, src, dst, num_nodes):
        deg = torch.zeros(num_nodes, dtype=h.dtype, device=h.device)
        deg.index_add_(0, src, torch.ones_like(src, dtype=h.dtype))
        inv = 1.0 / deg.clamp_min(1.0)
        out = torch.zeros((num_nodes, h.shape[1]), dtype=h.dtype,
                          device=h.device).index_add_(0, src, h[dst])
        ctx.save_for_backward(src, dst, inv)
        ctx.rows = h.shape[0]
        return out * inv[:, None]

    @staticmethod
    def backward(ctx, g):
        src, dst, inv = ctx.saved_tensors
        gh = torch.zeros((ctx.rows, g.shape[1]), dtype=g.dtype,
                         device=g.device)
        return gh.index_add_(0, dst, (g * inv[:, None])[src]), None, None, \
            None


def mean_aggregate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   num_nodes: int) -> torch.Tensor:
    """out[s] = mean over edges (s, d) of h[d]; rows without edges 0."""
    return _MeanAggregate.apply(h, src, dst, num_nodes)


class Adam:
    """torch.optim.Adam's arithmetic with L2 decay added to the gradient
    before the moments, written out."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = (
            lr, weight_decay, betas[0], betas[1], eps)
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The decayed gradient of each leaf (what the optimizer gets);
        ``params`` are updated in place."""
        self.t += 1
        got = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            got[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            c1 = 1 - self.b1 ** self.t
            c2 = 1 - self.b2 ** self.t
            denom = (self.v[k] / c2).sqrt() + self.eps
            p.sub_(self.lr * (self.m[k] / c1) / denom)
        return got


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """Per leaf ``|prog norm - ref norm|`` over the larger of the
    reference's norm of that leaf and its median leaf's, for the leaves
    in ``keep``."""
    norms = sorted(ref[k] for k in keep)
    med = norms[len(norms) // 2] if norms else 0.0
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keep}


def moving_leaves(grad_norms: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others are nought to rounding and move under Adam
    by round-off alone."""
    norms = sorted(grad_norms.values())
    med = norms[len(norms) // 2]
    return [k for k, v in grad_norms.items() if v >= 1e-3 * med]

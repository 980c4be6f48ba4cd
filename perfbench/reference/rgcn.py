"""Plain reference of the R-GCN baseline's training step (Schlichtkrull et
al. 2018, arXiv:1703.06103, eq. 2; the reference's ``Net``, model.py:
132-149, and main_rgcn.py): each layer

    h'_i = ReLU( sum_r sum_{j in N_r(i)} (1 / c_{i,r}) h_j W_r
                 + h_i W_0 + b )

with c_{i,r} the count of i's r-edges (mp_rgcn_layer.py:346-357), so a
node without r-edges gets no r-term; ``conv1`` (input -> hidden) for
layer 0 and ``conv2`` (hidden -> output) for every later layer; a linear
head and log_softmax; the NLL over the train rows, each row weighted by
its class's balanced weight n / (C * count) (main_rgcn.py:376-379), as a
weighted mean; Adam with L2 decay. No dropout (the ``Net`` has none).

Each r-term is computed per edge, as the JAX package's
``fast_rgcn_aggregate`` writes it: a block of edges gathers h_j, takes
its product with W_r and adds it, times 1 / c_{i,r}, into row i. The
backward recomputes the same blocks, so no [E, F] tensor is kept. W_r is
a relation's plain weight, a mixture of bases or a block-diagonal
matrix, from the parameters' names. Also the step's operations and bytes,
from these equations. Nothing here imports the program."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from perfbench.reference.common import Adam, dtype_of, mm, tf32
from perfbench.work import F32, I64, Work, distinct

# edges a block of the per-edge products
EDGE_BLOCK = 1 << 21


def _prod(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in the working precision, outside autograd."""
    if precision == "tf32":
        return tf32(a) @ tf32(b)
    return a @ b


class _RelationTerm(torch.autograd.Function):
    """out[i] = sum over r-edges (i, j) of coef_e * (h[j] @ w), per edge, in
    blocks of ``EDGE_BLOCK`` edges; the backward recomputes each block."""

    @staticmethod
    def forward(ctx, h, w, src, dst, coef, num_nodes, precision):
        out = torch.zeros((num_nodes, w.shape[1]), dtype=h.dtype,
                          device=h.device)
        for a in range(0, src.numel(), EDGE_BLOCK):
            b = a + EDGE_BLOCK
            msg = _prod(h[dst[a:b]], w, precision) * coef[a:b, None]
            out.index_add_(0, src[a:b], msg)
        ctx.save_for_backward(h, w, src, dst, coef)
        ctx.precision = precision
        return out

    @staticmethod
    def backward(ctx, g):
        h, w, src, dst, coef = ctx.saved_tensors
        p = ctx.precision
        gh = torch.zeros_like(h) if ctx.needs_input_grad[0] else None
        gw = torch.zeros_like(w)
        for a in range(0, src.numel(), EDGE_BLOCK):
            b = a + EDGE_BLOCK
            gs = g[src[a:b]] * coef[a:b, None]
            gw += _prod(h[dst[a:b]].T, gs, p)
            if gh is not None:
                gh.index_add_(0, dst[a:b], _prod(gs, w.T, p))
        return gh, gw, None, None, None, None, None


def relation_edges(src: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                   dtype: torch.dtype) -> tuple:
    """(src, dst, coef) of one relation: coef_e = 1 / c_{src_e, r}."""
    count = torch.zeros(num_nodes, dtype=dtype, device=src.device)
    count.index_add_(0, src, torch.ones_like(src, dtype=dtype))
    return src, dst, 1.0 / count[src]


def effective_weights(p: Dict[str, torch.Tensor], conv: str
                      ) -> torch.Tensor:
    """[R, in, out] weights of ``conv`` ('conv1' or 'conv2'): its
    ``weight``; or ``comp`` [R, B] mixing ``bases`` [B, in, out]; or the
    block-diagonal matrices of ``blocks`` [R, nb, in/nb, out/nb]."""
    if f"{conv}.weight" in p:
        return p[f"{conv}.weight"]
    if f"{conv}.comp" in p:
        comp, bases = p[f"{conv}.comp"], p[f"{conv}.bases"]
        return (comp[:, :, None, None] * bases[None]).sum(1)
    blocks = p[f"{conv}.blocks"]
    return torch.stack([torch.block_diag(*blk) for blk in blocks])


def forward(x: torch.Tensor, rels: Dict[int, tuple],
            p: Dict[str, torch.Tensor], layers: int, precision: str,
            rows: torch.Tensor) -> torch.Tensor:
    """[len(rows), C] log-probabilities of the rows ``rows``; ``rels[r]``
    is ``relation_edges`` of relation r."""
    n = x.shape[0]
    h = x
    for layer in range(layers):
        conv = "conv1" if layer == 0 else "conv2"
        w = effective_weights(p, conv)
        z = mm(h, p[f"{conv}.root"], precision) + p[f"{conv}.bias"]
        for r, (src, dst, coef) in rels.items():
            z = z + _RelationTerm.apply(h, w[r], src, dst, coef, n,
                                        precision)
        h = torch.relu(z)
    h = h[rows]
    return torch.log_softmax(mm(h, p["linear.weight"].T, precision)
                             + p["linear.bias"], dim=1)


def balanced_weights(train_y: torch.Tensor, num_classes: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """[T] weight of each train row: n / (C * count) of its class, an
    empty class counted once."""
    counts = torch.bincount(train_y, minlength=num_classes).clamp_min(1)
    return (train_y.numel() / (num_classes * counts.to(dtype)))[train_y]


def train_steps(x: torch.Tensor, edges: Dict[int, tuple],
                params: Dict[str, torch.Tensor], layers: int,
                train_idx: torch.Tensor, train_y: torch.Tensor,
                num_classes: int, lr: float, weight_decay: float,
                steps: int = 3, precision: str = "float64") -> dict:
    """Run ``steps`` training steps from ``params`` over the relations
    ``edges`` ({r: (src, dst)}, each edge sending dst's row into src's) and
    return {losses, grad1: the first decayed gradient's norm a leaf,
    delta: the norm a leaf of the change after the steps}."""
    dt = dtype_of(precision)
    n = x.shape[0]
    xd = x.to(dt)
    rels = {r: relation_edges(s, d, n, dt) for r, (s, d) in edges.items()
            if s.numel()}
    p = {k: v.detach().to(dt).clone().requires_grad_(True)
         for k, v in params.items()}
    p0 = {k: v.detach().clone() for k, v in p.items()}
    w = balanced_weights(train_y, num_classes, dt)
    opt = Adam(p, lr, weight_decay)
    losses, grad1 = [], None
    for t in range(steps):
        logp = forward(xd, rels, p, layers, precision, train_idx)
        per = -logp.gather(1, train_y[:, None])[:, 0]
        loss = (per * w).sum() / w.sum()
        grads = torch.autograd.grad(loss, list(p.values()))
        got = opt.step(p, dict(zip(p.keys(), grads)))
        losses.append(float(loss.detach()))
        if t == 0:
            grad1 = {k: float(g.norm()) for k, g in got.items()}
        del logp, per, loss, grads
    delta = {k: float((p[k].detach() - p0[k]).norm()) for k in p}
    return {"losses": losses, "grad1": grad1, "delta": delta}


def _relation_cost(rel: dict, width: int, out: int, num_nodes: int,
                   constant: bool, grad_input: bool) -> Work:
    """One relation's term of a layer at the cheaper of its two orders:
    aggregate the ``width``-wide rows, then the product on the rows with
    edges; or the product on the distinct destinations, then aggregate
    ``out``-wide rows. A ``constant`` aggregation (of the features) is
    computed before the epochs: the first order then counts its product
    alone. An aggregation in the step reads its CSR, and its transpose's
    where the backward runs it."""
    e, n = rel["edges"], num_nodes
    agg_first = Work().matmul(rel["rows"], width, out, grad_input)
    if not constant:
        agg_first.aggregate(e, width, backward=grad_input).csr(e, n)
        if grad_input:
            agg_first.csr(e, n)
    transform_first = Work().matmul(rel["cols"], width, out, grad_input)
    transform_first.aggregate(e, out).csr(e, n).csr(e, n)
    return min(agg_first, transform_first, key=lambda w: w.flops)


def step_work(num_nodes: int, feat_dim: int, hidden: int, out_dim: int,
              classes: int, layers: int, train_rows: int,
              relations: Sequence[dict], tail: Sequence[dict],
              num_params: int) -> Work:
    """One epoch's operations and bytes (``perfbench.work``).
    ``relations[r]`` describes relation r over the graph: {edges, rows
    (sources with edges), cols (distinct destinations)}; ``tail[r]`` the
    same of its edges whose source is a train row. Layer 0's aggregations
    of the features are constants of the run. The last layer and the head
    are counted at the train rows, the rows the loss reads; every other
    layer at all N."""
    n = num_nodes
    w = Work()
    w.read(F32 * feat_dim * (n + sum(r["rows"] for r in relations)))
    for layer in range(layers):
        last = layer == layers - 1
        width = feat_dim if layer == 0 else hidden
        out = hidden if layer == 0 else out_dim
        rows = train_rows if last else n
        for rel in (tail if last else relations):
            if rel["edges"]:
                term = _relation_cost(rel, width, out, n, layer == 0,
                                      layer > 0)
                w.flops += term.flops
                w.bytes += term.bytes
        # h @ root; the relation terms' sum, the bias and ReLU
        w.matmul(rows, width, out, grad_input=layer > 0)
        w.elementwise(rows * out, flops=2.0)
        w.elementwise(sum(r["rows"] for r in (tail if last else relations))
                      * out)
    w.matmul(train_rows, out_dim, classes)
    w.elementwise(train_rows * classes, flops=5.0)    # bias, log_softmax
    w.read(train_rows * (2 * I64 + F32))              # rows, labels, weights
    w.elementwise(train_rows, flops=3.0)              # the NLL
    w.adam(num_params)
    return w


def relation_shapes(src: torch.Tensor, dst: torch.Tensor,
                    train_mask: Optional[torch.Tensor] = None) -> dict:
    """{edges, rows, cols} of one relation's edges, or with ``train_mask``
    ([N] bool) of those whose source it marks."""
    if train_mask is not None:
        keep = train_mask[src]
        src, dst = src[keep], dst[keep]
    return {"edges": int(src.numel()), "rows": distinct(src),
            "cols": distinct(dst)}


def epoch_shapes(edges: Dict[int, tuple], num_nodes: int,
                 train_idx: torch.Tensor) -> List[List[dict]]:
    """[relations, tail] of ``step_work`` from the relations' edges."""
    mask = torch.zeros(num_nodes, dtype=torch.bool, device=train_idx.device)
    mask[train_idx] = True
    order = sorted(edges)
    return [[relation_shapes(*edges[r]) for r in order],
            [relation_shapes(*edges[r], train_mask=mask) for r in order]]

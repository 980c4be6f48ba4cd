"""Plain reference of HGT's training step (Hu, Dong, Wang and Sun, WWW
2020, arXiv:2003.01332), written per edge from the paper's equations. For
target t, source s, edge e of relation r, head i of H, d_k = D / H and
node type tau:

    K(s)_i = K-Linear_tau(s)(H[s])_i,   Q(t)_i = Q-Linear_tau(t)(H[t])_i
    ATT(e)_i = K(s)_i W^ATT_{r,i} Q(t)_i^T mu_{r,i} / sqrt(d_k)
    A(e)_i = softmax of ATT(.)_i over every edge of t, all relations
             (eq. 3-4)
    MSG(e)_i = V-Linear_tau(s)(H[s])_i W^MSG_{r,i}               (eq. 5)
    H~[t]_i = sum over e of t of A(e)_i MSG(e)_i                   (eq. 6)
    H'[t] = alpha_tau A-Linear_tau(GELU(H~[t])) + (1 - alpha_tau) H[t]

alpha_tau = sigmoid(skip_tau), the gated skip of pyHGT and PyG's
``HGTConv`` (eq. 7). Around the layers, as PyG's ``hgt_dblp.py``: a typed
Linear and ReLU to the hidden width, then a Linear to the classes and
log_softmax; the NLL is the unweighted mean over the train rows; Adam with
L2 decay. No relative temporal encoding, LayerNorm or dropout. Relation
r's edges (src, dst) write src's row: t = src, s = dst. ``softmax=
'relation'`` normalises over each relation of t apart instead (PyG up to
2.2), for the tests that tell the two apart.

Typed Linears run on each type's rows by index, keeping only their input;
the attention per edge, one relation at a time, in blocks of
``EDGE_BLOCK`` edges. The attention's backward recomputes each block, so
no [E, D] tensor is kept; each layer is recomputed in the backward
(``torch.utils.checkpoint``); the last layer, whose rows the loss reads
alone, runs at those rows: so a float64 run at ogbn-mag's size fits on the
card. Also the step's
operations and bytes, and the attention's, from these equations. Nothing
here imports the program."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import Adam, dtype_of, mm, tf32
from perfbench.work import F32, I32, I64, Work, distinct

# edges a block of the per-edge products
EDGE_BLOCK = 1 << 18


def _rt(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand of a product, rounded to TF32 in the control."""
    return tf32(x) if precision == "tf32" else x


def _rel_product(x: torch.Tensor, w: torch.Tensor, precision: str,
                 transpose: bool = False) -> torch.Tensor:
    """[B, H, d] rows times the per-head [H, d, d] matrices (or their
    transposes)."""
    w = w.transpose(1, 2) if transpose else w
    return torch.einsum("bhd,hde->bhe", _rt(x, precision), _rt(w, precision))


class _Attention(torch.autograd.Function):
    """H~ [T, D] of eq. 3-6 per edge: ``t``, ``s``, ``r`` [E] each edge's
    target, source and relation, grouped by relation (``segs``: (r, first,
    end) of each group); ``group`` [E] the softmax's group of each edge
    (its target, or its (target, relation))."""

    @staticmethod
    def forward(ctx, q, k, v, w_att, w_msg, t, s, group, segs, num_rows,
                heads, precision):
        e, d = t.numel(), q.shape[1]
        dk = d // heads
        q3, k3, v3 = (a.view(-1, heads, dk) for a in (q, k, v))
        score = q.new_empty((e, heads))
        for r, lo, hi in segs:
            for a in range(lo, hi, EDGE_BLOCK):
                b = min(a + EDGE_BLOCK, hi)
                kw = _rel_product(k3[s[a:b]], w_att[r], precision)
                score[a:b] = (kw * q3[t[a:b]]).sum(-1)
        groups = int(group.max()) + 1 if e else 0
        idx = group[:, None].expand(e, heads)
        m = score.new_full((groups, heads), -math.inf).scatter_reduce(
            0, idx, score, "amax")
        p = torch.exp(score - m[group])
        del score
        den = p.new_zeros((groups, heads)).index_add_(0, group, p)
        att = p / den[group]
        del p
        out = q.new_zeros((num_rows, heads, dk))
        for r, lo, hi in segs:
            for a in range(lo, hi, EDGE_BLOCK):
                b = min(a + EDGE_BLOCK, hi)
                msg = _rel_product(v3[s[a:b]], w_msg[r], precision)
                out.index_add_(0, t[a:b], msg * att[a:b, :, None])
        ctx.save_for_backward(q, k, v, w_att, w_msg, t, s, group, att)
        ctx.segs, ctx.heads, ctx.precision = segs, heads, precision
        return out.view(num_rows, d)

    @staticmethod
    def backward(ctx, g):
        q, k, v, w_att, w_msg, t, s, group, att = ctx.saved_tensors
        segs, heads, p = ctx.segs, ctx.heads, ctx.precision
        dk = q.shape[1] // heads
        q3, k3, v3 = (a.view(-1, heads, dk) for a in (q, k, v))
        g3 = g.contiguous().view(-1, heads, dk)
        gq, gk, gv = (torch.zeros_like(a) for a in (q3, k3, v3))
        g_att, g_msg = torch.zeros_like(w_att), torch.zeros_like(w_msg)
        datt = torch.empty_like(att)
        for r, lo, hi in segs:
            for a in range(lo, hi, EDGE_BLOCK):
                b = min(a + EDGE_BLOCK, hi)
                vs = v3[s[a:b]]
                gt = g3[t[a:b]]
                datt[a:b] = (gt * _rel_product(vs, w_msg[r], p)).sum(-1)
                dmsg = gt * att[a:b, :, None]
                gv.index_add_(0, s[a:b],
                              _rel_product(dmsg, w_msg[r], p, True))
                g_msg[r] += torch.einsum("bhd,bhe->hde", _rt(vs, p),
                                         _rt(dmsg, p))
        groups = int(group.max()) + 1 if att.shape[0] else 0
        dot = att.new_zeros((groups, heads)).index_add_(0, group,
                                                        att * datt)
        dscore = att * (datt - dot[group])
        del datt, dot
        for r, lo, hi in segs:
            for a in range(lo, hi, EDGE_BLOCK):
                b = min(a + EDGE_BLOCK, hi)
                ks = k3[s[a:b]]
                ds = dscore[a:b, :, None]
                gq.index_add_(0, t[a:b],
                              ds * _rel_product(ks, w_att[r], p))
                dkw = ds * q3[t[a:b]]
                gk.index_add_(0, s[a:b],
                              _rel_product(dkw, w_att[r], p, True))
                g_att[r] += torch.einsum("bhd,bhe->hde", _rt(ks, p),
                                         _rt(dkw, p))
        return (gq.view(q.shape), gk.view(k.shape), gv.view(v.shape), g_att,
                g_msg) + (None,) * 7


def relation_edges(edges: Dict[int, tuple], num_rel: int,
                   softmax: str = "node",
                   rows: Optional[torch.Tensor] = None,
                   num_nodes: int = 0) -> tuple:
    """(t, s, group, segs) of the relations' edges ({r: (src, dst)}, t =
    src, s = dst), grouped by relation: ``segs`` (r, first, end) of each
    relation with edges; ``group`` each edge's softmax group, its target
    (``softmax='node'``, eq. 3) or its (target, relation) pair
    (``'relation'``). With ``rows`` (of ``num_nodes``) only the edges into
    those rows, t their positions in ``rows``."""
    if softmax not in ("node", "relation"):
        raise ValueError("softmax is over a node's edges ('node') or each "
                         "relation's ('relation')")
    pos = None
    if rows is not None:
        pos = torch.full((num_nodes,), -1, dtype=torch.long,
                         device=rows.device)
        pos[rows] = torch.arange(rows.numel(), device=rows.device)
    ts, ss, segs, at = [], [], [], 0
    for r in sorted(edges):
        src, dst = edges[r]
        if pos is not None:
            src = pos[src]
            keep = src >= 0
            src, dst = src[keep], dst[keep]
        if src.numel():
            ts.append(src)
            ss.append(dst)
            segs.append((r, at, at + src.numel()))
            at += src.numel()
    t, s = torch.cat(ts), torch.cat(ss)
    if softmax == "node":
        group = t
    else:
        rel = torch.cat([torch.full_like(a, r) for a, (r, _, _)
                         in zip(ts, segs)])
        group = t * num_rel + rel
    return t, s, group, tuple(segs)


class _Typed(torch.autograd.Function):
    """Each type's Linear on its rows (``type_idx[tau]``, by index),
    keeping only its input for the backward."""

    @staticmethod
    def forward(ctx, h, w, b, type_idx, precision):
        out = h.new_empty((h.shape[0], w.shape[2]))
        for tau, idx in enumerate(type_idx):
            if idx.numel():
                out[idx] = _rt(h[idx], precision) @ _rt(w[tau], precision) \
                    + b[tau]
        ctx.save_for_backward(h, w)
        ctx.type_idx, ctx.precision = type_idx, precision
        return out

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        p = ctx.precision
        gh = torch.zeros_like(h) if ctx.needs_input_grad[0] else None
        gw = torch.zeros_like(w)
        gb = g.new_zeros((w.shape[0], w.shape[2]))
        for tau, idx in enumerate(ctx.type_idx):
            if idx.numel():
                gi = g[idx]
                if gh is not None:
                    gh[idx] = _rt(gi, p) @ _rt(w[tau], p).T
                gw[tau] = _rt(h[idx], p).T @ _rt(gi, p)
                gb[tau] = gi.sum(0)
        return gh, gw, gb, None, None


def _types(node_type: torch.Tensor, num_types: int) -> List[torch.Tensor]:
    return [torch.nonzero(node_type == tau).flatten()
            for tau in range(num_types)]


def _layer(h, p, l, types, row_types, rows, alpha_rows, rel, heads,
           precision):
    """Layer l's H' at ``rows`` (every row where None) from H."""
    pre = f"layers.{l}."
    t, s, group, segs = rel
    hq = h if rows is None else h[rows]
    k = _Typed.apply(h, p[pre + "k_w"], p[pre + "k_b"], types, precision)
    v = _Typed.apply(h, p[pre + "v_w"], p[pre + "v_b"], types, precision)
    q = _Typed.apply(hq, p[pre + "q_w"], p[pre + "q_b"], row_types,
                     precision)
    w_att = p[pre + "att"] * (p[pre + "mu"] / math.sqrt(
        h.shape[1] // heads))[:, :, None, None]
    o = _Attention.apply(q, k, v, w_att, p[pre + "msg"], t, s, group, segs,
                         hq.shape[0], heads, precision)
    del k, v, q
    a = _Typed.apply(F.gelu(o), p[pre + "a_w"], p[pre + "a_b"], row_types,
                     precision)
    alpha = torch.sigmoid(p[pre + "skip"])[alpha_rows][:, None]
    return alpha * a + (1.0 - alpha) * hq


def forward(x: torch.Tensor, node_type: torch.Tensor, num_types: int,
            rel: tuple, rel_rows: tuple, p: Dict[str, torch.Tensor],
            layers: int, heads: int, precision: str, rows: torch.Tensor
            ) -> torch.Tensor:
    """[len(rows), C] log-probabilities of the rows ``rows``: every layer
    on every row, but the last, which the loss reads at ``rows`` alone.
    ``rel`` is ``relation_edges`` of the relations, ``rel_rows`` the same
    at ``rows``. Each layer is recomputed in the backward."""
    types = _types(node_type, num_types)
    row_types = _types(node_type[rows], num_types)
    h = torch.relu(_Typed.apply(x, p["inp_w"], p["inp_b"], types,
                                precision))
    for l in range(layers):
        last = l == layers - 1
        h = checkpoint(_layer, h, p, l, types, row_types if last else types,
                       rows if last else None,
                       node_type[rows] if last else node_type,
                       rel_rows if last else rel, heads, precision,
                       use_reentrant=False)
    return torch.log_softmax(mm(h, p["linear.weight"].T, precision)
                             + p["linear.bias"], dim=1)


def train_steps(x: torch.Tensor, node_type: torch.Tensor, num_types: int,
                edges: Dict[int, tuple], num_rel: int,
                params: Dict[str, torch.Tensor], layers: int, heads: int,
                train_idx: torch.Tensor, train_y: torch.Tensor, lr: float,
                weight_decay: float, steps: int = 3,
                precision: str = "float64", softmax: str = "node") -> dict:
    """Run ``steps`` training steps from ``params`` over the relations
    ``edges`` ({r: (src, dst)}, each edge sending dst's row into src's) and
    return {losses, grad1: the first decayed gradient's norm a leaf,
    delta: the norm a leaf of the change after the steps}."""
    dt = dtype_of(precision)
    n = x.shape[0]
    rel = relation_edges(edges, num_rel, softmax)
    rel_rows = relation_edges(edges, num_rel, softmax, train_idx, n)
    xd = x.to(dt)
    p = {k: v.detach().to(dt).clone().requires_grad_(True)
         for k, v in params.items()}
    p0 = {k: v.detach().clone() for k, v in p.items()}
    opt = Adam(p, lr, weight_decay)
    losses, grad1 = [], None
    for step in range(steps):
        logp = forward(xd, node_type, num_types, rel, rel_rows, p, layers,
                       heads, precision, train_idx)
        loss = -logp.gather(1, train_y[:, None])[:, 0].mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        got = opt.step(p, dict(zip(p.keys(), grads)))
        losses.append(float(loss.detach()))
        if step == 0:
            grad1 = {k: float(g.norm()) for k, g in got.items()}
        del logp, loss, grads
    delta = {k: float((p[k].detach() - p0[k]).norm()) for k in p}
    return {"losses": losses, "grad1": grad1, "delta": delta}


# ------------------------------------------------------------- the count
def layer_shapes(edges: Dict[int, tuple], num_nodes: int,
                 rows: Optional[torch.Tensor] = None) -> dict:
    """{rows, edges, sources, rel_rows} of one layer: the target rows it
    writes (every node, or ``rows``), the edges into them, their distinct
    source nodes, and over the relations the rows at which their per-head
    products are cheapest (the fewer of their distinct targets and
    sources)."""
    mask = None
    if rows is not None:
        mask = torch.zeros(num_nodes, dtype=torch.bool,
                           device=rows.device)
        mask[rows] = True
    srcs, count, rel_rows = [], 0, 0
    for r in sorted(edges):
        t, s = edges[r]
        if mask is not None:
            keep = mask[t]
            t, s = t[keep], s[keep]
        if t.numel():
            count += t.numel()
            srcs.append(s)
            rel_rows += min(distinct(t), distinct(s))
    return {"rows": num_nodes if rows is None else int(rows.numel()),
            "edges": count,
            "sources": distinct(torch.cat(srcs)) if srcs else 0,
            "rel_rows": rel_rows}


def attention_bytes(rows: int, edges: int, sources: int, width: int,
                    heads: int) -> float:
    """One layer's attention, forward and backward, at its least bytes:
    Q of the rows and K and V of the sources read once, the CSR read, out
    and lse written; the backward reads the output's gradient, out, lse,
    Q, K, V and the CSR and writes the gradients of Q, K and V."""
    csr = I32 * (edges + rows + 1)
    fwd = F32 * (rows * width + 2 * sources * width) + csr \
        + F32 * rows * (width + heads)
    bwd = F32 * (3 * rows * width + rows * heads + 2 * sources * width) \
        + csr + F32 * (rows * width + 2 * sources * width)
    return float(fwd + bwd)


def step_work(num_nodes: int, feat_dim: int, hidden: int, heads: int,
              classes: int, shapes: Sequence[dict], num_params: int
              ) -> Work:
    """One epoch's operations and bytes (``perfbench.work``);
    ``shapes[l]`` is ``layer_shapes`` of layer l, the last at the train
    rows. Every typed product and every per-head relation product is
    counted forward and both gradients (the features' Linear without its
    input's); an edge costs two 256-wide products forward (its score and
    its share of the weighted sum) and four backward (the score's and the
    message's gradients, and their sums into Q, K and V)."""
    n, w = num_nodes, Work()
    dk = hidden // heads
    w.read(F32 * feat_dim * n)
    w.matmul(n, feat_dim, hidden, grad_input=False)
    w.elementwise(n * hidden)                           # ReLU
    for sh in shapes:
        rows = sh["rows"]
        w.matmul(n, hidden, hidden).matmul(n, hidden, hidden)      # K, V
        w.matmul(rows, hidden, hidden)                              # Q
        w.flops += 2 * 2.0 * sh["rel_rows"] * hidden * dk * 3      # W^ATT, W^MSG
        w.flops += 2.0 * hidden * sh["edges"] * 6
        w.elementwise(sh["edges"] * heads, flops=5.0)   # softmax
        w.csr(sh["edges"], rows).csr(sh["edges"], sh["sources"])
        w.elementwise(rows * hidden, flops=8.0)         # GELU
        w.matmul(rows, hidden, hidden)                  # A-Linear
        w.elementwise(rows * hidden, flops=3.0)         # the gate
    t = shapes[-1]["rows"]
    w.matmul(t, hidden, classes)
    w.elementwise(t * classes, flops=5.0)               # bias, log_softmax
    w.read(t * 2 * I64)                                 # rows, labels
    w.elementwise(t, flops=2.0)                         # the NLL
    w.adam(num_params)
    return w

"""Plain reference of MPNetm's training step (the reference's model.py:
179-228 and main.py:1117-1160): per metapath a stack of single-relation
convs ``mean_r(h) @ W + h @ root + b`` with ReLU and dropout after each
hop, the embeddings concatenated, fc1, ReLU, fc2, log_softmax; the mean
NLL over the train rows; Adam with L2 decay. The hop-0 aggregation of the
features is a constant of the run. Dropout draws one float32 mask a hop in
hop order from a generator seeded as the program's, on the same device.

Also the step's operations and bytes, from these equations."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from perfbench.reference.common import Adam, dtype_of, mean_aggregate, mm
from perfbench.work import F32, I64, Work


def forward(x, agg0, edges, metapaths, p, precision, num_nodes, gen,
            dropout):
    """[N, C] log-probabilities of one training forward."""
    dt = dtype_of(precision)
    scale = float(torch.tensor(1.0 - dropout, dtype=torch.float32))
    embs = []
    for i, mp in enumerate(metapaths):
        h = x
        for j, rel in enumerate(mp):
            agg = agg0[i] if j == 0 else mean_aggregate(h, *edges[rel],
                                                        num_nodes)
            pre = f"convs.{i}.{j}."
            z = (mm(agg, p[pre + "weight"], precision)
                 + mm(h, p[pre + "root"], precision) + p[pre + "bias"])
            h = torch.relu(z)
            if dropout > 0.0:
                draw = torch.rand(h.shape, generator=gen, device=h.device)
                h = torch.where(draw < 1.0 - dropout, h / scale,
                                torch.zeros((), dtype=dt, device=h.device))
        embs.append(h)
    h = torch.relu(mm(torch.cat(embs, 1), p["fc1.weight"].T, precision)
                   + p["fc1.bias"])
    h = mm(h, p["fc2.weight"].T, precision) + p["fc2.bias"]
    return torch.log_softmax(h, dim=1)


def train_steps(x: torch.Tensor, edges: Dict[int, tuple],
                metapaths: Sequence[Sequence[int]],
                params: Dict[str, torch.Tensor], train_idx: torch.Tensor,
                train_y: torch.Tensor, row_w: torch.Tensor, drop_seed: int,
                dropout: float, lr: float, weight_decay: float,
                steps: int = 3, precision: str = "float64") -> dict:
    """Run ``steps`` training steps from ``params`` and return {losses,
    grad1: the first decayed gradient's norm a leaf, delta: the norm a
    leaf of the change after the steps}."""
    dt = dtype_of(precision)
    n = x.shape[0]
    xd = x.to(dt)
    p = {k: v.detach().to(dt).clone().requires_grad_(True)
         for k, v in params.items()}
    p0 = {k: v.detach().clone() for k, v in p.items()}
    with torch.no_grad():
        agg0 = [mean_aggregate(xd, *edges[mp[0]], n) for mp in metapaths]
    w = row_w.to(dt)
    gen = torch.Generator(device=x.device).manual_seed(drop_seed)
    opt = Adam(p, lr, weight_decay)
    losses, grad1 = [], None
    for t in range(steps):
        logp = forward(xd, agg0, edges, metapaths, p, precision, n, gen,
                       dropout)
        per = -logp[train_idx].gather(1, train_y[:, None])[:, 0]
        loss = (per * w).sum() / w.sum()
        grads = torch.autograd.grad(loss, list(p.values()))
        got = opt.step(p, dict(zip(p.keys(), grads)))
        losses.append(float(loss.detach()))
        if t == 0:
            grad1 = {k: float(g.norm()) for k, g in got.items()}
        del logp, per, loss, grads
    delta = {k: float((p[k].detach() - p0[k]).norm()) for k in p}
    return {"losses": losses, "grad1": grad1, "delta": delta}


def step_work(num_nodes: int, feat_dim: int, hidden: int, classes: int,
              train_rows: int, metapaths: List[List[dict]],
              num_params: int) -> Work:
    """One epoch's operations and bytes (``perfbench.work``).
    ``metapaths[m][j]`` describes hop j's relation: {edges, rows (sources
    with edges), cols (distinct destinations)}. Hop 0's aggregation is a
    constant of the run: the epoch reads it and does not compute it."""
    n, h, c = num_nodes, hidden, classes
    w = Work()
    w.read(F32 * n * feat_dim * (1 + len(metapaths)))  # x, hop-0 constants
    for mp in metapaths:
        for j, rel in enumerate(mp):
            width = feat_dim if j == 0 else h
            if j > 0:
                w.aggregate(rel["edges"], h)
                w.csr(rel["edges"], n).csr(rel["edges"], n)
            # agg @ W and h @ root; the bias, ReLU and dropout
            w.matmul(n, width, h, grad_input=j > 0)
            w.matmul(n, width, h, grad_input=j > 0)
            w.elementwise(n * h, flops=4.0)
    k = len(metapaths)
    w.matmul(n, k * h, h)
    w.elementwise(n * h, flops=2.0)
    w.matmul(n, h, c)
    w.elementwise(n * c, flops=5.0)                   # bias, log_softmax
    w.read(train_rows * (2 * I64 + F32))              # rows, labels, weights
    w.elementwise(train_rows, flops=3.0)              # the NLL
    w.adam(num_params)
    return w

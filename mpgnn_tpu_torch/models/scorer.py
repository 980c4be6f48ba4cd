"""RelationScorer: the per-relation scoring model, its batched sweep steps
and the optimizer the sweeps train it with.

Counterpart of ``mpgnn_tpu/models/scorer.py`` (the reference's ``Score``
model, model.py:26-125): one trainable weight per graph node plus a
bias-free feature-attribution vector ``u``; per source (flat mode) or per
bag (bag mode) the forward picks the largest weight among the reachable
destinations, ties to the first in file order.

* flat mode: ``pred[s] = w[argmax_{d in N_r(s)} w[d]]``, 0 for a source
  without edges of the relation;
* bag mode: member value ``max_d w[d] * (x[s] . u)``, bag prediction the
  largest member value;
* the gradient reaches only the selected elements.

The sweeps of ``search/scoring.py`` train R relations at once on a leading
``R`` axis (one relation is R = 1) with the ``*_forward_*`` and ``*_grad*``
functions below, whose backward is written out: the gradient is a sorted
accumulation (``index_put_(..., accumulate=True)``, sequential on the CPU,
sort-based on the GPU), so two runs give the same bits. ``Adam``
reproduces ``optax.adam`` to the bit on the CPU. The inits are drawn on the
host, in numpy.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = float("-inf")


class ScorerParams(NamedTuple):
    """One scorer's parameters (or R scorers' on a leading axis): numpy
    arrays where the inits draw them on the host, tensors in the sweeps."""

    w: torch.Tensor  # [..., N] per-node weights (InputLayer, model.py:26-34)
    u: torch.Tensor  # [..., F] LinearLayerAttri weight (model.py:41)


def init_weights(
    rng: np.random.Generator,
    num_nodes: int,
    dest_nodes: np.ndarray,
    dest_min_label: np.ndarray,
    noise: float = 0.2,
) -> np.ndarray:
    """Label-informed node weights (main.py:479-497), float32 [N]:
    ``|min(src labels) + U(-noise, noise)|`` on destination nodes, U(0, 1)
    elsewhere, drawn from ``rng`` in the JAX package's order."""
    w = rng.uniform(0.0, 1.0, size=num_nodes).astype(np.float32)
    if len(dest_nodes):
        w[dest_nodes] = np.abs(
            dest_min_label + rng.uniform(-noise, noise, size=len(dest_nodes))
        ).astype(np.float32)
    return w


def init_attribution(rng: np.random.Generator, feat_dim: int,
                     rows: Optional[int] = None) -> np.ndarray:
    """``u`` as ``torch.nn.Linear(F, 1, bias=False)`` draws it,
    U(-1/sqrt(F), 1/sqrt(F)), float32 [F] (or [rows, F])."""
    bound = 1.0 / np.sqrt(feat_dim)
    shape = feat_dim if rows is None else (rows, feat_dim)
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def init_scorer_params(
    rng: np.random.Generator,
    num_nodes: int,
    feat_dim: int,
    dest_nodes: np.ndarray,
    dest_min_label: np.ndarray,
    noise: float = 0.2,
) -> ScorerParams:
    """Label-informed init of one scorer (main.py:479-497): ``init_weights``
    then ``init_attribution``, as host arrays."""
    w = init_weights(rng, num_nodes, dest_nodes, dest_min_label, noise)
    return ScorerParams(w=w, u=init_attribution(rng, feat_dim))


def reinitialize_scorer_weights(
    rng: np.random.Generator, prev_w: np.ndarray, frozen_mask: np.ndarray
) -> np.ndarray:
    """Restart re-init (main.py:499-516): frozen destinations keep their
    previous weight, every other entry U(0, 1)."""
    w = rng.uniform(0.0, 1.0, size=len(prev_w)).astype(np.float32)
    w[frozen_mask] = prev_w[frozen_mask]
    return w


def clamp_params(params: ScorerParams, lo: float = 0.0,
                 hi: float = 1.0) -> ScorerParams:
    """Post-step projection (main.py:667-669): node weights and the
    attribution vector clamped to [0, 1]."""
    return ScorerParams(w=params.w.clamp(lo, hi), u=params.u.clamp(lo, hi))


def apply_freeze(params: ScorerParams, frozen_mask: Optional[torch.Tensor],
                 frozen_values: Optional[torch.Tensor]) -> ScorerParams:
    """Restore frozen destination weights after a step (main.py:670-672)."""
    if frozen_mask is None:
        return params
    return params._replace(w=torch.where(frozen_mask, frozen_values, params.w))


# ------------------------------------------------------------------ Adam
def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return (a.double() * float(np.float32(b)) + c.double()).float()


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64; the CPU's
    vectorised float32 ``sqrt`` is not always)."""
    return torch.sqrt(x.double()).float()


def _bias_corrections(decay: float, steps: int, device) -> torch.Tensor:
    """[steps] ``1 - decay ** t`` for t = 1..steps in float32, the power
    correctly rounded (as XLA's), on ``device``."""
    t = np.arange(1, steps + 1)
    return torch.as_tensor(
        np.float32(1) - (np.float64(np.float32(decay)) ** t).astype(
            np.float32), device=device)


class Adam:
    """``optax.adam(lr)`` over a list of tensors, each with any leading
    batch axes; ``update`` returns the stepped tensors.

    The arithmetic is that of the JAX package's compiled sweep on the CPU,
    where XLA contracts the moment updates and the parameter update into
    fused multiply-adds and rewrites ``(mu / bc1) / (sqrt(nu / bc2) + eps)``
    as ``mu / (bc1 * (sqrt(nu / bc2) + eps))``; ``tests/test_torch_scorer.py``
    holds it bitwise against ``optax.adam`` scanned over epochs."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0
        self._bc = None    # bias corrections of steps 1..len, on the device

    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        self.count += 1
        if self._bc is None or self._bc[0].numel() < self.count:
            steps = 2 * max(self.count, 64)
            dev = params[0].device
            self._bc = (_bias_corrections(self.b1, steps, dev),
                        _bias_corrections(self.b2, steps, dev))
        # 0-dim device tensors: the step reads them with no copy
        bc1, bc2 = self._bc[0][self.count - 1], self._bc[1][self.count - 1]
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            mu = _fma(self.mu[i], self.b1, g * (1 - self.b1))
            nu = _fma(self.nu[i], self.b2, (g * g) * (1 - self.b2))
            self.mu[i], self.nu[i] = mu, nu
            upd = mu / (bc1 * (_sqrt32(nu / bc2) + self.eps))
            out.append(_fma(upd, -self.lr, p))
        return out


# ------------------------------------------------------ batched sweep steps
def seg_first_max(
    vals: torch.Tensor,   # [R, E] values, pads -inf
    seg: torch.Tensor,    # [R, E] flat segment ids (row r in [r*S, (r+1)*S))
    em: torch.Tensor,     # [R, E] real-entry mask
    has: torch.Tensor,    # [R, S] segment has a real entry
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (max value, first maximal entry index) of R rows of
    segmented values: the segment maximum by one ``amax`` reduction, then
    the lowest entry index holding it by one ``amin`` reduction. Entries
    are sorted by segment in file order, so the lowest index is the first
    occurrence (model.py:85). Segments without a real entry give (-inf, 0).
    Both reductions are exact, so the result does not depend on their
    order of evaluation."""
    R, E = vals.shape
    S = has.shape[1]
    flat = seg.reshape(-1)
    mx = vals.new_full((R * S,), NEG_INF).scatter_reduce_(
        0, flat, vals.reshape(-1), "amax", include_self=False)
    eidx = torch.arange(E, device=vals.device).expand(R, E)
    cand = torch.where(em & (vals == mx[seg]), eidx, E)
    win = torch.full((R * S,), E, dtype=torch.long,
                     device=vals.device).scatter_reduce_(
        0, flat, cand.reshape(-1), "amin", include_self=False)
    return (torch.where(has, mx.view(R, S), NEG_INF),
            torch.where(has, win.view(R, S), 0))


def _accumulate(size: int, idx: torch.Tensor, vals: torch.Tensor,
                live: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``zeros(size)`` with ``vals`` added at ``idx``, duplicates summed in
    a fixed order (sequential on the CPU, sorted on the GPU). Entries where
    ``live`` is false hold 0 and are added at their own position instead:
    adding 0 changes no sum, and rows without an edge, whose winner index
    is a placeholder shared by all of them, would otherwise pile onto one
    index, which the GPU's sorted accumulation walks serially."""
    own = torch.arange(idx.numel(), device=idx.device).view_as(idx) % size
    return like.new_zeros(size).index_put_(
        (torch.where(live, idx, own).reshape(-1),), vals.reshape(-1),
        accumulate=True)


def flat_forward_ell(w, nbr, mask, has_edge):
    """Flat forward of R relations in ELL form: w [R, N]; nbr [R, N, D]
    flat ids into ``w.view(-1)``; mask [R, N, D]; has_edge [R, N]. Returns
    (pred [R, N], winner [R, N] flat ids)."""
    wv = w.reshape(-1)
    vals = torch.where(mask, wv[nbr], NEG_INF)
    win = nbr.gather(-1, vals.argmax(-1, keepdim=True)).squeeze(-1)
    return torch.where(has_edge, wv[win], 0.0), win


def flat_forward_seg(w, src, dst, em, has):
    """Flat forward of R relations in segment form, each in its compact
    node space: w [R, C]; src/dst [R, E] flat ids into ``w.view(-1)``
    (src sorted per row); em [R, E]; has [R, C]. Returns (pred [R, C],
    winner [R, C] flat ids)."""
    wv = w.reshape(-1)
    vals = torch.where(em, wv[dst], NEG_INF)
    _, win_e = seg_first_max(vals, src, em, has)
    win = dst.gather(1, win_e)
    return torch.where(has, wv[win], 0.0), win


def flat_grad(w, pred, win, has, y, ct):
    """Gradient in w of ``sum((pred - y)^2 * lmask) / denom``, with
    ``ct = (1 / denom) * lmask``: each source's term goes to its winner."""
    g = torch.where(has, ct * (2.0 * (pred - y)), 0.0)
    return _accumulate(w.numel(), win, g, has, w).view_as(w)


def flat_loss(pred, y, lmask, denom, const=None):
    """[R] ``(sum((pred - y)^2 * lmask) + const) / denom``."""
    d = pred - y
    s = (d * d * lmask).sum(-1)
    return (s if const is None else s + const) / denom


class BagForward(NamedTuple):
    lin: torch.Tensor           # [R, S] x . u per node
    member_winner: torch.Tensor  # [R, S] flat ids of each member's winner
    member_value: torch.Tensor  # [R, S]
    pred: torch.Tensor          # [R, B]
    bag_member: torch.Tensor    # [R, B] flat ids of each bag's winning member


def bag_forward_ell(w, u, x, nbr, mask, has_edge, bags, mmask, any_member):
    """Bag forward of R instances in ELL form: w [R, N], u [R, F], x [N, F],
    nbr/mask [R, N, D] (flat ids), has_edge [R, N], bags/mmask [R, B, M]
    (flat member ids), any_member [R, B]."""
    wv = w.reshape(-1)
    lin = u @ x.T
    prod = torch.where(mask, wv[nbr] * lin.unsqueeze(-1), NEG_INF)
    mwin = nbr.gather(-1, prod.argmax(-1, keepdim=True)).squeeze(-1)
    mval = torch.where(has_edge, wv[mwin] * lin, 0.0)
    vals = torch.where(mmask, mval.reshape(-1)[bags], NEG_INF)
    m = vals.argmax(-1, keepdim=True)
    pred = torch.where(any_member, vals.gather(-1, m).squeeze(-1), 0.0)
    return BagForward(lin, mwin, mval, pred, bags.gather(-1, m).squeeze(-1))


def bag_forward_seg(w, u, x, src, dst, em, has, mn, mb, mm, bhas):
    """Bag forward of R instances in segment form, each in its compact node
    space: w [R, C], u [R, F], x [R, C, F]; src/dst/em [R, E] (flat ids,
    src sorted); has [R, C]; bags flattened into member segments mn/mb/mm
    [R, P] (flat member ids, flat bag ids sorted per row); bhas [R, B]."""
    wv = w.reshape(-1)
    lin = torch.bmm(x, u.unsqueeze(-1)).squeeze(-1)
    vals = torch.where(em, wv[dst] * lin.reshape(-1)[src], NEG_INF)
    _, win_e = seg_first_max(vals, src, em, has)
    mwin = dst.gather(1, win_e)
    mval = torch.where(has, wv[mwin] * lin, 0.0)
    mvals = torch.where(mm, mval.reshape(-1)[mn], NEG_INF)
    _, win_m = seg_first_max(mvals, mb, mm, bhas)
    pred = torch.where(bhas, mvals.gather(1, win_m), 0.0)
    return BagForward(lin, mwin, mval, pred, mn.gather(1, win_m))


def bag_grads(w, fwd: BagForward, x, labels, ct, bag_has, has):
    """(dw, du) of ``sum((pred - labels)^2 * keep) / denom``, with
    ``ct = (1 / denom) * keep`` [R, B]: each bag's term reaches its winning
    member's value, which reaches that member's winning weight and, through
    ``x . u``, the attribution vector. ``x`` is [N, F] (ELL) or [R, C, F]
    (segment form)."""
    g_pred = torch.where(bag_has, ct * (2.0 * (fwd.pred - labels)), 0.0)
    g_val = _accumulate(w.numel(), fwd.bag_member, g_pred, bag_has,
                        w).view_as(w)
    g_val = torch.where(has, g_val, 0.0)
    gw = _accumulate(w.numel(), fwd.member_winner, g_val * fwd.lin, has,
                     w).view_as(w)
    g_lin = g_val * w.reshape(-1)[fwd.member_winner]
    if x.dim() == 2:
        gu = g_lin @ x
    else:
        gu = torch.bmm(g_lin.unsqueeze(1), x).squeeze(1)
    return gw, gu

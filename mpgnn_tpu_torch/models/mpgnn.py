"""MPNetm, the metapath GNN (the reference's model.py:179-228).

Per metapath m, a stack of single-relation RelConvs: hop j aggregates only
relation metapaths[m][j]; the first hop maps input_dim -> hidden, later
hops hidden -> hidden, each followed by ReLU. The per-metapath embeddings
are concatenated, then fc1 -> ReLU -> fc2 -> log_softmax. With
``train=True`` dropout follows every hop, as in the reference
(model.py:210-214).

Every hop conv is a plain RelConv, or with ``num_bases`` / ``num_blocks``
one of CustomRGCNConv's decompositions (``models.relconv``). With
``compute_dtype=torch.bfloat16`` the forward runs as the JAX package's
mixed precision: activations in bf16, the parameters float32 and cast to
each product's dtype, log_softmax in float32.

``MPNetmStack`` holds C single-metapath MPNetms of one length with a
leading candidate axis on every parameter, for the batched final
evaluation of the search (``train/batch_eval.py``).

``MetapathNet`` is the reference's two-conv MPNet (model.py:153-176) and
``RgcnNet`` its plain all-relations RGCN ``Net`` (model.py:132-149), the
model of the RGCN baseline (``rgcn_baseline.py``), each relation's term
on the rows it reaches.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.models.relconv import (
    RelConv,
    RgcnConv,
    init_params_like,
    init_relconv,
    make_relconv,
    uniform,
)
from mpgnn_tpu_torch.ops.conv import dense_conv, grouped_dense_aggregate
from mpgnn_tpu_torch.ops.csr import (
    RowTermBlockings,
    csr_mean_aggregate,
    csr_scatter,
)
from mpgnn_tpu_torch.ops.onehot import onehot_spmm_mean
from mpgnn_tpu_torch.ops.spmm import (
    Ell2Operand,
    dense_mean_aggregate,
    ell2_mean_aggregate,
    ell_mean_aggregate,
    rel_mean_aggregate,
)
from mpgnn_tpu_torch.parallel.halo import halo_sharded_mean_aggregate
from mpgnn_tpu_torch.utils.prof import span


def hop_aggregate(h: torch.Tensor, op: Tuple, num_nodes: int) -> torch.Tensor:
    """One hop's relation-masked mean aggregation. ``op`` is a tagged tuple
    from ``train.loops.build_hop_arrays``:

      ('segment', src, dst, inv_deg)  gather + index_add_ segment mean
      ('csr', fwd, bwd)               the sorted-CSR kernels (ops/csr.py)
      ('ell', nbr, nbr_mask)          padded neighbour-table gather
      ('ell2', out_nbr, out_w, in_nbr, in_w)
                                      weighted gathers both ways
      ('dense', a, a_t)               float32 adjacency GEMM, A^T stored
      ('onehot', fwd, bwd)            block one-hot batched GEMM
      ('halo', mesh, axis, shard)     this rank's rows of the node-sharded
                                      mean, h its [S, F] block
                                      (parallel/halo.py)

    All compute the same mean, with zero rows for edgeless sources. A
    ``('fused', operand)`` hop has no separate aggregation: its kernel
    (ops/conv.py) runs the whole conv."""
    kind = op[0]
    if kind == "segment":
        _, src, dst, inv = op
        return rel_mean_aggregate(h, src, dst, num_nodes, inv_count=inv)
    if kind == "csr":
        _, fwd, bwd = op
        return csr_mean_aggregate(h, fwd, bwd)
    if kind == "ell":
        _, nbr, mask = op
        return ell_mean_aggregate(h, nbr, mask)
    if kind == "ell2":
        return ell2_mean_aggregate(Ell2Operand(*op[1:]), h)
    if kind == "dense":
        _, a, a_t = op
        return dense_mean_aggregate(a, a_t, h)
    if kind == "onehot":
        _, fwd, bwd = op
        return onehot_spmm_mean(fwd, bwd, h)
    if kind == "halo":
        _, mesh, axis, shard = op
        return halo_sharded_mean_aggregate(mesh, h, shard, axis)
    raise ValueError(f"unknown hop op {kind!r}")


def dropout_scale(p: float, dtype: torch.dtype) -> float:
    """1 - p as the JAX package divides by it, ``jnp.asarray(1 - p, dt)``
    in the compute dtype (0.400390625 in bf16 at p = 0.6), as a Python
    float: a float32 h divides by that value too."""
    return float(torch.tensor(1.0 - p, dtype=dtype))


def linear(fc: nn.Linear, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``h @ W.T + b`` with the parameters cast to ``dtype`` and the product
    in the promotion of h's dtype and ``dtype`` (the JAX package's
    ``h @ cast(w) + cast(b)``: a float32 h meets bf16-rounded weights in
    float32)."""
    if h.dtype == dtype == fc.weight.dtype:
        return fc(h)
    t = torch.promote_types(h.dtype, dtype)
    return (h.to(t) @ fc.weight.to(dtype).t().to(t)
            + fc.bias.to(dtype).to(t))


def _drop(h: torch.Tensor, dropout_rate: float, scale: float,
          generator: Optional[torch.Generator],
          whole: Optional[Tuple[int, object]] = None) -> torch.Tensor:
    """Keep each entry with probability 1 - p (a float32 draw on h's shape,
    whatever h's dtype) and divide the kept ones by ``scale``. With
    ``whole`` = (rows, index), h holds the rows ``index`` (a slice or an
    index tensor) of a [rows, H] activation (a rank's block of a
    node-sharded one, or the row tail's rows): the draw is over the whole
    of it, so the masks and the generator's state are the whole's, and h
    keeps its own rows."""
    shape = h.shape if whole is None else (whole[0], h.shape[1])
    draw = torch.rand(shape, generator=generator, device=h.device)
    if whole is not None:
        draw = draw[whole[1]]
    keep = draw < 1.0 - dropout_rate
    return torch.where(keep, h / scale, torch.zeros_like(h))


# When ``train.loops.train_step`` runs the model's tail on the loss's rows
# alone (``MPNetm.forward``'s ``rows``): each metapath's last conv, fc1,
# fc2 and log_softmax on the T rows, after gathers of the last
# aggregation, its input and the masks, whose gradients scatter back into
# [N, H]. It does where the loss reads at most ROW_TAIL_SHARE of the N
# rows and the tail drops at least ROW_TAIL_MIN_DROP rows (N - T);
# elsewhere the full tail runs and pays no gathers. Read with
# ``train_step`` (hidden 64, float32, csr, random rows; row tail over
# full tail) on an NVIDIA H100 80GB HBM3 at 700.00 W:
# * device-bound, ogbn-mag's full graph (1.94M nodes, 3 metapaths), CUDA
#   events over 10 steps: 0.433, 0.610, 0.773, 0.858, 0.941 at 10, 30,
#   50, 60 and 70% of the rows with 349 classes; 0.518, 0.685, 0.845,
#   0.928, 1.006 with 2 classes. The two cross at 69-77% of the rows.
# * host-bound, the step's wall set by its launches (random graphs of 20k
#   to 200k nodes, 3 metapaths, 6.5-8 ms a step; medians of 11-15 rounds,
#   full and tail alternated): the tail's extra launches cost 4-19% where
#   it drops 14k-143k rows, and it reads 0.85-0.99 where it drops 190k-
#   196k (a 200k-node graph at 5%; the 200k-node power-law KG's labelled
#   split at 2.2%, 2 classes, 1 to 3 metapaths: 0.91-0.98). A 300k-node
#   graph's step is device-bound: 0.73 at 210k and 285k rows dropped.
ROW_TAIL_SHARE = 0.6
ROW_TAIL_MIN_DROP = 150_000


class MPNetm(nn.Module):
    """Parameters: ``convs[m][j]`` (a RelConv of ``models.relconv``: plain,
    or the basis / block variant when ``num_bases`` / ``num_blocks`` is
    set, bases winning), ``fc1`` and ``fc2`` (nn.Linear). Built empty;
    ``init_mpgnn`` or ``weights.params_from_jax`` fills them. The build is
    timed as the span ``model.init``."""

    def __init__(self, input_dim: int, hidden_dim: int, num_classes: int,
                 metapath_lengths: Sequence[int], device=None,
                 num_bases: Optional[int] = None,
                 num_blocks: Optional[int] = None):
        super().__init__()
        with span("model.init"):
            self.convs = nn.ModuleList(
                nn.ModuleList(
                    make_relconv(input_dim if j == 0 else hidden_dim,
                                 hidden_dim, num_bases, num_blocks,
                                 device=device)
                    for j in range(n)
                )
                for n in metapath_lengths
            )
            self.fc1 = nn.utils.skip_init(
                nn.Linear, hidden_dim * len(metapath_lengths), hidden_dim,
                device=device)
            self.fc2 = nn.utils.skip_init(nn.Linear, hidden_dim,
                                          num_classes, device=device)

    def forward(self, x: torch.Tensor, hop_ops, *,
                dropout_rate: float = 0.6,
                generator: Optional[torch.Generator] = None,
                train: bool = False,
                first_hop_agg: Optional[FirstHop] = None,
                compute_dtype: Optional[torch.dtype] = None,
                shard_rows: Optional[Tuple[int, int]] = None,
                rows: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """[N, C] float32 log-probabilities; ``hop_ops[m][j]`` is hop j of
        metapath m (``build_hop_arrays``). For 'halo' hops x is this rank's
        block of the node-sharded features and ``shard_rows`` its (first
        row, total rows), which place its rows in the dropout masks.

        With ``train`` and ``dropout_rate > 0`` each hop's output is kept
        with probability 1 - p and scaled by 1 / (1 - p); the masks are
        drawn from ``generator`` (on x's device), one draw per hop in hop
        order. ``first_hop_agg`` (``precompute_first_hop``) holds each
        metapath's cached hop-0 aggregation, or None to compute it.

        ``rows`` (a 1-D index tensor, not with ``shard_rows``) gives
        [len(rows), C], the log-probabilities of those rows in their order:
        each metapath's last hop aggregates over all rows and then takes
        ``rows`` of its aggregation and input (a fused hop, of its output),
        so that conv, its dropout, fc1, fc2 and log_softmax run on those
        rows alone, timed as the span ``model.row_tail``. Each mask is
        still drawn on the whole [N, H] and cut to ``rows``, so the
        generator gives the same masks as without ``rows``.

        ``compute_dtype`` (default x's) is the JAX package's: x is cast to
        it, each conv computes in its input's dtype, fc1 and fc2 take their
        parameters cast to it, and log_softmax runs in float32. A fused hop
        (K3) returns float32 whatever its input, as in the JAX package, so
        under bf16 the hops after a fused hop 0 run in float32."""
        if rows is not None and shard_rows is not None:
            raise ValueError("rows restrict a single-device forward, not a "
                             "node-sharded one")
        dt = compute_dtype or x.dtype
        x_in, x = x, x.to(dt)
        scale = dropout_scale(dropout_rate, dt)
        num_nodes = x.shape[0]
        whole = None if shard_rows is None else (
            shard_rows[1], slice(shard_rows[0], shard_rows[0] + num_nodes))
        embeddings = []
        with contextlib.ExitStack() as tail:
            for i, (stack, ops) in enumerate(zip(self.convs, hop_ops)):
                h = x
                for j, (conv, op) in enumerate(zip(stack, ops)):
                    cut = rows is not None and j == len(stack) - 1
                    if cut and i == 0:
                        tail.enter_context(span("model.row_tail"))
                    cached = (first_hop_agg[i] if j == 0 and first_hop_agg
                              else None)
                    if cached is not None and cut:
                        agg, h = first_hop_agg.at_rows(i, x_in, rows, dt)
                        h = torch.relu(conv(agg, h))
                    elif cached is not None:
                        h = torch.relu(conv(cached.to(dt), h))
                    elif op[0] == "fused":
                        h = dense_conv(op[1], h, conv.effective_weight(),
                                       conv.root, conv.bias)
                        if cut:
                            h = h.index_select(0, rows)
                    else:
                        agg = hop_aggregate(h, op, num_nodes)
                        if cut:
                            agg = agg.index_select(0, rows)
                            h = h.index_select(0, rows)
                        h = torch.relu(conv(agg, h))
                    if train and dropout_rate > 0.0:
                        h = _drop(h, dropout_rate, scale, generator,
                                  (num_nodes, rows) if cut else whole)
                embeddings.append(h)
            h = torch.relu(linear(self.fc1, torch.cat(embeddings, dim=1), dt))
            h = linear(self.fc2, h, dt)
            return torch.log_softmax(h.float(), dim=1)


class FirstHop(list):
    """``precompute_first_hop``'s list: each metapath's hop-0 aggregation
    of x, None for a fused hop. For the row tail it also keeps what the
    conv of a one-hop metapath reads, that aggregation's and x's rows:
    ``at_rows`` gathers them on its first call for a pair of x and rows,
    both constants of a training run, and gives the same tensors after."""

    def __init__(self, aggs) -> None:
        super().__init__(aggs)
        self._key: Optional[tuple] = None
        self._at_rows: dict = {}

    @torch.no_grad()
    def at_rows(self, i: int, x: torch.Tensor, rows: torch.Tensor,
                dt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(metapath i's aggregation, x) at ``rows``, cast to ``dt``; kept
        while x and rows are the same tensors and dt the same dtype. They
        are constants, so x may not need a gradient."""
        if x.requires_grad:
            raise ValueError("the row tail keeps x's rows as constants; "
                             "x may not require a gradient")
        key = self._key
        if key is None or key[0] is not x or key[1] is not rows \
                or key[2] != dt:
            self._key, self._at_rows = (x, rows, dt), {}
        got = self._at_rows
        if "x" not in got:
            got["x"] = x.to(dt).index_select(0, rows)
        if i not in got:
            got[i] = self[i].to(dt).index_select(0, rows)
        return got[i], got["x"]


@torch.no_grad()
def precompute_first_hop(x: torch.Tensor, hop_ops,
                         compute_dtype: Optional[torch.dtype] = None
                         ) -> FirstHop:
    """Per-metapath hop-0 aggregation of the input features (cast to
    ``compute_dtype``, default x's), which are constant for a whole
    training run (dropout comes after each conv), so it is computed once
    outside the epoch loop. None for a fused hop, whose kernel owns its
    aggregation: it runs on x every epoch. A ``FirstHop``, which keeps the
    rows a row tail reads. Timed as the span ``model.first_hop``."""
    with span("model.first_hop"):
        xd = x.to(compute_dtype or x.dtype)
        return FirstHop(None if ops[0][0] == "fused"
                        else hop_aggregate(xd, ops[0], x.shape[0])
                        for ops in hop_ops)


@torch.no_grad()
def init_mpgnn(
    input_dim: int,
    hidden_dim: int,
    num_classes: int,
    metapaths: Sequence[Sequence[int]],
    generator: Optional[torch.Generator] = None,
    device=None,
    num_bases: Optional[int] = None,
    num_blocks: Optional[int] = None,
) -> MPNetm:
    """An MPNetm with one conv stack per metapath, initialized like the
    reference: glorot conv weights (bases and their coefficients, or
    blocks, for the decomposed convs; ``num_bases`` wins over
    ``num_blocks``, as the reference's ctor), zero conv biases, and
    torch.nn.Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for fc1 and fc2.
    Draws come from ``generator`` (a CPU generator; seed 0 when None), conv
    by conv in hop order (``relconv.init_params_like``), then fc1 and fc2,
    so one seed gives the same parameters on every device."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = MPNetm(input_dim, hidden_dim, num_classes,
                   [len(mp) for mp in metapaths], device=device,
                   num_bases=num_bases, num_blocks=num_blocks)
    for stack in model.convs:
        for conv in stack:
            conv.load_params(init_params_like(conv, generator))
    init_linear_(model.fc1, generator)
    init_linear_(model.fc2, generator)
    return model


@torch.no_grad()
def init_linear_(fc: nn.Linear, generator: torch.Generator) -> None:
    """torch.nn.Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in)), weight then
    bias, drawn from ``generator``."""
    bound = 1.0 / math.sqrt(fc.in_features)
    fc.weight.copy_(uniform(fc.weight.shape, bound, generator))
    fc.bias.copy_(uniform(fc.bias.shape, bound, generator))


def stack_hop_aggregate(h: torch.Tensor, parts) -> torch.Tensor:
    """One hop's aggregation of C candidates' features ``h`` [C, N, F].
    ``parts`` covers each candidate once: (candidate indices, op), where
    ``op`` is a ``hop_aggregate`` operand over those candidates' rows
    stacked block-diagonally ([len(indices) * N] rows), or
    ``('grouped_dense', operand)``, the bf16 adjacency of the relation they
    share (``ops.conv.grouped_dense_aggregate``). A part of every candidate
    in order aggregates ``h`` in place of a copy."""
    c, n, f = h.shape
    out = [None] * c
    for idx, op in parts:
        whole = tuple(idx) == tuple(range(c))
        if op[0] == "grouped_dense":
            agg = grouped_dense_aggregate(op[1], h, idx)
        else:
            sub = h if whole else h[list(idx)]
            agg = hop_aggregate(sub.reshape(-1, f), op,
                                len(idx) * n).view(len(idx), n, f)
        if whole:
            return agg
        for i, k in enumerate(idx):
            out[k] = agg[i]
    return torch.stack(out)


# Rows from which ``stacked_matmul`` takes its weight gradient one product
# a candidate. Between the two graphs the search runs on the card, where
# ``chip_smoke.py`` times both forms (``weight_grad_forms``; on an H100):
# at N = 5,000 the step is host-bound and one batched product is faster
# (the synthetic search's final evaluation 2.0-2.1 s against 2.6-2.7 s);
# at N = 200,000 it is device-bound and C products are (the KG's, 4.6 s
# against 13.0 s). The crossover itself is not measured.
SPLIT_ROWS = 1 << 16


class _StackedMatmul(torch.autograd.Function):
    """``torch.bmm(a, w)`` for a [C, N, K], w [C, K, H]. Its weight
    gradient ``a[c].T @ g[c]`` is a [K, H] result summed over N rows: cuBLAS
    runs the batched form on a few CTAs a candidate but splits the reduction
    of a single product, so from ``SPLIT_ROWS`` rows it is C products."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.bmm(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, w.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            if a.shape[1] >= SPLIT_ROWS:
                gw = torch.stack([ac.T @ gc for ac, gc in zip(a, g)])
            else:
                gw = torch.bmm(a.transpose(1, 2), g)
        return ga, gw


def stacked_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[C, N, H] products of a [C, N, K] and w [C, K, H] (``torch.bmm``),
    differentiable in both."""
    return _StackedMatmul.apply(a, w)


class MPNetmStack(nn.Module):
    """C single-metapath MPNetms of one metapath length L, trained at once.

    Every parameter has a leading candidate axis: hop j's ``weight[j]`` and
    ``root[j]`` [C, in_j, H] and ``bias[j]`` [C, H]; ``fc1_w`` [C, H, H],
    ``fc1_b`` [C, H], ``fc2_w`` [C, H, K], ``fc2_b`` [C, K], weights in the
    [in, out] layout. Features are candidate-major, [C, N, H], and the
    products are batched GEMMs (``stacked_matmul``). ``from_models`` and
    ``split`` convert from and to C ``MPNetm``s."""

    def __init__(self, num_candidates: int, input_dim: int, hidden_dim: int,
                 num_classes: int, length: int, device=None):
        super().__init__()
        c, h = num_candidates, hidden_dim

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.weight = nn.ParameterList(
            param(c, input_dim if j == 0 else h, h) for j in range(length))
        self.root = nn.ParameterList(
            param(c, input_dim if j == 0 else h, h) for j in range(length))
        self.bias = nn.ParameterList(param(c, h) for _ in range(length))
        self.fc1_w, self.fc1_b = param(c, h, h), param(c, h)
        self.fc2_w, self.fc2_b = param(c, h, num_classes), param(c, num_classes)

    @property
    def num_candidates(self) -> int:
        return self.fc1_w.shape[0]

    @classmethod
    @torch.no_grad()
    def from_models(cls, models: Sequence[MPNetm]) -> "MPNetmStack":
        """The stack of C single-metapath MPNetms of one length."""
        first = models[0]
        if any(len(m.convs) != 1 or len(m.convs[0]) != len(first.convs[0])
               for m in models):
            raise ValueError("MPNetmStack stacks single-metapath MPNetms of "
                             "one length")
        conv0 = first.convs[0][0]
        stack = cls(len(models), conv0.weight.shape[0], conv0.weight.shape[1],
                    first.fc2.out_features, len(first.convs[0]),
                    device=conv0.weight.device)
        for j in range(len(first.convs[0])):
            for name in ("weight", "root", "bias"):
                getattr(stack, name)[j].copy_(torch.stack(
                    [getattr(m.convs[0][j], name) for m in models]))
        for i in (1, 2):
            fcs = [getattr(m, f"fc{i}") for m in models]
            getattr(stack, f"fc{i}_w").copy_(
                torch.stack([fc.weight.T for fc in fcs]))
            getattr(stack, f"fc{i}_b").copy_(
                torch.stack([fc.bias for fc in fcs]))
        return stack

    @torch.no_grad()
    def split(self) -> List[MPNetm]:
        """The C MPNetms the stack holds, each with its own copy of its
        parameters."""
        c, in_dim, h = self.weight[0].shape
        models = []
        for k in range(c):
            m = MPNetm(in_dim, h, self.fc2_w.shape[2], [len(self.weight)],
                       device=self.fc1_w.device)
            for j, conv in enumerate(m.convs[0]):
                conv.weight.copy_(self.weight[j][k])
                conv.root.copy_(self.root[j][k])
                conv.bias.copy_(self.bias[j][k])
            for i in (1, 2):
                fc = getattr(m, f"fc{i}")
                fc.weight.copy_(getattr(self, f"fc{i}_w")[k].T)
                fc.bias.copy_(getattr(self, f"fc{i}_b")[k])
            models.append(m)
        return models

    def forward(self, x: torch.Tensor, hops, first_hop_agg: torch.Tensor, *,
                dropout_rate: float = 0.6,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
        """[C, N, K] log-probabilities. ``x`` [N, F] is every candidate's
        input, ``first_hop_agg`` [C, N, F] each candidate's hop-0
        aggregation of it, ``hops[j - 1]`` hop j's parts for
        ``stack_hop_aggregate``. With ``train`` and ``dropout_rate > 0``,
        one [N, H] mask a hop, drawn from ``generator`` in hop order as
        ``MPNetm`` draws it, is applied to every candidate."""
        h = x.expand(self.num_candidates, -1, -1)
        for j in range(len(self.weight)):
            agg = (first_hop_agg if j == 0
                   else stack_hop_aggregate(h, hops[j - 1]))
            z = (stacked_matmul(agg, self.weight[j])
                 + stacked_matmul(h, self.root[j]))
            h = torch.relu(z + self.bias[j][:, None, :])
            if train and dropout_rate > 0.0:
                keep = torch.rand(h.shape[1:], generator=generator,
                                  device=h.device) < 1.0 - dropout_rate
                h = torch.where(keep, h / (1.0 - dropout_rate),
                                torch.zeros_like(h))
        h = torch.relu(stacked_matmul(h, self.fc1_w) + self.fc1_b[:, None, :])
        h = stacked_matmul(h, self.fc2_w) + self.fc2_b[:, None, :]
        return torch.log_softmax(h.float(), dim=2)


# ----------------------------------------------------------- MPNet (2-conv)
class MetapathNet(nn.Module):
    """The reference's single-metapath MPNet (model.py:153-176): ``conv1``
    (input -> hidden) on the first hop, ``conv2`` (hidden -> output) shared
    by every later hop, ReLU after each, a ``linear`` head, raw logits."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_classes: int, device=None):
        super().__init__()
        self.conv1 = RelConv(input_dim, hidden_dim, device=device)
        self.conv2 = RelConv(hidden_dim, output_dim, device=device)
        self.linear = nn.utils.skip_init(nn.Linear, output_dim, num_classes,
                                         device=device)

    def forward(self, x: torch.Tensor, hop_ops) -> torch.Tensor:
        """[N, C] logits; ``hop_ops[j]`` is hop j's aggregation operand."""
        h = x
        for j, op in enumerate(hop_ops):
            conv = self.conv1 if j == 0 else self.conv2
            h = torch.relu(conv(hop_aggregate(h, op, x.shape[0]), h))
        return self.linear(h)


@torch.no_grad()
def init_metapath_net(input_dim: int, hidden_dim: int, output_dim: int,
                      num_classes: int,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> MetapathNet:
    """A ``MetapathNet`` drawn from ``generator`` (seed 0 when None):
    conv1, conv2 (glorot weight and root, zero bias), then the linear
    head."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = MetapathNet(input_dim, hidden_dim, output_dim, num_classes,
                        device=device)
    for conv in (model.conv1, model.conv2):
        conv.load_params(init_relconv(conv.in_dim, conv.out_dim, generator))
    init_linear_(model.linear, generator)
    return model


# ------------------------------------------------------------ the RGCN Net
class RgcnNet(nn.Module):
    """The reference's plain RGCN ``Net`` (model.py:132-149): ``conv1``
    (input -> hidden) then ``conv2`` (hidden -> output) repeated, each
    ``ReLU(sum_r mean_r(h) @ W_r + h @ root + bias)`` over every relation
    (eq. 2 of Schlichtkrull et al. 2018, 1/c_{i,r} the count of i's
    r-edges), a ``linear`` head and log_softmax.

    Relation r's mean writes its sources' rows (``out[s]`` over the edges
    (s, d)), so its term is zero on every row without an r-edge: each
    relation's term runs on the rows R_r it reaches alone (``_RowTerms``),
    on the ``ops.csr.RowTermBlockings`` of all relations with edges
    (``rgcn_baseline.rgcn_operands``): K1 on their [sum_r |R_r|, N]
    blocking, one product with W_r on each relation's rows, one K1 pass
    that adds each node's terms. Layer 0's aggregations of the constant
    features may be given once (``precompute_rgcn_rows``). The build is
    timed as the span ``model.init``, each layer's sum over relations
    (aggregations, products, root, bias) as ``rgcn.relations``."""

    def __init__(self, input_dim: int, hidden_dim: int, num_rel: int,
                 output_dim: int, num_classes: int,
                 num_bases: Optional[int] = None,
                 num_blocks: Optional[int] = None, device=None):
        super().__init__()
        if num_bases is not None:
            num_blocks = None
        with span("model.init"):
            self.conv1 = RgcnConv(input_dim, hidden_dim, num_rel, num_bases,
                                  num_blocks, device=device)
            self.conv2 = RgcnConv(hidden_dim, output_dim, num_rel,
                                  num_bases, num_blocks, device=device)
            self.linear = nn.utils.skip_init(nn.Linear, output_dim,
                                             num_classes, device=device)

    def forward(self, x: torch.Tensor, blk: Optional[RowTermBlockings],
                metapath_length: int, *, first: Optional[torch.Tensor] = None,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[N, C] log-probabilities after ``metapath_length`` layers;
        ``blk`` holds every relation with edges (None where the graph has
        none: each layer is then its root and bias). ``first`` is
        ``precompute_rgcn_rows(x, blk)``, layer 0's aggregations, or None
        to compute them. ``rows`` (a 1-D index tensor) gives
        [len(rows), C], the head on those rows alone: every layer runs on
        all rows."""
        h = x
        for layer in range(metapath_length):
            conv = self.conv1 if layer == 0 else self.conv2
            with span("rgcn.relations"):
                if blk is None:
                    z = torch.addmm(conv.bias, h, conv.root)
                else:
                    z = _RowTerms.apply(h, conv.effective_weights(),
                                        conv.bias, conv.root, blk,
                                        first if layer == 0 else None)
            h = torch.relu(z)
        if rows is not None:
            h = h.index_select(0, rows)
        return torch.log_softmax(self.linear(h), dim=1)


class _RowTerms(torch.autograd.Function):
    """[N, out]: ``bias + h @ root + sum_r P_r (a_r @ W_r)`` over the
    relations r of ``blk`` (``ops.csr.RowTermBlockings``); a_r [|R_r|, F]
    is the mean aggregation of h on the rows R_r relation r reaches and P_r
    the placement of those rows among the N. K1 on ``blk.fwd`` gives every
    a_r at once (or they are given: layer 0's), one product a relation
    writes its terms into its stacked rows, and K1 on ``blk.place`` sums
    each node's terms in relation order: no add is atomic, and the sums
    repeat bitwise. The backward gathers ``grad[R_r]`` with K1 on
    ``blk.take``, takes W_r's gradient ``a_r^T grad[R_r]`` and, where h
    wants one, writes every relation's ``grad[R_r] W_r^T`` side by side
    for one K1 pass on ``blk.bwd``, h's gradient through all their means,
    to which the root's adds in place. Each relation's weight is taken by
    its host index, so no index goes to the device; the blockings get no
    gradient."""

    @staticmethod
    def forward(ctx, h, w, bias, root, blk, given):
        a = csr_scatter(blk.fwd, h) if given is None else given
        o = blk.offsets
        t = a.new_empty((a.shape[0], w.shape[2]))
        for i, r in enumerate(blk.rels):
            torch.mm(a[o[i]:o[i + 1]], w[r], out=t[o[i]:o[i + 1]])
        ctx.save_for_backward(h, w, root)
        ctx.blk, ctx.a = blk, a
        return csr_scatter(blk.place, t).add_(bias).addmm_(h, root)

    @staticmethod
    def backward(ctx, grad):
        h, w, root = ctx.saved_tensors
        blk, a, o = ctx.blk, ctx.a, ctx.blk.offsets
        g = csr_scatter(blk.take, grad.contiguous())
        gw = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        ga = g.new_empty(a.shape) if ctx.needs_input_grad[0] else None
        for i, r in enumerate(blk.rels):
            rows = slice(o[i], o[i + 1])
            if gw is not None:
                torch.mm(a[rows].t(), g[rows], out=gw[r])
            if ga is not None:
                torch.mm(g[rows], w[r].t(), out=ga[rows])
        gh = (None if ga is None
              else csr_scatter(blk.bwd, ga).addmm_(grad, root.t()))
        gb = grad.sum(0) if ctx.needs_input_grad[2] else None
        groot = h.t().mm(grad) if ctx.needs_input_grad[3] else None
        return gh, gw, gb, groot, None, None


@torch.no_grad()
def precompute_rgcn_rows(x: torch.Tensor, blk: Optional[RowTermBlockings]
                         ) -> Optional[torch.Tensor]:
    """Layer 0's aggregations: x is constant for a whole training run, so
    its means on the rows each relation reaches, [M, F] as ``blk``
    stacks them (K1 on ``blk.fwd``), are computed once, outside the epoch
    loop; None where ``blk`` is. Timed as the span ``model.first_hop``."""
    if blk is None:
        return None
    with span("model.first_hop"):
        return csr_scatter(blk.fwd, x)


@torch.no_grad()
def init_rgcn_net(input_dim: int, hidden_dim: int, num_rel: int,
                  output_dim: int, num_classes: int,
                  num_bases: Optional[int] = None,
                  num_blocks: Optional[int] = None,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> RgcnNet:
    """An ``RgcnNet`` drawn from ``generator`` (seed 0 when None): conv1,
    conv2 (``RgcnConv.init_``), then the linear head. ``num_bases`` wins
    over ``num_blocks``, as the reference's ctor."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = RgcnNet(input_dim, hidden_dim, num_rel, output_dim, num_classes,
                    num_bases, num_blocks, device=device)
    model.conv1.init_(generator)
    model.conv2.init_(generator)
    init_linear_(model.linear, generator)
    return model

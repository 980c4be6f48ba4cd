"""Edge-partitioned aggregation and the (data, model) sharded training step.

Counterpart of ``mpgnn_tpu/parallel/shard.py``. The edges of every hop's
relation are cut into contiguous shards over the ``data`` axis; each rank
sums its shard into full [N, F] partials and one ``all_reduce`` over the
axis completes the sum. The GEMMs are cut over the ``model`` axis as the
JAX package's shardings place them: each conv's weight, root and bias by
output columns (``P(None, 'model')``), fc1 by input rows (``P('model',
None)``), fc2 and x replicated. Where the JAX package leaves the
collectives to GSPMD, they are written out here:

* the partial sums' ``all_reduce`` over ``data``
  (``edge_partitioned_aggregate``), whose backward is the same
  ``all_reduce`` of the cotangent (the transpose of a sum);
* the all-gather of each hop's column shards over ``model`` (backward: a
  rank keeps its own columns' cotangent), and an ``all_reduce`` over
  ``model`` of the cotangent of every replicated input of a sharded GEMM;
* the ``all_reduce`` of fc1's partial products over ``model``;
* each data rank takes the loss of its share of the train rows, and the
  gradients are summed over ``data`` before Adam.

Adam is elementwise, so each rank steps its own shards; the result is the
replicated step's up to float32 summation order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mpgnn_tpu_torch.config import MPGNNConfig
from mpgnn_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_sum


# ------------------------------------------------- edge-partitioned mean
def shard_edges(arr: np.ndarray, mesh, axis: str = "data"
                ) -> Tuple[np.ndarray, int]:
    """``arr`` padded with zeros to a multiple of the axis size, and the
    pad (the JAX package's ``shard_edges``)."""
    n = mesh.axis_size(axis)
    pad = (-arr.shape[0]) % n
    if pad:
        arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:],
                                            arr.dtype)])
    return arr, pad


def edge_block(arr: np.ndarray, mesh, axis: str = "data") -> np.ndarray:
    """This rank's contiguous block of ``arr`` (padded by ``shard_edges``)
    along ``axis``."""
    arr, _ = shard_edges(np.asarray(arr), mesh, axis)
    n = arr.shape[0] // mesh.axis_size(axis)
    i = mesh.axis_rank(axis)
    return arr[i * n: (i + 1) * n]


# -------------------------------------------- collectives with gradients
class _Sum(torch.autograd.Function):
    """Sum over a group; the cotangent is summed over it too."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _Replicated(torch.autograd.Function):
    """Identity on a tensor every rank of the group holds alike, which
    each rank feeds to its own shard of a product: the cotangent is summed
    over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _PartialSum(torch.autograd.Function):
    """Sum of partial products over a group; each rank's cotangent is the
    sum's."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherColumns(torch.autograd.Function):
    """The column shards of the group's ranks side by side; each rank
    keeps its own columns' cotangent."""

    @staticmethod
    def forward(ctx, t, group, index):
        ctx.cols, ctx.index = t.shape[1], index
        rows = all_gather_rows(t.t().contiguous(), group)
        return rows.t()

    @staticmethod
    def backward(ctx, g):
        c = ctx.cols
        return g[:, ctx.index * c:(ctx.index + 1) * c], None, None


def edge_partitioned_aggregate(mesh, x: torch.Tensor, src: torch.Tensor,
                               dst: torch.Tensor, mask: torch.Tensor,
                               num_nodes: int,
                               axis: str = "data") -> torch.Tensor:
    """Mean aggregation with the edges sharded over ``axis``: ``src``,
    ``dst``, ``mask`` are this rank's shard (``edge_block``), ``x`` the
    [N, F] features every rank of the axis holds alike. The rank's partial
    sums and counts go through one ``all_reduce``; every rank returns the
    [N, F] mean. Differentiable in ``x``: each rank's cotangent of the sum
    is summed over the axis, and its partial's backward covers its edges,
    so the ranks' gradients of ``x`` add to the whole one."""
    m = mask.to(x.dtype)
    part = torch.cat([
        x.new_zeros((num_nodes, x.shape[1])).index_add(0, src,
                                                       x[dst] * m[:, None]),
        x.new_zeros((num_nodes, 1)).index_add(0, src, m[:, None])], dim=1)
    total = _Sum.apply(part, mesh.axis_group(axis))
    return total[:, :-1] / total[:, -1:].clamp_min(1.0)


# ---------------------------------------------- the sharded training step
def _spec(name: str) -> Optional[int]:
    """The dimension of parameter ``name`` (an MPNetm state_dict key) cut
    over ``model``, or None for a replicated one: conv weight and root by
    output column (dim 1), conv bias by its one dim, fc1's weight by input
    column (its torch layout is [out, in])."""
    if name.startswith("convs."):
        return 0 if name.endswith(".bias") else 1
    return 1 if name == "fc1.weight" else None


class ShardedTrainStep:
    """The MPNetm training step over a (data, model) mesh (``shard.py:
    79-214``), plain RelConvs. Call it with an optional dropout generator
    (seeded alike on every rank) to run one step on every rank together;
    it returns the loss before the step, the same on every rank.
    ``params`` holds this rank's shard of each parameter by its MPNetm
    state_dict name, ``optimizer`` the Adam over them."""

    def __init__(self, mesh, graph, metapaths, split, num_classes: int,
                 cfg: Optional[MPGNNConfig] = None, seed: int = 0,
                 init_params: Optional[Dict[str, torch.Tensor]] = None,
                 init_opt_state: Optional[Dict[str, dict]] = None):
        from mpgnn_tpu_torch.train.loops import seeded_init

        cfg = self.cfg = cfg or MPGNNConfig()
        self.mesh, self.device = mesh, mesh.device
        self.metapaths = [list(mp) for mp in metapaths]
        self.model_group = mesh.axis_group("model")
        self.data_group = mesh.axis_group("data")
        M, mi = mesh.axis_size("model"), mesh.axis_rank("model")
        widths = (cfg.hidden_dim, cfg.hidden_dim * len(self.metapaths))
        if any(w % M for w in widths):
            raise ValueError(f"hidden {cfg.hidden_dim} and fc1's input "
                             f"{widths[1]} must divide by the model axis "
                             f"{M}")
        self.num_classes = num_classes
        if init_params is None:
            model, _ = seeded_init(graph.feat_dim, cfg.hidden_dim,
                                   num_classes, self.metapaths, seed, "cpu")
            init_params = model.state_dict()
        self.params: Dict[str, torch.nn.Parameter] = {}
        for name, full in init_params.items():
            self.params[name] = torch.nn.Parameter(
                self._local(name, full).to(self.device))
        self.optimizer = torch.optim.Adam(self.params.values(), lr=cfg.lr,
                                          weight_decay=cfg.weight_decay)
        if init_opt_state is not None:
            sd = {"state": {}, "param_groups": self.optimizer.state_dict()[
                "param_groups"]}
            for i, name in enumerate(self.params):
                st = init_opt_state[name]
                sd["state"][i] = {
                    "step": torch.as_tensor(st["step"]).clone(),
                    "exp_avg": self._local(name, st["exp_avg"]),
                    "exp_avg_sq": self._local(name, st["exp_avg_sq"])}
            self.optimizer.load_state_dict(sd)
        # each hop's edges: this data rank's block of the padded edge list
        self.hops = []
        for mp in self.metapaths:
            hops = []
            for rel in mp:
                s, d = graph.rel_edges(int(rel))
                hops.append(tuple(
                    torch.as_tensor(edge_block(a, mesh), device=self.device)
                    for a in (s, d, np.ones(len(s), dtype=bool))))
            self.hops.append(hops)
        self.x = torch.as_tensor(np.asarray(graph.x, dtype=np.float32),
                                 device=self.device)
        # this data rank's share of the train rows, over all of them
        idx, y = np.asarray(split.train_idx), np.asarray(split.train_y)
        share = np.array_split(np.arange(len(idx)),
                               mesh.axis_size("data"))[
                                   mesh.axis_rank("data")]
        self.train_idx = torch.as_tensor(idx[share], device=self.device)
        self.train_y = torch.as_tensor(y[share], device=self.device)
        self.num_train = len(idx)
        self.model_index = mi

    def _local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        dim = _spec(name)
        full = torch.as_tensor(full)
        if dim is None:
            return full.clone()
        M = self.mesh.axis_size("model")
        return full.chunk(M, dim)[self.mesh.axis_rank("model")].clone()

    def _full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        dim = _spec(name)
        if dim is None:
            return local.detach().cpu().clone()
        rows = all_gather_rows(local.detach().movedim(dim, 0).contiguous(),
                               self.model_group)
        return rows.movedim(0, dim).cpu().contiguous()

    def forward(self, generator: Optional[torch.Generator] = None,
                train: bool = True) -> torch.Tensor:
        """[N, C] log-probabilities, the same on every rank."""
        p, cfg = self.params, self.cfg
        n = self.x.shape[0]
        mg = self.model_group
        embeddings = []
        for i, mp in enumerate(self.metapaths):
            h = self.x
            for j, (src, dst, mask) in enumerate(self.hops[i]):
                agg = edge_partitioned_aggregate(self.mesh, h, src, dst,
                                                 mask, n)
                pre = f"convs.{i}.{j}."
                z = (_Replicated.apply(agg, mg) @ p[pre + "weight"]
                     + _Replicated.apply(h, mg) @ p[pre + "root"]
                     + p[pre + "bias"])
                h = _GatherColumns.apply(torch.relu(z), mg, self.model_index)
                if train and cfg.dropout > 0.0:
                    if generator is None:
                        raise ValueError("dropout needs a generator seeded "
                                         "alike on every rank")
                    keep = torch.rand(h.shape, generator=generator,
                                      device=h.device) < 1.0 - cfg.dropout
                    h = torch.where(keep, h / (1.0 - cfg.dropout),
                                    torch.zeros_like(h))
            embeddings.append(h)
        h = _Replicated.apply(torch.cat(embeddings, dim=1), mg)
        w1 = p["fc1.weight"]
        k = w1.shape[1]
        part = h[:, self.model_index * k:(self.model_index + 1) * k] @ w1.t()
        h = torch.relu(_PartialSum.apply(part, mg) + p["fc1.bias"])
        h = h @ p["fc2.weight"].t() + p["fc2.bias"]
        return torch.log_softmax(h, dim=1)

    def __call__(self, generator: Optional[torch.Generator] = None) -> float:
        self.optimizer.zero_grad(set_to_none=True)
        logp = self.forward(generator)
        per = -logp[self.train_idx].gather(1, self.train_y[:, None])[:, 0]
        loss = per.sum() / self.num_train
        loss.backward()
        grads = [q.grad for q in self.params.values()]
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                              self.data_group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        self.optimizer.step()
        return float(all_reduce_sum(loss.detach(), self.data_group))

    def host_state(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, dict]]:
        """(parameters, Adam state) as whole CPU tensors by state_dict
        name, gathered over ``model``: layout-free, loadable on any mesh.
        Every rank of the mesh calls it together."""
        params = {k: self._full(k, v) for k, v in self.params.items()}
        opt = {}
        for name, q in self.params.items():
            st = self.optimizer.state.get(q)
            if st is None:
                zeros = torch.zeros_like(params[name])
                opt[name] = {"step": torch.zeros(()), "exp_avg": zeros,
                             "exp_avg_sq": zeros.clone()}
                continue
            opt[name] = {"step": st["step"].detach().cpu().clone(),
                         "exp_avg": self._full(name, st["exp_avg"]),
                         "exp_avg_sq": self._full(name, st["exp_avg_sq"])}
        return params, opt


def build_sharded_train_step(mesh, graph, metapaths, split, num_classes: int,
                             cfg: Optional[MPGNNConfig] = None,
                             seed: int = 0, init_params=None,
                             init_opt_state=None) -> ShardedTrainStep:
    """The sharded MPNetm step over ``mesh``'s ``data`` and ``model`` axes,
    every rank of the mesh calling together. ``init_params`` /
    ``init_opt_state`` (whole CPU tensors by MPNetm state_dict name, as
    ``ShardedTrainStep.host_state`` gives them) replace the fresh
    parameters drawn from ``seed``: that is how a checkpoint resumes on
    another mesh (``parallel.elastic``)."""
    return ShardedTrainStep(mesh, graph, metapaths, split, num_classes, cfg,
                            seed, init_params, init_opt_state)


# ------------------------------------------------- the relation sweep (hop 0)
def sharded_flat_sweep_args(mesh, *arrays, axis: str = "rel") -> List:
    """This rank's contiguous block of each relation-sweep batch array,
    the leading (relation) axis padded to a multiple of the axis size by
    repeating its last entry (``shard.py:217-235``: the reference's
    np.array_split over MPI ranks, main.py:1319)."""
    n, i = mesh.axis_size(axis), mesh.axis_rank(axis)
    out = []
    for a in arrays:
        a = np.asarray(a)
        pad = (-a.shape[0]) % n
        if pad:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
        k = a.shape[0] // n
        out.append(a[i * k:(i + 1) * k])
    return out

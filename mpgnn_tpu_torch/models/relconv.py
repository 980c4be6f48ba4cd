"""RelConv, the single-relation RGCN convolution:

    out = mean_aggregate_r(x) @ W_r + x @ root + bias

The aggregation is done by the caller (``models.mpgnn.hop_aggregate``), so
the modules only hold the transform. Weights keep the reference's
[in, out] layout. W_r is the plain ``weight``, or one of CustomRGCNConv's
decompositions (mp_rgcn_layer.py:120-137): a mixture of bases
(``RelConvBasis``) or a block-diagonal matrix (``RelConvBlock``).

Also ``fast_rgcn_aggregate``, the all-relations message pass of the RGCN
baseline (CustomFastRGCNConv, mp_rgcn_layer.py:287-357).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mpgnn_tpu_torch.ops.segment import segment_sum


class RelConvParams(NamedTuple):
    weight: torch.Tensor  # [in, out]
    root: torch.Tensor    # [in, out]
    bias: torch.Tensor    # [out]


class RelConvBasisParams(NamedTuple):
    """W_r = sum_b comp[b] * bases[b]; a search conv has one relation, so
    ``comp`` is that relation's row of coefficients."""

    comp: torch.Tensor    # [B]
    bases: torch.Tensor   # [B, in, out]
    root: torch.Tensor    # [in, out]
    bias: torch.Tensor    # [out]


class RelConvBlockParams(NamedTuple):
    """W_r block-diagonal; in and out must divide by the block count."""

    blocks: torch.Tensor  # [num_blocks, in / nb, out / nb]
    root: torch.Tensor    # [in, out]
    bias: torch.Tensor    # [out]


def uniform(shape: Sequence[int], bound: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-bound, bound) on the CPU, drawn from ``generator``."""
    return torch.rand(tuple(shape), generator=generator) * (2 * bound) - bound


def glorot(shape: Sequence[int],
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """PyG glorot: U(-s, s), s = sqrt(6 / (fan_in + fan_out)), the fans the
    last two dimensions."""
    return uniform(shape, math.sqrt(6.0 / (shape[-2] + shape[-1])), generator)


def init_relconv(in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None) -> RelConvParams:
    """glorot(weight), glorot(root), zeros(bias)."""
    return RelConvParams(
        weight=glorot((in_dim, out_dim), generator),
        root=glorot((in_dim, out_dim), generator),
        bias=torch.zeros(out_dim),
    )


def init_relconv_basis(in_dim: int, out_dim: int, num_bases: int,
                       generator: Optional[torch.Generator] = None,
                       num_relations: int = 1) -> RelConvBasisParams:
    """CustomRGCNConv(num_bases=...)'s init: glorot over the [B, in, out]
    bases, glorot over the [R, B] coefficients (fans R + B; R = 1 for a
    search conv), glorot(root), zeros(bias). Drawn in the JAX package's key
    order: bases, comp, root."""
    bases = glorot((num_bases, in_dim, out_dim), generator)
    comp = glorot((num_relations, num_bases), generator)[0]
    return RelConvBasisParams(comp=comp, bases=bases,
                              root=glorot((in_dim, out_dim), generator),
                              bias=torch.zeros(out_dim))


def _check_blocks(in_dim: int, out_dim: int, num_blocks: int) -> None:
    if in_dim % num_blocks or out_dim % num_blocks:
        raise ValueError(
            f"num_blocks={num_blocks} must divide both in_dim={in_dim} and "
            f"out_dim={out_dim} (mp_rgcn_layer.py:127-128 asserts the same)")


def init_relconv_block(in_dim: int, out_dim: int, num_blocks: int,
                       generator: Optional[torch.Generator] = None
                       ) -> RelConvBlockParams:
    """CustomRGCNConv(num_blocks=...)'s init: glorot over the
    [nb, in/nb, out/nb] blocks (fans over the last two), glorot(root),
    zeros(bias); blocks drawn first."""
    _check_blocks(in_dim, out_dim, num_blocks)
    blocks = glorot((num_blocks, in_dim // num_blocks,
                     out_dim // num_blocks), generator)
    return RelConvBlockParams(blocks=blocks,
                              root=glorot((in_dim, out_dim), generator),
                              bias=torch.zeros(out_dim))


def basis_weights(comp: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """W_r = sum_b comp[r, b] * bases[b]: comp [R, B], bases [B, in, out]
    -> [R, in, out] (mp_rgcn_layer.py:202-204)."""
    return torch.einsum("rb,bio->rio", comp, bases)


def block_diag_apply(aggregated: torch.Tensor,
                     block_weight: torch.Tensor) -> torch.Tensor:
    """The block-diagonal transform blockwise (mp_rgcn_layer.py:209-220):
    each of the nb column blocks of ``aggregated`` times its own
    [in/nb, out/nb] block, in the weights' dtype, cast back to
    ``aggregated``'s."""
    nb, bin_, bout = block_weight.shape
    h = aggregated.reshape(-1, nb, bin_).to(block_weight.dtype)
    out = torch.einsum("abc,bcd->abd", h, block_weight)
    return out.to(aggregated.dtype).reshape(-1, nb * bout)


def block_diag_weight(blocks: torch.Tensor) -> torch.Tensor:
    """The dense [..., in, out] matrix with ``blocks`` [..., nb, in/nb,
    out/nb] on its diagonal, differentiable in the blocks."""
    *lead, nb, bin_, bout = blocks.shape
    eye = torch.eye(nb, dtype=blocks.dtype, device=blocks.device)
    # w[..., b, i, c, o] = eye[b, c] * blocks[..., b, i, o]
    w = eye[:, None, :, None] * blocks.unsqueeze(-2)
    return w.reshape(*lead, nb * bin_, nb * bout)


def _cast_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with w cast to a's dtype (the JAX package's
    ``a @ w.astype(a.dtype)``)."""
    return a @ w.to(a.dtype)


class _RelConvBase(nn.Module):
    """Root and bias, shared by the three variants; ``forward(aggregated,
    h)`` is the pre-activation ``aggregated @ W_r + h @ root + bias`` in h's
    dtype (the parameters cast to it, relconv.py:184 of the JAX package)."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.root = nn.Parameter(torch.empty(in_dim, out_dim, device=device))
        self.bias = nn.Parameter(torch.empty(out_dim, device=device))

    @property
    def in_dim(self) -> int:
        return self.root.shape[0]

    @property
    def out_dim(self) -> int:
        return self.root.shape[1]

    def effective_weight(self) -> torch.Tensor:
        """The materialized [in, out] relation weight, float32 and
        differentiable in the parameters (what K3 takes)."""
        raise NotImplementedError

    def apply_weight(self, aggregated: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
        return _cast_matmul(aggregated, self.effective_weight().to(dtype))

    @torch.no_grad()
    def load_params(self, params) -> None:
        for name, value in params._asdict().items():
            getattr(self, name).copy_(value)

    def forward(self, aggregated: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
        dt = h.dtype
        out = self.apply_weight(aggregated, dt)
        return out + _cast_matmul(h, self.root) + self.bias.to(dt)


class RelConv(_RelConvBase):
    """The plain-weight RelConv."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__(in_dim, out_dim, device)
        self.weight = nn.Parameter(torch.empty(in_dim, out_dim, device=device))

    def effective_weight(self) -> torch.Tensor:
        return self.weight

    def apply_weight(self, aggregated, dtype):
        return _cast_matmul(aggregated, self.weight.to(dtype))


class RelConvBasis(_RelConvBase):
    """W_r a mixture of ``num_bases`` bases (its one relation's row of
    coefficients)."""

    def __init__(self, in_dim: int, out_dim: int, num_bases: int,
                 device=None):
        super().__init__(in_dim, out_dim, device)
        self.comp = nn.Parameter(torch.empty(num_bases, device=device))
        self.bases = nn.Parameter(torch.empty(num_bases, in_dim, out_dim,
                                              device=device))

    def effective_weight(self) -> torch.Tensor:
        return basis_weights(self.comp[None], self.bases)[0]


class RelConvBlock(_RelConvBase):
    """W_r block-diagonal of ``num_blocks`` blocks, applied blockwise."""

    def __init__(self, in_dim: int, out_dim: int, num_blocks: int,
                 device=None):
        super().__init__(in_dim, out_dim, device)
        _check_blocks(in_dim, out_dim, num_blocks)
        self.blocks = nn.Parameter(torch.empty(
            num_blocks, in_dim // num_blocks, out_dim // num_blocks,
            device=device))

    def effective_weight(self) -> torch.Tensor:
        return block_diag_weight(self.blocks)

    def apply_weight(self, aggregated, dtype):
        return block_diag_apply(aggregated, self.blocks)


def make_relconv(in_dim: int, out_dim: int, num_bases: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 device=None) -> _RelConvBase:
    """An empty conv of the variant the reference's ctor picks: bases when
    ``num_bases`` is set (they win over blocks), else blocks when
    ``num_blocks`` is, else the plain weight."""
    if num_bases is not None:
        return RelConvBasis(in_dim, out_dim, num_bases, device)
    if num_blocks is not None:
        return RelConvBlock(in_dim, out_dim, num_blocks, device)
    return RelConv(in_dim, out_dim, device)


def init_params_like(conv: _RelConvBase,
                     generator: Optional[torch.Generator] = None):
    """Initial parameters for ``conv``'s variant and shape."""
    if isinstance(conv, RelConvBasis):
        return init_relconv_basis(conv.in_dim, conv.out_dim,
                                  conv.comp.shape[0], generator)
    if isinstance(conv, RelConvBlock):
        return init_relconv_block(conv.in_dim, conv.out_dim,
                                  conv.blocks.shape[0], generator)
    return init_relconv(conv.in_dim, conv.out_dim, generator)


def relconv_effective_weight(conv: _RelConvBase) -> torch.Tensor:
    """The conv's [in, out] relation weight, for any variant."""
    return conv.effective_weight()


def relconv_transform(conv: _RelConvBase, aggregated: torch.Tensor,
                      h: torch.Tensor) -> torch.Tensor:
    """Pre-activation ``aggregated @ W_r + h @ root + bias`` of any
    variant, in h's dtype."""
    return conv(aggregated, h)


# ------------------------------------------------------------- the RGCN Net
class RgcnEdges(NamedTuple):
    """A graph's edges grouped by relation for ``rgcn_aggregate``: edge e
    of relation r (in ``[offsets[r], offsets[r+1])``) sends x[dst[e]]
    through W_r into row src[e], weighted by ``coef[e]`` = mask /
    (edges of its (src, relation) pair, at least 1)."""

    src: torch.Tensor      # [E] int64, grouped by relation
    dst: torch.Tensor      # [E] int64
    coef: torch.Tensor     # [E] float32
    offsets: tuple         # [R + 1] host ints
    num_nodes: int


def rgcn_edges(src, dst, edge_type, num_nodes: int, num_relations: int,
               mask=None, device=None) -> RgcnEdges:
    """``RgcnEdges`` of an edge list: the typed-degree normalization of
    mp_rgcn_layer.py:346-357, counts of the masked edges of each (source,
    relation) pair, computed once on the host."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    et = np.asarray(edge_type, dtype=np.int64)
    m = (np.ones(len(src), dtype=np.float32) if mask is None
         else np.asarray(mask, dtype=np.float32))
    combo = src * num_relations + et
    counts = np.bincount(combo, weights=m,
                         minlength=num_nodes * num_relations)
    coef = (m / np.maximum(counts[combo], 1.0)).astype(np.float32)
    order = np.argsort(et, kind="stable")
    offsets = np.zeros(num_relations + 1, dtype=np.int64)
    np.cumsum(np.bincount(et, minlength=num_relations), out=offsets[1:])

    def t(a):
        return torch.as_tensor(a[order], device=device)

    return RgcnEdges(src=t(src), dst=t(dst), coef=t(coef),
                     offsets=tuple(int(o) for o in offsets),
                     num_nodes=num_nodes)


def rgcn_aggregate(x: torch.Tensor, weights: torch.Tensor,
                   edges: RgcnEdges) -> torch.Tensor:
    """sum over relations r of the mean over r-edges (i, d) of x[d] @ W_r,
    into row i ([N, out]). Relation by relation, ``(x @ W_r)[dst]``: one
    [N, in] x [in, out] product and a gather of its rows, never an
    [E, in, out] stack of per-edge weights (the JAX package's
    ``weights[edge_type]``). Sums in another order than the per-edge
    products: float32 rounding."""
    msgs = []
    o = edges.offsets
    for r in range(len(o) - 1):
        if o[r + 1] > o[r]:
            xw = x @ weights[r]
            msgs.append(xw[edges.dst[o[r]:o[r + 1]]])
    out_dim = weights.shape[-1]
    if not msgs:
        return x.new_zeros((edges.num_nodes, out_dim))
    m = torch.cat(msgs) * edges.coef.to(x.dtype)[:, None]
    return segment_sum(m, edges.src, edges.num_nodes)


def fast_rgcn_aggregate(x: torch.Tensor, weights: torch.Tensor, src, dst,
                        edge_type, num_nodes: int,
                        mask=None) -> torch.Tensor:
    """The JAX package's ``fast_rgcn_aggregate`` (CustomFastRGCNConv):
    ``rgcn_aggregate`` over the edges given as arrays, ``weights``
    [R, in, out]."""
    edges = rgcn_edges(src, dst, edge_type, num_nodes, weights.shape[0],
                       mask=mask, device=x.device)
    return rgcn_aggregate(x, weights, edges)


class RgcnConv(nn.Module):
    """A multi-relation RGCN conv: per-relation weights [R, in, out]
    (plain), a mixture of shared bases (``comp`` [R, B], ``bases``
    [B, in, out]) or block-diagonal blocks [R, nb, in/nb, out/nb]; root and
    bias."""

    def __init__(self, in_dim: int, out_dim: int, num_rel: int,
                 num_bases: Optional[int] = None,
                 num_blocks: Optional[int] = None, device=None):
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        if num_bases is not None:
            self.comp = param(num_rel, num_bases)
            self.bases = param(num_bases, in_dim, out_dim)
        elif num_blocks is not None:
            _check_blocks(in_dim, out_dim, num_blocks)
            self.blocks = param(num_rel, num_blocks, in_dim // num_blocks,
                                out_dim // num_blocks)
        else:
            self.weight = param(num_rel, in_dim, out_dim)
        self.root = param(in_dim, out_dim)
        self.bias = param(out_dim)

    @property
    def kind(self) -> str:
        if hasattr(self, "comp"):
            return "basis"
        return "block" if hasattr(self, "blocks") else "plain"

    def effective_weights(self) -> torch.Tensor:
        """[R, in, out] per-relation weights of any variant."""
        if self.kind == "basis":
            return basis_weights(self.comp, self.bases)
        if self.kind == "block":
            return block_diag_weight(self.blocks)
        return self.weight

    @torch.no_grad()
    def init_(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's ``_init_rgcn_conv``, drawn in its key order:
        weight / bases / blocks, root, then comp; zero bias."""
        first = getattr(self, {"basis": "bases", "block": "blocks",
                               "plain": "weight"}[self.kind])
        first.copy_(glorot(first.shape, generator))
        self.root.copy_(glorot(self.root.shape, generator))
        if self.kind == "basis":
            self.comp.copy_(glorot(self.comp.shape, generator))
        self.bias.zero_()


def rgcn_effective_weights(conv: RgcnConv) -> torch.Tensor:
    """[R, in, out] weights of an RGCN conv of any variant."""
    return conv.effective_weights()

"""Parameters of the JAX package, as numpy arrays, into the port's models.

``params_from_jax``: the MPNetm tree has ``convs[i][j]``, each a plain
conv ``{weight, root, bias}``, a basis conv ``{comp, bases, root, bias}``
or a block conv ``{blocks, root, bias}`` (told apart by their fields), and
``fc1.{w, b}`` and ``fc2.{w, b}``; ``stack_params_from_jax`` takes a list
of single-metapath trees of one length into an ``MPNetmStack``.
``metapath_net_params_from_jax``: MPNet's ``{conv1, conv2, linear}``;
``rgcn_params_from_jax``: the RGCN ``Net``'s ``{conv1, conv2, linear}``
with [R, ...] conv weights of any variant. ``scorer_params_from_jax``: the
relation scorer's ``{w, u}``. Each field is read by attribute or by key, so
a NamedTuple tree, a dict tree or a mix works, and the port never imports
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.models.mpgnn import (
    MetapathNet,
    MPNetm,
    MPNetmStack,
    RgcnNet,
)
from mpgnn_tpu_torch.models.scorer import ScorerParams

# the fields of each conv variant, the first one telling it apart
_CONV_FIELDS = {"basis": ("comp", "bases", "root", "bias"),
                "block": ("blocks", "root", "bias"),
                "plain": ("weight", "root", "bias")}


def _get(node, name: str):
    if isinstance(node, dict):
        return node[name]
    return getattr(node, name)


def _has(node, name: str) -> bool:
    return name in node if isinstance(node, dict) else hasattr(node, name)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _kind(conv) -> str:
    return next(k for k, f in _CONV_FIELDS.items() if _has(conv, f[0]))


@torch.no_grad()
def _load_conv(module, src) -> None:
    for name in _CONV_FIELDS[_kind(src)]:
        getattr(module, name).copy_(_t(_get(src, name)))


@torch.no_grad()
def _load_linear(fc, src) -> None:
    """JAX's [in, out] weight into nn.Linear's [out, in]."""
    fc.weight.copy_(_t(_get(src, "w")).T)
    fc.bias.copy_(_t(_get(src, "b")))


@torch.no_grad()
def params_from_jax(tree, device=None) -> MPNetm:
    """An MPNetm on ``device`` holding the parameters of ``tree``, its
    convs of the tree's variant. Linear weights are [in, out] in JAX and
    [out, in] in nn.Linear."""
    device = resolve_device(device)
    convs = _get(tree, "convs")
    first = convs[0][0]
    kind = _kind(first)
    root = np.shape(_get(first, "root"))
    fc2_w = np.asarray(_get(_get(tree, "fc2"), "w"))
    model = MPNetm(
        input_dim=int(root[0]), hidden_dim=int(root[1]),
        num_classes=int(fc2_w.shape[1]),
        metapath_lengths=[len(stack) for stack in convs], device=device,
        num_bases=(int(np.shape(_get(first, "comp"))[0])
                   if kind == "basis" else None),
        num_blocks=(int(np.shape(_get(first, "blocks"))[0])
                    if kind == "block" else None),
    )
    for stack_src, stack in zip(convs, model.convs):
        for src, conv in zip(stack_src, stack):
            _load_conv(conv, src)
    for name in ("fc1", "fc2"):
        _load_linear(getattr(model, name), _get(tree, name))
    return model


@torch.no_grad()
def metapath_net_params_from_jax(tree, device=None) -> MetapathNet:
    """A ``MetapathNet`` on ``device`` holding MPNet's ``conv1``, ``conv2``
    and ``linear``."""
    device = resolve_device(device)
    c1 = np.shape(_get(_get(tree, "conv1"), "weight"))
    c2 = np.shape(_get(_get(tree, "conv2"), "weight"))
    k = np.shape(_get(_get(tree, "linear"), "w"))[1]
    model = MetapathNet(int(c1[0]), int(c1[1]), int(c2[1]), int(k),
                        device=device)
    _load_conv(model.conv1, _get(tree, "conv1"))
    _load_conv(model.conv2, _get(tree, "conv2"))
    _load_linear(model.linear, _get(tree, "linear"))
    return model


@torch.no_grad()
def rgcn_params_from_jax(tree, device=None) -> RgcnNet:
    """An ``RgcnNet`` on ``device`` holding the RGCN ``Net``'s ``conv1``,
    ``conv2`` (plain, basis or block) and ``linear``."""
    device = resolve_device(device)
    c1, c2 = _get(tree, "conv1"), _get(tree, "conv2")
    kind = _kind(c1)
    r1, r2 = np.shape(_get(c1, "root")), np.shape(_get(c2, "root"))
    lead = np.shape(_get(c1, _CONV_FIELDS[kind][0]))
    num_rel = lead[0]
    k = np.shape(_get(_get(tree, "linear"), "w"))[1]
    model = RgcnNet(int(r1[0]), int(r1[1]), int(num_rel), int(r2[1]), int(k),
                    num_bases=(int(lead[1]) if kind == "basis" else None),
                    num_blocks=(int(lead[1]) if kind == "block" else None),
                    device=device)
    _load_conv(model.conv1, c1)
    _load_conv(model.conv2, c2)
    _load_linear(model.linear, _get(tree, "linear"))
    return model


def stack_params_from_jax(trees, device=None) -> MPNetmStack:
    """An MPNetmStack on ``device`` holding the parameters of C
    single-metapath MPNetm trees of one length (the per-candidate initial
    parameters of the JAX package's batched evaluation)."""
    return MPNetmStack.from_models(
        [params_from_jax(tree, device=device) for tree in trees])


def scorer_params_from_jax(tree, device=None) -> ScorerParams:
    """The relation scorer's ``w`` [N] and ``u`` [F] as float32 tensors on
    ``device``."""
    device = resolve_device(device)
    return ScorerParams(w=_t(_get(tree, "w")).to(device),
                        u=_t(_get(tree, "u")).to(device))

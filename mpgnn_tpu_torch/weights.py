"""Parameters of the JAX package, as numpy arrays, into the port's models.

``params_from_jax``: the MPNetm tree has ``convs[i][j].{weight, root,
bias}``, ``fc1.{w, b}`` and ``fc2.{w, b}``; ``stack_params_from_jax``
takes a list of single-metapath trees of one length into an
``MPNetmStack``. ``scorer_params_from_jax``: the
relation scorer's ``{w, u}``. Each field is read by attribute or by key, so
a NamedTuple tree, a dict tree or a mix works, and the port never imports
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from mpgnn_tpu_torch.device import resolve_device
from mpgnn_tpu_torch.models.mpgnn import MPNetm, MPNetmStack
from mpgnn_tpu_torch.models.relconv import RelConvParams
from mpgnn_tpu_torch.models.scorer import ScorerParams


def _get(node, name: str):
    if isinstance(node, dict):
        return node[name]
    return getattr(node, name)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


@torch.no_grad()
def params_from_jax(tree, device=None) -> MPNetm:
    """An MPNetm on ``device`` holding the parameters of ``tree``. Linear
    weights are [in, out] in JAX and [out, in] in nn.Linear."""
    device = resolve_device(device)
    convs = _get(tree, "convs")
    first = _get(convs[0][0], "weight")
    fc2_w = np.asarray(_get(_get(tree, "fc2"), "w"))
    model = MPNetm(
        input_dim=int(np.shape(first)[0]), hidden_dim=int(np.shape(first)[1]),
        num_classes=int(fc2_w.shape[1]),
        metapath_lengths=[len(stack) for stack in convs], device=device,
    )
    for stack_src, stack in zip(convs, model.convs):
        for src, conv in zip(stack_src, stack):
            conv.load_params(RelConvParams(
                _t(_get(src, "weight")), _t(_get(src, "root")),
                _t(_get(src, "bias")),
            ))
    for name in ("fc1", "fc2"):
        fc = getattr(model, name)
        fc.weight.copy_(_t(_get(_get(tree, name), "w")).T)
        fc.bias.copy_(_t(_get(_get(tree, name), "b")))
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

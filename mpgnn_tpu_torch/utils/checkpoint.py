"""Model parameters on disk: a torch ``state_dict`` in ``<dir>/params.pt``."""

from __future__ import annotations

import os

import torch
from torch import nn

PARAMS_FILE = "params.pt"


def save_params(path: str, model: nn.Module) -> None:
    """Write ``model``'s state_dict (moved to the CPU) into directory
    ``path``, created if missing; the file is replaced atomically."""
    os.makedirs(path, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = os.path.join(path, PARAMS_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, PARAMS_FILE))


def restore_params(path: str, like: nn.Module) -> nn.Module:
    """Load the parameters saved by ``save_params`` into ``like`` (which
    gives the structure and the device) and return it."""
    state = torch.load(os.path.join(path, PARAMS_FILE), weights_only=True,
                       map_location="cpu")
    like.load_state_dict(state)
    return like

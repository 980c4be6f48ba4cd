"""Checkpoints: per-class search results as JSON (the JAX package's file
format), and model parameters as a torch ``state_dict`` in
``<dir>/params.pt``."""

from __future__ import annotations

import json
import os
from typing import Any

import torch
from torch import nn

PARAMS_FILE = "params.pt"


class SearchCheckpoint:
    """JSON-backed checkpoint of per-class search results, so that an
    interrupted multi-class run (the reference's one-vs-rest loop,
    main.py:1214) resumes at the next class. The file format is the JAX
    package's: either package reads the other's file."""

    def __init__(self, path: str):
        self.path = path
        self._state = {}
        if os.path.exists(path):
            with open(path) as f:
                self._state = json.load(f)

    def has(self, class_index: int) -> bool:
        return str(class_index) in self._state

    def save(self, class_index: int, result: Any) -> None:
        self._state[str(class_index)] = {
            "metapaths": result.metapaths,
            "test_f1": result.test_f1,
            "val_f1_by_path": result.val_f1_by_path,
            "discovered": result.discovered,
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._state, f)
        os.replace(tmp, self.path)

    def load(self, class_index: int):
        from mpgnn_tpu_torch.search.engine import SearchResult

        d = self._state[str(class_index)]
        return SearchResult(
            metapaths=d["metapaths"],
            test_f1=d["test_f1"],
            val_f1_by_path=d["val_f1_by_path"],
            discovered=d["discovered"],
        )


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

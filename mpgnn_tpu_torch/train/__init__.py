"""Hop operands, the training loop and metrics."""

from mpgnn_tpu_torch.train.loops import (  # noqa: F401
    MPGNNTrainResult,
    build_hop_arrays,
    evaluate_mpgnn,
    fit_mpgnn,
    make_optimizer,
    train_mpgnn,
)
from mpgnn_tpu_torch.train.metrics import macro_f1, macro_f1_np  # noqa: F401

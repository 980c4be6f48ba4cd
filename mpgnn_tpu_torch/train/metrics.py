"""Evaluation metrics."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def macro_f1(preds: torch.Tensor, labels: torch.Tensor,
             num_classes: int) -> torch.Tensor:
    """Macro-averaged F1 on the tensors' device, as sklearn's
    ``average='macro'``: classes absent from both predictions and labels are
    left out of the average. A 0-d float32 tensor."""
    c = torch.arange(num_classes, device=preds.device)[:, None]
    p = preds[None, :] == c
    t = labels[None, :] == c
    tp = (p & t).sum(1)
    fp = (p & ~t).sum(1)
    fn = (~p & t).sum(1)
    denom = 2 * tp + fp + fn
    f1 = 2.0 * tp / denom.clamp_min(1)
    present = (denom > 0).float()
    return (f1 * present).sum() / present.sum().clamp_min(1.0)


def macro_f1_np(preds, labels, num_classes: Optional[int] = None) -> float:
    """Macro-averaged F1 as sklearn's ``average='macro'``: classes absent
    from both predictions and labels are left out of the average. Per-class
    F1 is symmetric in (preds, labels), so the reference's swapped argument
    order gives the same value."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    if num_classes is None:
        num_classes = int(max(preds.max(initial=0), labels.max(initial=0))) + 1
    f1s = []
    for c in range(num_classes):
        tp = int(np.sum((preds == c) & (labels == c)))
        fp = int(np.sum((preds == c) & (labels != c)))
        fn = int(np.sum((preds != c) & (labels == c)))
        if tp + fp + fn > 0:
            f1s.append(2.0 * tp / (2 * tp + fp + fn))
    return float(np.mean(f1s)) if f1s else 0.0

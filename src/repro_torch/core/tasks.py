"""Intent-classification head (paper case study).  Counterpart of
``class_logits``, ``classification_loss_fn`` and
``classification_accuracy`` in ``src/repro/core/tasks.py``: class c's
logit is the LM logit of vocab id 1 + c at the last non-pad position."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.data.banking77 import N_CLASSES
from repro_torch.models import loss as losses


def class_logits(logits, batch: Dict):
    """logits: (B, S', V) -> (B, n_classes) at the last non-pad position."""
    offset = logits.shape[1] - batch["tokens"].shape[1]
    pos = offset + batch["lengths"].long() - 1
    g = logits[torch.arange(logits.shape[0], device=logits.device), pos]
    return g[:, 1:1 + N_CLASSES]


def classification_loss_fn(logits, batch):
    cl = class_logits(logits, batch)
    loss, _ = losses.cross_entropy(cl, batch["labels"])
    return loss, cl


def classification_loss_rows(logits, batch):
    """Each example's cross-entropy (B,): the mean of these rows is
    classification_loss_fn's loss, and row b is the loss of example b
    taken as a batch of one."""
    return losses.nll(class_logits(logits, batch), batch["labels"])


def classification_accuracy(logits, batch):
    return losses.accuracy(class_logits(logits, batch), batch["labels"])


def get_loss_fn(task: str):
    if task != "classification":
        raise NotImplementedError(f"task {task!r} is not ported yet")
    return classification_loss_fn


def get_loss_rows_fn(task: str):
    """The per-example form of get_loss_fn's loss (the DP-SGD step's)."""
    if task != "classification":
        raise NotImplementedError(f"task {task!r} is not ported yet")
    return classification_loss_rows

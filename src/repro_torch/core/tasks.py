"""Task heads: intent classification (the paper's case study) and
generative LM.  Counterpart of ``src/repro/core/tasks.py``: class c's
logit is the LM logit of vocab id 1 + c at the last non-pad position;
the generative loss is the shifted next-token cross-entropy over the
non-pad tokens (``tokens != 0``), the image or prompt prefix cut off
first.  As in the reference, any task but ``"classification"`` is
generative.

Beside the reference's batch losses, two per-example forms that the
port's batched steps take where the reference ``vmap``s: the DP step's
(each example's own loss, the reference's ``vmap`` of a batch of one:
``get_loss_rows_fn``) and the stacked clients' (each client's loss over
its rows, the reference's ``vmap`` over clients of its train step:
``get_clients_loss_fn``).  For classification both are means of the
same per-example rows; the generative loss is a token-weighted mean, so
there they differ."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import dtensor
from repro_torch.data.banking77 import N_CLASSES
from repro_torch.models import loss as losses
from repro_torch.runtime import compute_dtype


def class_logits(logits, batch: Dict):
    """logits: (B, S', V) -> (B, n_classes) at the last non-pad position."""
    offset = logits.shape[1] - batch["tokens"].shape[1]
    pos = offset + batch["lengths"].long() - 1
    if dtensor.is_distributed(logits):
        # DTensor runs an advanced index, and its backward, on the whole
        # logits on every rank: the position is picked by a mask instead
        at = dtensor.rows_like(pos[:, None] == torch.arange(
            logits.shape[1], device=logits.device), logits)
        g = (logits * at[..., None].to(logits.dtype)).sum(1)
    else:
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


def _shifted(logits, batch):
    """(the LM logits without the prefix, the shifted per-position nll
    (B, S - 1), the shifted pad mask (B, S - 1)), the nll in fp32 (fp64
    for fp64 logits)."""
    tokens = batch["tokens"]
    lg = dtensor.seq_slice(logits, logits.shape[1] - tokens.shape[1], None)
    nll = losses.nll(dtensor.seq_slice(lg, 0, -1).to(compute_dtype(lg.dtype)),
                     tokens[:, 1:])
    return lg, nll, (tokens[:, 1:] != 0).to(nll.dtype)


def generative_loss_fn(logits, batch):
    """The mean next-token loss over the batch's non-pad tokens (a token
    0 inside a sequence counts as pad, as in the reference); returns
    (loss, the logits without the prefix)."""
    tokens = batch["tokens"]
    mask = (tokens != 0).float()
    lg = dtensor.seq_slice(logits, logits.shape[1] - tokens.shape[1], None)
    loss, _ = losses.next_token_loss(lg, tokens, mask)
    return loss, lg


def generative_loss_rows(logits, batch):
    """Each example's own token mean (B,): row b is generative_loss_fn of
    example b taken as a batch of one (the DP step's per-example loss)."""
    _, nll, mask = _shifted(logits, batch)
    return (nll * mask).sum(1) / torch.clamp_min(mask.sum(1), 1.0)


def generative_loss_clients(logits, batch, n_clients: int):
    """Each stacked client's generative loss (C,): the token-weighted mean
    over the non-pad tokens of its B rows (the batch holds the clients'
    rows one after another), generative_loss_fn of its own batch."""
    _, nll, mask = _shifted(logits, batch)
    site = "core/tasks: the stacked clients' loss rows"
    num = dtensor.split_rows(nll * mask, n_clients, site).reshape(
        n_clients, -1).sum(1)
    return num / torch.clamp_min(dtensor.split_rows(
        mask, n_clients, site).reshape(n_clients, -1).sum(1), 1.0)


def task_logit_dim(task: str, vocab_size: int) -> int:
    """Paper SSIII.B: classification logits ~ n_classes; generative ~ V."""
    return N_CLASSES if task == "classification" else vocab_size


def get_loss_fn(task: str):
    return (classification_loss_fn if task == "classification"
            else generative_loss_fn)


def get_loss_rows_fn(task: str):
    """The per-example form of get_loss_fn's loss (the DP-SGD step's)."""
    return (classification_loss_rows if task == "classification"
            else generative_loss_rows)


def get_clients_loss_fn(task: str):
    """fn(logits, batch, C) -> each stacked client's loss (C,), the loss
    get_loss_fn gives each client's rows alone."""
    if task == "classification":
        return classification_loss_clients
    return generative_loss_clients


def classification_loss_clients(logits, batch, n_clients: int):
    """Each stacked client's classification loss (C,): the mean of its B
    rows' cross-entropies."""
    return dtensor.split_rows(classification_loss_rows(logits, batch),
                             n_clients, "core/tasks: the stacked clients' "
                             "loss rows").mean(dim=1)

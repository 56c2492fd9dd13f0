"""Cross-entropy and accuracy.  Counterpart of ``cross_entropy`` and
``accuracy`` in ``src/repro/models/loss.py`` (fp32)."""
from __future__ import annotations

import torch


def cross_entropy(logits, labels):
    """logits: (..., V); labels: (...) int.  Returns (mean_loss, n_tokens)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    return nll.mean(), nll.numel()


def accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()

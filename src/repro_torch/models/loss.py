"""Cross-entropy, the shifted LM loss, accuracy and the KD distillation
loss.  Counterpart of ``cross_entropy``, ``next_token_loss``, ``accuracy``
and ``kd_kl`` in ``src/repro/models/loss.py`` (fp32; fp64 for fp64
logits)."""
from __future__ import annotations

import torch

from repro_torch.runtime import compute_dtype


def nll(logits, labels):
    """logits: (..., V); labels: (...) int -> each position's negative
    log-likelihood (...)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def cross_entropy(logits, labels, mask=None):
    """logits: (..., V); labels: (...) int; mask (...) or None.  Returns
    (mean_loss, n_tokens): without a mask the mean over every position,
    with one sum(nll · mask) / n, n = max(sum(mask), 1) (a tensor)."""
    nll_ = nll(logits.to(compute_dtype(logits.dtype)), labels)
    if mask is None:
        return nll_.mean(), nll_.numel()
    mask = mask.to(nll_.dtype)
    n = torch.clamp_min(mask.sum(), 1.0)
    return (nll_ * mask).sum() / n, n


def next_token_loss(logits, tokens, mask=None):
    """The shifted LM loss: position s predicts token s + 1.  logits
    (B, S, V), tokens (B, S), mask (B, S) or None."""
    return cross_entropy(logits[:, :-1], tokens[:, 1:],
                         None if mask is None else mask[:, 1:])


def accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()


def kd_kl(student_logits, teacher_logits, temperature: float = 1.0,
          mask=None):
    """KL(teacher || student) with temperature, · T², mean over rows.

    Both logits (..., V).  The distillation loss of KD-FedLLMs (paper
    SSII.B): the streaming KD kernels under the ``cuda`` kernel policy,
    plain log-softmax under ``torch`` (kernels/ops.kd_loss; note the
    argument order flips there: teacher first)."""
    from repro_torch.kernels import ops as kernel_ops
    return kernel_ops.kd_loss(teacher_logits, student_logits,
                              float(temperature), mask)


def kd_kl_rows(student_logits, teacher_logits, temperature: float = 1.0):
    """kd_kl before its mean: each row's KL(teacher || student) · T², the
    rows flattened."""
    from repro_torch.kernels import ops as kernel_ops
    return kernel_ops.kd_loss_rows(teacher_logits, student_logits,
                                   float(temperature))

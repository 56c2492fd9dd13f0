"""Cross-entropy, accuracy and the KD distillation loss.  Counterpart of
``cross_entropy``, ``accuracy`` and ``kd_kl`` in
``src/repro/models/loss.py`` (fp32)."""
from __future__ import annotations

import torch


def nll(logits, labels):
    """logits: (..., V); labels: (...) int -> each position's negative
    log-likelihood (...)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def cross_entropy(logits, labels):
    """logits: (..., V); labels: (...) int.  Returns (mean_loss, n_tokens)."""
    nll_ = nll(logits, labels)
    return nll_.mean(), nll_.numel()


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

"""Cross-entropy, the shifted LM loss, accuracy and the KD distillation
loss.  Counterpart of ``cross_entropy``, ``next_token_loss``, ``accuracy``
and ``kd_kl`` in ``src/repro/models/loss.py`` (fp32; fp64 for fp64
logits)."""
from __future__ import annotations

import torch

from repro_torch import dtensor
from repro_torch.runtime import compute_dtype


def nll(logits, labels):
    """logits: (..., V); labels: (...) int -> each position's negative
    log-likelihood (...).  DTensor logits take no gather (its backward
    would make a zero gradient of the whole logits on every rank):
    sharded over V they go through _VocabParallelNLL on each rank's
    shard, else the gold logit is picked by a one-hot mask."""
    if dtensor.is_distributed(logits):
        if dtensor.shard_extent(logits, -1) > 1:
            return _vocab_parallel_nll(logits, labels)
        V = logits.shape[-1]
        hot = labels[..., None].long() == torch.arange(V,
                                                       device=logits.device)
        return torch.logsumexp(logits, dim=-1) - (
            logits * hot.to(logits.dtype)).sum(-1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


class _VocabParallelNLL(torch.autograd.Function):
    """Each row's nll from one rank's vocab shard (R, V_l) of the logits,
    its shard starting at class ``start``: the row max, the sum of
    exponentials and the gold logit all-reduced over ``group`` (the
    mesh axis sharding V), the vocab-parallel cross-entropy of
    tensor-parallel training.  The gradient, (softmax − one-hot) times
    the row's, needs no collective."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        import torch.distributed._functional_collectives as funcol

        Vl = logits.shape[-1]
        m = funcol.all_reduce(logits.amax(-1), "max", group)
        e = torch.exp(logits - m[:, None])
        se = funcol.all_reduce(e.sum(-1), "sum", group)
        inside = (labels >= start) & (labels < start + Vl)
        idx = (labels - start).clamp(0, Vl - 1)
        gold = torch.gather(logits, -1, idx[:, None])[:, 0] * inside
        gold = funcol.all_reduce(gold, "sum", group)
        ctx.save_for_backward(e, se, idx, inside)
        return m + torch.log(se) - gold

    @staticmethod
    def backward(ctx, g):
        e, se, idx, inside = ctx.saved_tensors
        grad = e / se[:, None]
        grad = grad.scatter_add(-1, idx[:, None],
                                -inside.to(grad.dtype)[:, None])
        return grad * g[:, None], None, None, None


def _vocab_parallel_nll(logits, labels):
    """nll of DTensor logits (..., V) sharded over V on one mesh axis:
    _VocabParallelNLL on each rank's rows and vocab shard, the rows'
    other shards kept; labels take the logits' row layout."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, last = logits.device_mesh, logits.dim() - 1
    (axis,) = [i for i, p in enumerate(logits.placements)
               if p.is_shard(last)]
    rows = [Replicate() if p.is_shard(last) or p.is_partial() else p
            for p in logits.placements]
    logits = dtensor.relayout(logits, rows[:axis] + [logits.placements[
        axis]] + rows[axis + 1:])
    labels = dtensor.relayout(labels, rows)
    local = logits.to_local()
    Vl = -(-logits.shape[-1] // mesh.size(axis))
    start = mesh.get_local_rank(axis) * Vl
    out = _VocabParallelNLL.apply(
        local.reshape(-1, local.shape[-1]), labels.to_local().reshape(-1),
        start, mesh.get_group(axis))
    return DTensor.from_local(out.reshape(labels.to_local().shape), mesh,
                              rows, run_check=False, shape=labels.shape,
                              stride=labels.stride())


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
    return cross_entropy(dtensor.seq_slice(logits, 0, -1), tokens[:, 1:],
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

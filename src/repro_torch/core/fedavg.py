"""FedLLMs — the paper's foundational framework (SSII.A):

    a1 server -> clients: global tunable (LoRA) parameters
    a2 client: local PEFT fine-tuning on private data
    a3 clients -> server: fine-tuned tunable parameters
    a4 server: aggregation (FedAvg) -> next global parameters

Counterpart of ``make_fns`` (train, eval, logit and KD steps, shared by
the frameworks), ``fedavg`` and ``evaluate`` in
``src/repro/core/fedavg.py``, with the stacked clients' forms of the
train, logit and KD steps that the ``spmd`` backend runs where the
reference ``vmap``s them (core/fed_spmd.py).  The base model is a frozen
constant of the loss: gradients are taken with respect to the LoRA leaves
only (the PEFT property, paper fn.1).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import dtensor
from repro_torch import tree as tree_lib
from repro_torch.configs.base import FedConfig
from repro_torch.core import tasks
from repro_torch.data.loader import epoch_batches
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import loss as losses
from repro_torch.models.factory import Model
from repro_torch.optim.api import make_client_update, make_optimizer
from repro_torch.peft import lora as lora_lib
from repro_torch.privacy import dp as dp_mod
from repro_torch.runtime import compute_dtype


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``: integer arrays (tokens, lengths,
    labels) as int64, floating ones (a model's ``enc_embeds``,
    ``img_embeds``, ``prefix_embeds``) as float32."""
    return {k: torch.as_tensor(v, device=device, dtype=torch.float32
                               if np.issubdtype(np.asarray(v).dtype,
                                                np.floating)
                               else torch.int64)
            for k, v in batch.items()}


def _grad(loss, live):
    """d loss / d each leaf of the LoRA tree ``live``; none for an empty
    tree (targets the model does not have), which then stays as it is."""
    leaves = tree_lib.leaves(live)
    return list(torch.autograd.grad(loss, leaves)) if leaves else []


def make_fns(model: Model, fed: FedConfig, task: str = "classification"):
    """Returns a dict with ``train_step``, ``per_example_grads``,
    ``eval_step``, ``logits_fn``, ``kd_step``, ``opt_init`` and the
    stacked clients' ``grads_clients``, ``per_example_grads_clients``,
    ``train_step_clients``, ``logits_fn_clients`` and
    ``kd_step_clients``."""
    task_loss = tasks.get_loss_fn(task)
    task_loss_rows = tasks.get_loss_rows_fn(task)
    clients_loss = tasks.get_clients_loss_fn(task)
    classification = task == "classification"
    opt_init, opt_update = make_optimizer(fed.optimizer)
    clients_update = make_client_update(fed.optimizer)
    dp_clip = fed.privacy.dp_clip

    def _bind(base, lt, gen: Optional[torch.Generator] = None):
        rank = lora_lib.tree_rank(lt, fed.lora_rank)
        return lora_lib.bind(base, lt, fed.lora_alpha, rank,
                             dropout_gen=gen, dropout=fed.lora_dropout)

    def _knowledge(logits, batch):
        """KD's knowledge representation: the class logits (B, n_classes)
        for classification, the full LM logits (B, S', V) otherwise."""
        return tasks.class_logits(logits, batch) if classification \
            else logits

    def _per_example_pass(base, lt, batch, gen, who):
        """One forward of ``batch`` under kernels/ops.per_example_scope and
        the backward of the summed per-example losses to the scope's
        sinks: (the live LoRA leaves, each example's loss, the sites,
        each site's sink gradients).  The LoRA tree is bound once, so
        every example sees the step's one dropout mask, as the
        reference's shared rng gives.  A MoE model routes each example on
        its own inside the scope and gives each its aux term (B,), which
        joins that example's loss, as the reference's batch-1 passes
        do."""
        live = [t.detach().requires_grad_(True) for t in tree_lib.leaves(lt)]
        bound = _bind(base, tree_lib.unflatten(lt, live), gen)
        with kernel_ops.per_example_scope(batch["tokens"].shape[0]) as sites:
            logits, aux = model.forward(bound, batch)
        rows = task_loss_rows(logits, batch)
        if torch.is_tensor(aux) and aux.requires_grad and \
                aux.shape != rows.shape:
            raise ValueError(f"{who}: the model's aux term carries a "
                             "gradient and is not one a row; it mixes the "
                             "examples, so one batched pass cannot give "
                             "each example's gradient")
        losses_ = rows + aux
        sinks = [t for site in sites for t in site[2:]]
        return live, losses_, sites, torch.autograd.grad(losses_.sum(), sinks)

    def per_example_grads(base, lt, batch, gen=None):
        """(losses (B,), grads (B, P) fp32, fp64 for fp64 LoRA leaves):
        each example's task loss and its gradient w.r.t. the LoRA leaves,
        row b holding example b's gradients in ``tree.leaves`` order: the
        reference's ``vmap`` of ``value_and_grad(example_loss)``.

        One forward and one backward of the whole batch, on the sum of the
        per-example losses: no ported layer mixes examples inside the
        scope (a MoE layer routes each row alone), so each example's
        activation gradient is its own.  The batch's extras (a model's
        ``enc_embeds`` or ``img_embeds``) lead with the batch too, so each
        example reads its own rows of them, as the reference's ``vmap``
        over the batch dict slices them; each LoRA site's per-example
        length is its input's own (an encoder-decoder's encoder and
        cross-attention wk/wv sites S_enc, its other sites the text's S).  Under
        kernels/ops.per_example_scope each LoRA projection's backward
        gives each example's gradient w.r.t. the bound a′ and b′ (the
        ``lora_panel_examples`` kernel under the ``cuda`` policy); bind's
        own VJP, batched over the examples, carries them to the leaves."""
        live, losses_, sites, per_site = _per_example_pass(
            base, lt, batch, gen, "per_example_grads")
        B = batch["tokens"].shape[0]
        grads = torch.autograd.grad(
            [t for site in sites for t in site[:2]], live, per_site,
            is_grads_batched=True)
        dt = compute_dtype(live[0].dtype)
        rows = torch.cat([g.reshape(B, -1).to(dt) for g in grads], dim=1)
        return losses_.detach().to(dt), rows

    def train_step(base, lt, opt_state, batch, gen=None):
        """One local step: value and gradient of the task loss w.r.t. the
        LoRA leaves, then the optimizer.  ``gen`` draws the LoRA dropout
        masks.  Under DP the gradient is the mean of the per-example
        gradients clipped to ``dp_clip`` and the loss the mean of the
        per-example losses.  Returns (new_lt, new_opt_state, loss)."""
        if dp_clip > 0.0:
            losses_, rows = per_example_grads(base, lt, batch, gen)
            mean = dp_mod.clipped_grad_mean(rows, dp_clip)      # (P,)
            grads, off = [], 0
            for t in tree_lib.leaves(lt):
                grads.append(mean[off:off + t.numel()].view_as(t))
                off += t.numel()
            loss = losses_.mean()
        else:
            live = tree_lib.map_(lambda t: t.detach().requires_grad_(True),
                                 lt)
            logits, aux = model.forward(_bind(base, live, gen), batch)
            loss, _ = task_loss(logits, batch)
            loss = loss + aux
            grads = _grad(loss, live)
        new_lt, new_opt = opt_update(tree_lib.unflatten(lt, grads),
                                     opt_state, lt, fed.lr)
        # metric-only guard: a diverged batch must not poison the mean
        loss = loss.detach()
        loss = torch.where(torch.isfinite(loss), loss, 0.0)
        return new_lt, new_opt, loss

    @torch.no_grad()
    def eval_step(base, lt, batch):
        """(accuracy, loss); a generative task's accuracy is minus its
        loss, as in the reference."""
        logits, _ = model.forward(_bind(base, lt), batch)
        loss, _ = task_loss(logits, batch)
        acc = tasks.classification_accuracy(logits, batch) \
            if classification else -loss
        return acc, loss

    @torch.no_grad()
    def logits_fn(base, lt, batch):
        """Knowledge representation for KD (paper b2/b6): the class
        logits (B, n_classes) for classification, the full LM logits
        (B, S', V) for a generative task."""
        logits, _ = model.forward(_bind(base, lt), batch)
        return _knowledge(logits, batch)

    def kd_step(base, lt, opt_state, batch, teacher_logits, gen=None):
        """Distill ``teacher_logits`` into the student's LoRA leaves: one
        optimizer step on KL(teacher || student) at ``fed.kd_temperature``
        over the student's knowledge (logits_fn's; a generative task's
        every position, unmasked, as in the reference).  Returns (new_lt,
        new_opt_state, loss)."""
        live = tree_lib.map_(lambda t: t.detach().requires_grad_(True), lt)
        logits, aux = model.forward(_bind(base, live, gen), batch)
        student = _knowledge(logits, batch)
        loss = losses.kd_kl(student, teacher_logits, fed.kd_temperature) + aux
        grads = _grad(loss, live)
        new_lt, new_opt = opt_update(tree_lib.unflatten(lt, grads),
                                     opt_state, lt, fed.lr)
        return new_lt, new_opt, loss.detach()

    # ---- the stacked clients (the ``spmd`` backend) -------------------- #
    # Every LoRA leaf leads with the client axis C and a batch holds the
    # clients' batches one after another (C·B rows); each LoRA projection
    # is one client-axis pass (kernels/ops.lora_matmul), and one forward
    # and backward of the sum over clients of each client's loss (the
    # task's loss of its rows alone) gives each client its own gradient, since no ported layer mixes
    # clients: under kernels/ops.clients_scope a MoE layer routes each
    # client's rows on their own and gives each client its aux term (C,),
    # as the reference's vmap over clients does.  ``gens`` holds each
    # client's dropout generator.
    def _clients_grads(base, slt, batch, gens, loss_fn):
        """(each client's loss (C,), each client's LoRA gradient as a tree
        like ``slt``) of one stacked pass; ``loss_fn(logits, C)`` gives
        each client's loss."""
        live = tree_lib.map_(lambda t: t.detach().requires_grad_(True),
                             slt)
        C = tree_lib.leaves(slt)[0].shape[0]
        with kernel_ops.clients_scope(C):
            logits, aux = model.forward(_bind(base, live, gens), batch)
        if torch.is_tensor(aux) and aux.requires_grad and \
                aux.shape != (C,):
            raise ValueError("stacked clients' step: the model's aux term "
                             "carries a gradient and is not one a client; "
                             "it mixes the clients' examples, so one stacked "
                             "pass cannot give each client its own gradient")
        losses_ = loss_fn(logits, C) + aux
        return (losses_.detach(),
                tree_lib.unflatten(slt, _grad(losses_.sum(), live)))

    def grads_clients(base, slt, batch, gens=None):
        """The stacked train step's (each client's loss (C,), each
        client's LoRA gradient with ``slt``'s leading client axis)."""
        return _clients_grads(base, slt, batch, gens,
                              lambda lg, C: clients_loss(lg, batch, C))

    def per_example_grads_clients(base, slt, batch, gens=None):
        """per_example_grads of every stacked client on its rows of
        ``batch``: (losses (C, B), rows (C, B, P)), rows[c, j] example j
        of client c's gradient with respect to client c's LoRA leaves in
        ``tree.leaves`` order (the reference's ``vmap`` over clients of
        its per-example ``vmap``).  One forward and one backward of the
        stacked batch under kernels/ops.per_example_scope: each LoRA site
        gives each example's gradient with respect to its own client's
        bound factors.  Bind acts on each client's factors alone, so its
        VJP, batched over the B examples of a client with the C clients'
        example j side by side in batch entry j, carries them to each
        client's leaves: no gradient with respect to another client's
        leaves is formed."""
        live, losses_, sites, per_site = _per_example_pass(
            base, slt, batch, gens, "per_example_grads_clients")
        C = live[0].shape[0]
        B = batch["tokens"].shape[0] // C
        # (C·B, ...) -> (B, C, ...): batch entry j holds every client's
        # example j, against the (C, ...) bound factors
        per_site = [g.view(C, B, *g.shape[1:]).transpose(0, 1)
                    for g in per_site]
        grads = torch.autograd.grad(
            [t for site in sites for t in site[:2]], live, per_site,
            is_grads_batched=True)
        dt = compute_dtype(live[0].dtype)
        rows = torch.cat([g.transpose(0, 1).reshape(C, B, -1).to(dt)
                          for g in grads], dim=2)
        return losses_.detach().to(dt).view(C, B), rows

    def train_step_clients(base, slt, sopt, batch, gens=None, valid=None):
        """train_step for stacked clients: ``slt`` and ``sopt`` lead with
        the client axis (``sopt["step"]`` each client's count), ``batch``
        holds the clients' batches one after another.  Under DP each
        client's gradient is the mean of its per-example gradients clipped
        to ``dp_clip`` (privacy/dp.clipped_grad_mean_clients) and its loss
        the mean of its per-example losses.  A client whose ``valid``
        entry is false (a padded step) keeps its LoRA and optimizer state.
        Returns (new_slt, new_sopt, each client's loss (C,))."""
        if dp_clip > 0.0:
            losses_, rows = per_example_grads_clients(base, slt, batch, gens)
            mean = dp_mod.clipped_grad_mean_clients(rows, dp_clip)  # (C, P)
            leaves, off = [], 0
            for t in tree_lib.leaves(slt):
                n = t[0].numel()
                leaves.append(mean[:, off:off + n].view_as(t))
                off += n
            loss, grads = losses_.mean(dim=1), tree_lib.unflatten(slt, leaves)
        else:
            loss, grads = grads_clients(base, slt, batch, gens)
        new_lt, new_opt = clients_update(grads, sopt, slt, fed.lr, valid)
        return new_lt, new_opt, torch.where(torch.isfinite(loss), loss, 0.0)

    @torch.no_grad()
    def logits_fn_clients(base, slt, batch):
        """logits_fn of every stacked client on its rows of ``batch`` (a
        batch repeated C times): (C, B, n_classes), or (C, B, S', V) for a
        generative task."""
        C = tree_lib.leaves(slt)[0].shape[0]
        with kernel_ops.clients_scope(C):
            logits, _ = model.forward(_bind(base, slt), batch)
        return dtensor.split_rows(_knowledge(logits, batch), C,
                                 "core/fedavg: the stacked clients' "
                                 "knowledge rows")

    def kd_step_clients(base, slt, sopt, batch, teacher_logits, gens=None):
        """kd_step of every stacked client on its rows of ``batch`` (a
        public batch repeated C times) against the shared
        ``teacher_logits`` (B, D), or (B, S', V) for a generative task:
        each client's loss the mean KL over its rows (every position of
        them).  Returns (new_slt, new_sopt, each client's loss (C,))."""
        def per_client(logits, C):
            student = _knowledge(logits, batch)
            teacher = teacher_logits.repeat(
                C, *([1] * (teacher_logits.dim() - 1)))
            return dtensor.split_rows(
                losses.kd_kl_rows(student, teacher, fed.kd_temperature), C,
                "core/fedavg: the stacked clients' KD rows").mean(1)

        loss, grads = _clients_grads(base, slt, batch, gens, per_client)
        new_lt, new_opt = clients_update(grads, sopt, slt, fed.lr)
        return new_lt, new_opt, loss

    return {"train_step": train_step, "per_example_grads": per_example_grads,
            "eval_step": eval_step, "logits_fn": logits_fn,
            "kd_step": kd_step, "opt_init": opt_init,
            "grads_clients": grads_clients,
            "per_example_grads_clients": per_example_grads_clients,
            "train_step_clients": train_step_clients,
            "logits_fn_clients": logits_fn_clients,
            "kd_step_clients": kd_step_clients}


# --------------------------------------------------------------------------- #
# Aggregation (a4)
# --------------------------------------------------------------------------- #
@torch.no_grad()
def fedavg(trees: Sequence, weights: Optional[Sequence[float]] = None):
    """Weighted FedAvg of identically-structured trees (fp32 sums in
    client order, as the reference; fp64 for fp64 leaves)."""
    if weights is None:
        weights = [1.0] * len(trees)
    total = float(sum(weights))
    ws = [w / total for w in weights] if total > 0 \
        else [1.0 / len(trees)] * len(trees)

    def mean(*leaves):
        dt = compute_dtype(leaves[0].dtype)
        out = leaves[0].to(dt) * ws[0]
        for w, leaf in zip(ws[1:], leaves[1:]):
            out = out + leaf.to(dt) * w
        return out.to(leaves[0].dtype)

    return tree_lib.map_(mean, trees[0], *trees[1:])


def evaluate(fns, base, lt, data: Dict, batch_size: int, device) -> tuple:
    """Mean accuracy/loss over a dataset (drop-remainder batches), the
    batches moved to ``device``, where ``base`` and ``lt`` live."""
    accs, losses_, n = [], [], 0
    for batch in epoch_batches(data, batch_size, seed=0):
        a, l = fns["eval_step"](base, lt, to_device(batch, device))
        accs.append(float(a) * len(batch["tokens"]))
        losses_.append(float(l) * len(batch["tokens"]))
        n += len(batch["tokens"])
    if n == 0:
        return 0.0, 0.0
    return sum(accs) / n, sum(losses_) / n

"""The stacked-client execution backend (``FedConfig(backend="spmd")``).

Counterpart of ``src/repro/core/fed_spmd.py`` for FedLLM, KD-FedLLM and
Split-FedLLM with uniform LoRA ranks.  The reference runs each rank
bucket's local updates as one ``jit(vmap(local_update))`` program, the
round's clients stacked on a leading axis; ``torch.func.vmap`` cannot
batch the port's ctypes kernels, so here the local update is a plain
function over stacked tensors: every LoRA leaf carries a leading client
axis C, a step's batch is the clients' batches one after another (C·B
rows), and each LoRA projection is one client-axis pass
(kernels/ops.lora_matmul with stacked factors: the client-axis kernels of
kernels/lora_matmul.py under the ``cuda`` policy).  The step's loss is the
sum over clients of each client's mean loss, and no ported layer mixes
examples, so each client's gradient is its own
(core/fedavg's ``train_step_clients``).

Clients with ragged batch counts are padded with their last batch and
masked (``valid``): a padded step leaves that client's LoRA, Adam moments
and Adam step count as they were (the reference's ``_select``), so every
client performs exactly the step sequence of the sequential backend.

Split-FedLLM's server half is trained client after client (the
reference's scan over the client axis), so under uniform ranks its
stacked program is the sequential executor's loop
(core/round_program.SpmdExecutor.split_train); ``rank_segments`` is the
rule that groups its clients once ranks differ.

Not ported: ``weighted_client_mean`` (aggregation stays the programs'
``fedavg`` under either executor), ``hierarchical_client_mean`` (the
cohort-streaming executor's), ``robust_client_combine`` (``robust_agg``
is refused), ``make_kd_spmd_fns`` (the KD stages call core/fedavg's
stacked steps directly), and the PRNG key grids (``split_keys``,
``split_each``): the port draws each client's dropout masks from
``round_program.local_generator``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import FedConfig
from repro_torch.core.fedavg import make_fns, to_device
from repro_torch.data.loader import epoch_batches
from repro_torch.models.factory import Model


# --------------------------------------------------------------------------- #
# Stacking utilities (host side)
# --------------------------------------------------------------------------- #
def _stack_leaf(xs):
    """Tensors stack on a new axis 0; an integer leaf (an optimizer's step
    count) becomes an int64 (C,) tensor on the host."""
    if torch.is_tensor(xs[0]):
        return torch.stack(xs)
    return torch.tensor(xs, dtype=torch.int64)


def stack_for_clients(tree, n_clients: int):
    """Broadcast one tree to a leading client axis (a1: distribute)."""
    return stack_trees([tree] * n_clients)


def stack_trees(trees: Sequence):
    """Stack identically-structured per-client trees on a new axis 0."""
    return tree_lib.map_(lambda *xs: _stack_leaf(xs), trees[0], *trees[1:])


def unstack_tree(stacked):
    """Inverse of ``stack_trees``: a list of per-client trees from a
    leading-axis stack (integer leaves back to Python ints)."""
    n = tree_lib.leaves(stacked)[0].shape[0]

    def pick(x, i):
        return x[i] if x.is_floating_point() else int(x[i])

    return [tree_lib.map_(lambda x: pick(x, i), stacked) for i in range(n)]


def stack_client_batches(clients_data: List[Dict], batch_size: int,
                         seeds: Sequence[int]):
    """Every client's shuffled epoch batches as stacked host arrays with a
    leading (client, step) axis plus a validity mask.

    ``seeds`` is the per-epoch seed sequence handed to ``epoch_batches``,
    the one the sequential backend uses, so each client sees the same
    batch order under both backends.  Clients with fewer batches than the
    longest are padded by repeating their last batch with
    ``valid=False``; the stacked step drops those updates, so per-client
    step counts are preserved exactly.

    Returns ``(batches, valid, n_tok)``: batches leaves are (C, S, B, ...)
    numpy arrays, ``valid`` a (C, S) bool array, and ``n_tok`` the
    per-client real token counts for the cost model."""
    per_client = []
    for data in clients_data:
        client_batches = []
        for seed in seeds:
            client_batches.extend(epoch_batches(data, batch_size, seed=seed))
        per_client.append(client_batches)
    require_full_batch(clients_data, batch_size)
    n_steps = [len(b) for b in per_client]
    n_tok = [sum(b["tokens"].size for b in bs) for bs in per_client]
    S = max(n_steps)
    valid = np.zeros((len(per_client), S), bool)
    rows = []
    for ci, bs in enumerate(per_client):
        valid[ci, :len(bs)] = True
        padded = bs + [bs[-1]] * (S - len(bs))
        rows.append({k: np.stack([b[k] for b in padded]) for k in bs[0]})
    batches = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    return batches, valid, n_tok


def require_full_batch(clients_data: List[Dict], batch_size: int) -> None:
    """The stacked backend's ValueError for a client with no full batch
    (``epoch_batches`` drops a short remainder)."""
    sizes = [len(d["tokens"]) for d in clients_data]
    if min(sizes) < batch_size:
        raise ValueError(
            "spmd backend: every client needs at least one full batch "
            f"(batch_size={batch_size}, client sizes={sizes})")


def step_batch(batches: Dict, s: int) -> Dict[str, torch.Tensor]:
    """Step ``s`` of stacked batches (tensors, to_device of
    ``stack_client_batches``' arrays): the clients' batches one after
    another, (C·B, ...)."""
    return {k: v[:, s].reshape((-1,) + tuple(v.shape[3:]))
            for k, v in batches.items()}


def repeat_batch(batch: Dict, n_clients: int, device):
    """One batch repeated for every stacked client (the public set's
    batches of KD's b2 and b8), (C·B, ...) tensors on ``device``."""
    return to_device({k: np.concatenate([v] * n_clients)
                      for k, v in batch.items()}, device)


def rank_buckets(ranks: Sequence[int], clients: Sequence[int] = None):
    """Group client indices by LoRA rank: ``[(rank, [client, ...]), ...]``
    ordered by first occurrence, client order preserved within a bucket.
    Each bucket runs as one stacked program (clients in a bucket share
    tree shapes, so they stack on a leading axis)."""
    if clients is None:
        clients = range(len(ranks))
    out: Dict[int, List[int]] = {}
    for ci in clients:
        out.setdefault(ranks[ci], []).append(ci)
    return list(out.items())


def rank_segments(ranks: Sequence[int], clients: Sequence[int] = None):
    """Maximal runs of equal-rank clients in visit order:
    ``[(rank, [client, ...]), ...]``.  Split-FedLLM buckets this way: the
    shared server half is trained client after client (paper schedule),
    so only contiguous equal-rank runs may stack without reordering the
    server-half trajectory."""
    segs: List = []
    if clients is None:
        clients = range(len(ranks))
    for ci in clients:
        if segs and ranks[ci] == segs[-1][0]:
            segs[-1][1].append(ci)
        else:
            segs.append((ranks[ci], [ci]))
    return segs


# --------------------------------------------------------------------------- #
# Shared local-update machinery (FedLLM a2 / KD b1)
# --------------------------------------------------------------------------- #
def make_local_update(model: Model, fed: FedConfig,
                      task: str = "classification", fns=None):
    """Returns local_update(base, slt, sopt, batches, valid, gens, device)
    running every stacked client's batch sequence at once: step s trains
    each client on its batch s (``train_step_clients``, the sequential
    backend's train step stacked over clients), a client whose step s is
    padding keeping its carry.  Returns (slt, sopt, per-client mean loss
    over its real steps).  It is already the stacked function, so it also
    stands for the reference's ``make_bucket_update`` (its
    ``jit(vmap(local_update))``), the closing FedAvg left to the
    program's aggregate stage.  The batches and the mask go to ``device``
    once a call, so the steps queue on the card without waiting for it."""
    step = (fns or make_fns(model, fed, task))["train_step_clients"]

    def local_update(base, slt, sopt, batches, valid, gens, device):
        batches = to_device(batches, device)
        ok = torch.as_tensor(valid, device=device)
        totals = 0.0
        for s in range(valid.shape[1]):
            slt, sopt, loss = step(base, slt, sopt, step_batch(batches, s),
                                   gens, valid[:, s])
            totals = totals + torch.where(ok[:, s], loss, 0.0)
        return slt, sopt, totals / ok.sum(dim=1).clamp_min(1).float()

    return local_update

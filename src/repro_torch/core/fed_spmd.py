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

The client-axis reductions: ``weighted_client_mean`` (FedAvg over the
leading axis, which ``norm_clip`` ends with) and the Byzantine-robust
``robust_client_combine`` (median, trimmed mean, norm clip), which
core/async_agg.combine_arrivals and KD's robust teacher
(core/round_program) call on the stacked arrivals.

Not ported: ``client_combine`` (no caller in the reference either),
``hierarchical_client_mean`` and the launch layer's
whole-round programs, its only callers (the cohort-streaming executor
folds through round_program._fold_add), ``make_kd_spmd_fns`` (the KD
stages call core/fedavg's stacked steps directly), and the PRNG key
grids (``split_keys``, ``split_each``): the port draws each client's
dropout masks from ``round_program.local_generator``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import FedConfig
from repro_torch.core.fedavg import make_fns, to_device
from repro_torch.data.loader import epoch_batches
from repro_torch.models.factory import Model
from repro_torch.runtime import compute_dtype


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


def unstack_tree(stacked, n: int = None):
    """Inverse of ``stack_trees``: a list of per-client trees from a
    leading-axis stack (integer leaves back to Python ints).  ``n``, the
    number of clients, is read off the leaves when it is None; a tree
    without leaves (SGD's state without momentum, ``{"mu": None}``)
    needs it."""
    if n is None:
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
# Client-axis reductions: FedAvg and the Byzantine-robust combines
# --------------------------------------------------------------------------- #
def _normalized(weights):
    """Weights normalized to sum 1, uniform when the total is zero (a
    cohort of zero weight must not make the aggregate NaN).  For a
    positive total the divisor is the plain sum."""
    w = weights.float()
    s = w.sum()
    return torch.where(s > 0, w / torch.where(s > 0, s, s.new_tensor(1.0)),
                       1.0 / w.shape[0])


def _client_axis(w, x):
    """``w`` (C,) shaped to multiply a (C, ...) leaf."""
    return w.reshape((-1,) + (1,) * (x.dim() - 1))


def weighted_client_mean(stacked_tree, weights):
    """FedAvg as a reduction over the leading client axis, summed in fp32
    (fp64 for fp64 leaves, as core/fedavg.fedavg) and cast back."""
    def mean(x):
        dt = compute_dtype(x.dtype)
        w = _normalized(weights).to(x.device, dt)
        return (_client_axis(w, x) * x.to(dt)).sum(dim=0).to(x.dtype)

    return tree_lib.map_(mean, stacked_tree)


def _median(x):
    """The median over axis 0 as ``jnp.median`` takes it: the middle pair
    of the sorted client axis times 0.5 (their mean for an even count,
    the middle value for an odd one), NaN where the axis holds a NaN.
    ``torch.median`` takes the lower of the pair, and ``torch.quantile``
    refuses inputs above 2^24 elements."""
    C = x.shape[0]
    s = torch.sort(x, dim=0).values
    m = (s[(C - 1) // 2] + s[C // 2]) * 0.5
    return torch.where(torch.isnan(x).any(dim=0), x.new_tensor(math.nan), m)


def robust_client_combine(stacked_tree, weights, method: str,
                          trim_frac: float = 0.2, clip_norm: float = 0.0):
    """Byzantine-robust counterpart of ``weighted_client_mean`` over the
    stacked client axis (``FedConfig.robust_agg``):

    - ``median``: the coordinate-wise median, unweighted.
    - ``trimmed_mean``: per coordinate, the sorted client axis less
      ``int(trim_frac * C)`` values at each end (at most ``(C - 1) //
      2``), then the unweighted mean.
    - ``norm_clip``: each client's update clipped to a global L2 norm of
      ``clip_norm`` (0: the median of the C norms), then the weighted
      mean.

    Each sums in fp32 (fp64 for fp64 leaves) and casts back to the leaf
    dtype; none changes a payload's shape, so the ledger bytes are the
    plain mean's."""
    if method in ("mean", None, ""):
        return weighted_client_mean(stacked_tree, weights)
    C = tree_lib.leaves(stacked_tree)[0].shape[0]
    if method == "median":
        return tree_lib.map_(
            lambda x: _median(x.to(compute_dtype(x.dtype))).to(x.dtype),
            stacked_tree)
    if method == "trimmed_mean":
        k = int(trim_frac * C)
        if 2 * k >= C:
            k = (C - 1) // 2

        def tmean(x):
            s = torch.sort(x.to(compute_dtype(x.dtype)), dim=0).values
            return s[k:C - k].mean(dim=0).to(x.dtype)

        return tree_lib.map_(tmean, stacked_tree)
    if method == "norm_clip":
        xs = tree_lib.leaves(stacked_tree)
        dt = compute_dtype(xs[0].dtype)
        sq = sum(x.to(dt).square().reshape(C, -1).sum(dim=1) for x in xs)
        norms = torch.sqrt(sq)                                  # (C,)
        tau = norms.new_tensor(clip_norm) if clip_norm > 0 \
            else _median(norms)
        scale = torch.clamp_max(tau / torch.clamp_min(norms, 1e-12), 1.0)
        clipped = tree_lib.map_(
            lambda x: (_client_axis(scale, x).to(x.device)
                       * x.to(compute_dtype(x.dtype))).to(x.dtype),
            stacked_tree)
        return weighted_client_mean(clipped, weights)
    raise ValueError(f"unknown robust_agg {method!r}")


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

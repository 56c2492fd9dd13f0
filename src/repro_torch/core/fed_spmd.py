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
leading axis, which ``norm_clip`` ends with), the Byzantine-robust
``robust_client_combine`` (median, trimmed mean, norm clip), which
core/async_agg.combine_arrivals and KD's robust teacher
(core/round_program) call on the stacked arrivals,
``hierarchical_client_mean`` (the two-hop per-edge partial sums and a
pairwise tree over the edges) and ``client_combine`` (the configured
one).

The whole-round programs of the launch layer (launch/steps.py, through
core/round_program's ``spmd_round``s): ``make_spmd_round`` (FedLLM: the
stacked local update, then the client-axis FedAvg) and
``make_split_spmd_round`` (Split: the server half carried over the
clients in order, then the client halves' FedAvg).  KD's
(``KDProgram.spmd_round``) is built from core/fedavg's stacked steps
(``logits_fn_clients``, ``kd_step_clients``), which stand for the
reference's ``make_kd_spmd_fns`` here as in the executor
(round_program._batched_public_logits, _batched_distill).  Where the
reference takes a (C, S) grid of PRNG keys (``split_keys``,
``split_each``), the port takes one ``torch.Generator`` a client, which
draws that client's dropout masks step after step (as
``round_program.local_generator`` does for the executors), and for the
privacy noise one generator a client (FedLLM, KD) or a (C, S) grid of
them (Split).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch import dtensor
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
    another, (C·B, ...).  A DTensor's batch dim, which DTensor cannot
    flatten into the client dim while it is sharded, is made whole first
    (dtensor.replicated; the step's inputs are small), and the rows are
    sharded over the data axes again."""
    out = {}
    for k, v in batches.items():
        x = v[:, s]
        if dtensor.is_distributed(x):
            x = dtensor.replicated(x, (1,), "core/fed_spmd.step_batch: the "
                                  "stacked batch dim")
            out[k] = dtensor.hint(x.reshape((-1,) + tuple(v.shape[3:])),
                                 ("pod", "data"), *([None] * (v.dim() - 3)))
        else:
            out[k] = x.reshape((-1,) + tuple(v.shape[3:]))
    return out


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


def hierarchical_client_mean(stacked_tree, weights, n_edges: int):
    """FedAvg as the two-hop reduction of a client -> edge -> server
    topology: the client axis reshaped to (edges, clients an edge), each
    edge's weighted partial sum, then the edges folded by a pairwise
    halving tree (part[:m] + part[m:2m], an odd one carried), in fp32
    (fp64 for fp64 leaves).  The same normalized weights as
    ``weighted_client_mean``, summed in another order; the flat mean
    when ``n_edges <= 1`` or the edges do not tile the clients."""
    weights = torch.as_tensor(weights, dtype=torch.float32)
    C = weights.shape[0]
    if n_edges <= 1 or C % n_edges:
        return weighted_client_mean(stacked_tree, weights)

    def mean(x):
        dt = compute_dtype(x.dtype)
        we = _normalized(weights).to(x.device, dt).reshape(n_edges,
                                                           C // n_edges)
        xe = x.to(dt).reshape((n_edges, C // n_edges) + tuple(x.shape[1:]))
        part = (we.reshape(we.shape + (1,) * (x.dim() - 1)) * xe).sum(dim=1)
        while part.shape[0] > 1:                           # cross-edge tree
            m = part.shape[0] // 2
            part = torch.cat([part[:m] + part[m:2 * m], part[2 * m:]], dim=0)
        return part[0].to(x.dtype)

    return tree_lib.map_(mean, stacked_tree)


def client_combine(stacked_tree, weights, fed: FedConfig):
    """The round's configured client-axis reduction: the weighted mean,
    or the robust combine when ``fed.robust_agg`` says so (always flat:
    order statistics do not decompose over edges)."""
    if fed.robust_agg != "mean":
        return robust_client_combine(stacked_tree, weights, fed.robust_agg,
                                     fed.trim_frac, fed.clip_norm)
    return weighted_client_mean(stacked_tree, weights)


# --------------------------------------------------------------------------- #
# Shared local-update machinery (FedLLM a2 / KD b1)
# --------------------------------------------------------------------------- #
def batches_on(batches, device):
    """Stacked batches on ``device``: numpy arrays as core/fedavg.to_device
    makes them, tensors as they are."""
    host = {k: v for k, v in batches.items() if not torch.is_tensor(v)}
    out = to_device(host, device) if host else {}
    out.update({k: v.to(device) for k, v in batches.items()
                if torch.is_tensor(v)})
    return {k: out[k] for k in batches}


def _host_mask(valid):
    """A (C, S) validity mask as a numpy bool array."""
    if torch.is_tensor(valid):
        valid = valid.cpu().numpy()
    return np.asarray(valid, dtype=bool)


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
        batches = batches_on(batches, device)
        valid = _host_mask(valid)
        ok = torch.as_tensor(valid, device=device)
        totals = 0.0
        for s in range(valid.shape[1]):
            slt, sopt, loss = step(base, slt, sopt, step_batch(batches, s),
                                   gens, valid[:, s])
            totals = totals + torch.where(ok[:, s], loss, 0.0)
        return slt, sopt, totals / ok.sum(dim=1).clamp_min(1).float()

    return local_update


# --------------------------------------------------------------------------- #
# The launch layer's whole-round programs
# --------------------------------------------------------------------------- #
def _device_of(tree):
    return tree_lib.leaves(tree)[0].device


def make_spmd_round(model: Model, fed: FedConfig,
                    task: str = "classification", n_edges: int = 1,
                    fns=None):
    """Returns round_step(base, stacked_lt, stacked_opt, batches, gens,
    valid, weights[, noise_gens]): FedLLM's a1-a4 in one program.
    ``stacked_*`` lead with the client axis C; ``batches`` leaves are (C,
    n_steps, B, ...) (numpy arrays or tensors), ``valid`` (C, n_steps),
    ``gens`` one dropout generator a client, ``weights`` (C,).  Returns
    (the aggregate repeated on every client slot, the stacked optimizer
    state, each client's mean loss (C,), the uploaded stacked trees).

    With DP noise (``fed.privacy.noise_std > 0``) ``noise_gens`` holds
    one generator a client and each uploaded tree is noised before the
    aggregate (the a3 upload boundary).  The aggregate is
    ``client_combine``'s robust combine under ``fed.robust_agg``, else
    ``hierarchical_client_mean`` over ``n_edges`` edges (> 1), else the
    flat weighted mean."""
    local_update = make_local_update(model, fed, task, fns)
    noise_std = fed.privacy.noise_std

    def round_step(base, stacked_lt, stacked_opt, batches, gens, valid,
                   weights, noise_gens=None):
        C = tree_lib.leaves(stacked_lt)[0].shape[0]
        new_lt, new_opt, losses = local_update(
            base, stacked_lt, stacked_opt, batches, valid, gens,
            _device_of(stacked_lt))
        if noise_std > 0.0:
            from repro_torch.privacy import dp as dp_mod
            new_lt = stack_trees([
                dp_mod.privatize_tree(t, g, noise_std)
                for t, g in zip(unstack_tree(new_lt, C), noise_gens)])
        weights = torch.as_tensor(weights, dtype=torch.float32)
        if fed.robust_agg != "mean":
            avg = client_combine(new_lt, weights, fed)
        elif n_edges > 1:
            avg = hierarchical_client_mean(new_lt, weights, n_edges)
        else:
            avg = weighted_client_mean(new_lt, weights)
        return stack_for_clients(avg, C), new_opt, losses, new_lt

    return round_step


def make_split_spmd_round(model: Model, fed: FedConfig,
                          task: str = "classification", sfns=None):
    """One program for the whole Split-FedLLM round: returns
    round_step(base_c, base_s, c_global, s_lt, s_opt, batches, gens,
    valid, weights[, noise_gens]) -> (new_c_global, s_lt, s_opt, losses
    (C, n_steps), the stacked client halves).

    Each client starts from ``c_global`` with a fresh optimizer state
    (cc3) and steps over its batches; the shared server half and its
    optimizer state are carried from client to client in order (the
    reference's scan over the client axis: the paper trains the server
    layers client after client); a step whose ``valid`` entry is false
    changes nothing.  The closing cc2 is ``client_combine`` over the
    client halves.  ``gens`` holds one dropout generator a client;
    under DP noise ``noise_gens[c][s]`` is step s of client c's c2
    noise generator.  The reference's ``client_sharding`` (a mesh
    constraint on the stacked halves) is not taken: the port has no
    mesh."""
    from repro_torch.core import split as split_mod

    if sfns is None:
        sfns = split_mod.make_split_fns(model, fed, task)
    step = sfns["split_step"]
    opt_init = sfns["opt_init"]
    noised = fed.privacy.noise_std > 0.0

    def round_step(base_c, base_s, c_global, s_lt, s_opt, batches, gens,
                   valid, weights, noise_gens=None):
        device = _device_of(c_global)
        batches = batches_on(batches, device)
        valid = _host_mask(valid)
        C, S = valid.shape
        dt = compute_dtype(tree_lib.leaves(c_global)[0].dtype)
        halves, losses = [], []
        for c in range(C):
            c_lt, c_opt = c_global, opt_init(c_global)
            row = [None] * S
            for s in range(S):
                if not valid[c, s]:
                    continue
                batch = {k: v[c, s] for k, v in batches.items()}
                nk = noise_gens[c][s] if noised else None
                c_lt, s_lt, c_opt, s_opt, loss = step(
                    base_c, base_s, c_lt, s_lt, c_opt, s_opt, batch,
                    gens[c], nk)
                row[s] = loss.detach().reshape(())
            halves.append(c_lt)
            losses.append(torch.stack([
                torch.zeros((), dtype=dt, device=device) if x is None
                else x for x in row]))
        stacked_c = stack_trees(halves)
        weights = torch.as_tensor(weights, dtype=torch.float32)
        return (client_combine(stacked_c, weights, fed), s_lt, s_opt,
                torch.stack(losses), stacked_c)

    return round_step

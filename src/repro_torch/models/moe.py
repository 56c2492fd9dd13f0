"""Mixture-of-Experts MLP with sort-based capacity dispatch (Mixtral,
Qwen3-MoE).

Counterpart of ``init_moe``, ``expert_capacity``, ``moe_fwd``,
``_moe_fwd_global`` and ``_moe_fwd_batched`` in
``src/repro/models/moe.py``.  Each token is routed to its top-k experts
by an fp32 softmax over the router logits (fp64 for fp64 weights), the
k weights renormalized to sum to 1; the assignments are sorted by expert
id (a stable sort, so an expert's tokens keep their order), packed into a
static (E, C, d) buffer per routing row, where an expert's assignments
beyond its capacity C are dropped (weight 0), run through each expert's
MLP as one batched product a weight (``torch.bmm``; the reference's
``ecd,edf->ecf`` einsums, outside any Pallas kernel) and unpacked,
weighted by their routing weights.  The Switch load-balance term,
E · Σ_e (mean router probability of e) · (share of assignments to e) ·
``router_aux_coef``, is the block's ``aux``.

Dispatch (``cfg.moe_dispatch``): ``global`` (and any name but the two
below, as in the reference) packs all B·S tokens of the batch as one row
(capacity ``expert_capacity(B·S)``); ``batched`` packs each batch row on
its own (capacity ``expert_capacity(S)``).
``shard_map`` is ``batched`` here, as in the reference when no mesh is
ambient: the port has no mesh, and the reference's expert-parallel
schedule is not ported.

Routing groups.  The reference ``vmap``s the model over the stacked
clients of the ``spmd`` backend and over the examples of a DP-SGD step,
so each client (each example) routes, packs and takes its aux term on
its own.  Here those batches run as one forward, and the groups come
from the open scopes of kernels/ops: under ``per_example_scope`` every
batch row is its own group (a batch-1 ``global`` dispatch is a row
dispatch), under ``clients_scope(C)`` the batch splits into C groups of
consecutive rows.  Under either scope ``aux`` is a vector, one entry a
group; outside them a scalar.

``jax.lax.top_k`` breaks ties toward the lower expert index and
``jnp.argsort`` is stable: here both are stable sorts, so tied router
probabilities pick the reference's experts, and a full expert keeps the
reference's tokens."""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch import dtensor
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import common
from repro_torch.runtime import compute_dtype

_ROUTES = None          # list collecting each call's top-k expert ids


def init_moe(gen: torch.Generator, cfg: ModelConfig, device):
    """The reference's shapes and scales: the router (d, E) at d^-0.5,
    the expert weights (E, d, ff) at the default fan-in of their leading
    dim (E^-0.5, as ``common.dense_init`` reads it there), w_out (E, ff,
    d) at ff^-0.5."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": common.dense_init(gen, (d, E), device, scale=d ** -0.5)}
    if cfg.activation == "swiglu":
        p["w_gate"] = common.dense_init(gen, (E, d, ff), device)
    p["w_in"] = common.dense_init(gen, (E, d, ff), device)
    p["w_out"] = common.dense_init(gen, (E, ff, d), device, scale=ff ** -0.5)
    return p


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Static per-expert buffer size of a routing row of ``n_tokens``
    tokens: ceil(n_tokens · k / E · capacity factor), at least 1, rounded
    up to a multiple of 8 above 8."""
    cap = math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                    * cfg.moe_capacity_factor)
    return max(1, cap) if cap <= 8 else -(-cap // 8) * 8


@contextlib.contextmanager
def trace_routes():
    """Collects every moe_fwd call's top-k expert ids (B, S, k), in call
    order (one entry a MoE layer and forward), into the yielded list."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def routing_groups(batch: int):
    """How many independent routing groups a batch of ``batch`` rows
    holds under the open kernels/ops scopes (module docstring), or None
    outside them (one group, a scalar aux)."""
    if kernel_ops.example_batch() is not None:
        return batch
    clients = kernel_ops.stacked_clients()
    if clients is None:
        return None
    if batch % clients:
        raise ValueError(f"moe_fwd: {clients} stacked clients need a batch "
                         f"that is a multiple of {clients}, got {batch}")
    return clients


def moe_fwd(params, cfg: ModelConfig, x, first=None):
    """x: (B, S, d) -> (out (B, S, d), aux: a scalar, or (G,) for the G
    routing groups of an open scope).  DTensors go through
    _distributed_moe; ``first`` (its use) marks params holding the
    experts from ``first`` on, the others' assignments left out."""
    if dtensor.is_distributed(x):
        return _distributed_moe(params, cfg, x)
    B, S, d = x.shape
    k, E = cfg.top_k, cfg.n_experts
    groups = routing_groups(B)
    G = groups or 1
    Bg = B // G
    dt = compute_dtype(x.dtype)
    logits = common.mm(x, params["router"]).to(dt)           # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower index: a stable descending sort
    topk_p, topk_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_e = topk_p[..., :k], topk_e[..., :k]
    topk_p = topk_p / topk_p.sum(dim=-1, keepdim=True)
    if _ROUTES is not None:
        _ROUTES.append(topk_e.detach())

    # the load-balance term of each group: its mean router probabilities
    # against its share of assignments, each expert's (the reference's
    # two formulas for that share, which round differently)
    me = probs.reshape(G, Bg * S, E).mean(dim=1)
    one_hot = torch.zeros(B, S * k, E, dtype=dt, device=x.device).scatter_(
        2, topk_e.reshape(B, S * k, 1), 1.0)
    if cfg.moe_dispatch not in ("batched", "shard_map") and G < B:
        # one routing row a group: its Bg·S tokens packed together
        frac = one_hot.reshape(G, Bg * S * k, E).sum(dim=1) / (Bg * S * k)
        rows, tokens = G, Bg * S
    else:
        # batched (or one example a group): every batch row packed alone
        frac = one_hot.sum(dim=1).reshape(G, Bg, E).mean(dim=1) / (S * k)
        rows, tokens = B, S
    aux = E * (me * frac).sum(dim=-1) * cfg.router_aux_coef    # (G,)
    out = _dispatch(params, cfg, x.reshape(rows, tokens, d),
                    topk_e.reshape(rows, tokens * k),
                    topk_p.reshape(rows, tokens * k).to(x.dtype),
                    expert_capacity(tokens, cfg), first)
    return out.reshape(B, S, d), (aux[0] if groups is None else aux)


def _distributed_moe(params, cfg: ModelConfig, x):
    """moe_fwd on DTensors, each rank on its local rows (routing is by
    batch row under every registry MoE's dispatch) against its local
    expert weights: the experts' dim sharded (expert parallel), each rank
    adds its experts' share of every token, the other assignments left
    out; the ffn dim sharded (tensor parallel), its columns' share.  The
    output is the ranks' partial sums over those axes; aux, from the
    local rows' routing, their mean over the row axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = x.device_mesh
    x = dtensor.hint(x, ("pod", "data"), None, None)
    w_in = params["w_in"]
    expert_dim = w_in.dim() - 3
    local = {name: (dtensor.replicated(t, range(t.dim()),
                                      "models/moe: the router")
                    if name == "router" else t).to_local()
             for name, t in params.items()}
    ep = [i for i, p in enumerate(w_in.placements) if p.is_shard(expert_dim)]
    first = None
    if ep:
        first = 0
        for i in ep:
            first = first * mesh.size(i) + mesh.get_local_rank(i)
        first *= local["w_in"].shape[expert_dim]
    split = [p.is_shard() for p in w_in.placements]
    # x's gradient: each rank's experts' (or columns') share, a partial
    # sum over the axes sharding them
    out, aux = moe_fwd(local, cfg, x.to_local(grad_placements=[
        Partial() if sp else p for p, sp in zip(x.placements, split)]),
        first)
    rows = [dtensor.shard_dim(p) == 0 for p in x.placements]
    out = DTensor.from_local(
        out, mesh, [Partial() if sp else x.placements[i]
                    for i, sp in enumerate(split)],
        run_check=False, shape=x.shape, stride=x.stride())
    aux = DTensor.from_local(
        aux, mesh, [Partial("avg") if r else Replicate() for r in rows],
        run_check=False)
    return out, aux


def _dispatch(params, cfg: ModelConfig, x, flat_e, flat_w, cap: int,
              first=None):
    """Sort-by-expert pack, expert MLPs, weighted unpack of R routing rows:
    x (R, T, d), flat_e and flat_w (R, T·k) in token-major order -> (R, T,
    d).  ``first`` not None: params hold the experts from ``first`` on,
    and assignments to the others are dropped."""
    R, T, d = x.shape
    k, E = cfg.top_k, cfg.n_experts
    A = T * k
    dev = x.device
    if first is not None:
        # the held experts, the others into one more bucket, dropped
        E = params["w_in"].shape[0]
        inside = (flat_e >= first) & (flat_e < first + E)
        flat_e = torch.where(inside, flat_e - first, E)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)                             # sorted experts
    stok = order // k                                        # their tokens
    counts = torch.zeros(R, E + (first is not None), dtype=torch.long,
                         device=dev).scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(A, device=dev)[None] - starts.gather(1, se)
    keep = pos < cap
    if first is not None:
        keep = keep & (se < E)
    slot = torch.where(keep, se * cap + pos, E * cap)        # E·cap: dropped
    # pack: the token of each kept slot, T (a zero row) for an empty one
    src = torch.full((R, E * cap + 1), T, dtype=torch.long, device=dev)
    src.scatter_(1, slot, stok)
    xz = torch.cat([x, x.new_zeros(R, 1, d)], dim=1)
    buf = xz.gather(1, src[:, :-1, None].expand(R, E * cap, d))
    xe = buf.view(R, E, cap, d).transpose(0, 1).reshape(E, R * cap, d)
    if cfg.activation == "swiglu":
        h = torch.bmm(xe, params["w_in"]) * common.silu(
            torch.bmm(xe, params["w_gate"]))
    else:
        h = common.gelu(torch.bmm(xe, params["w_in"]))
    ye = torch.bmm(h, params["w_out"])                       # (E, R·cap, d)
    yf = ye.view(E, R, cap, d).transpose(0, 1).reshape(R, E * cap, d)
    # unpack in token-major order: assignment j of token t is order's
    # inverse at t·k + j; each token sums its k weighted expert outputs
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(A, device=dev).expand(R, A))
    a_slot, a_keep = slot.gather(1, inv), keep.gather(1, inv)
    got = yf.gather(1, a_slot.clamp(max=E * cap - 1)[..., None]
                    .expand(R, A, d))
    got = torch.where(a_keep[..., None], got, 0.0) * flat_w[..., None]
    return got.view(R, T, k, d).sum(dim=2)

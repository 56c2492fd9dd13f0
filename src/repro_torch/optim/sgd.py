"""SGD with optional momentum.  Counterpart of ``src/repro/optim/sgd.py``
with the same formulas in fp32 (fp64 for fp64 parameters:
``runtime.compute_dtype``).  The state is ``{"mu": None}`` without
momentum, which the stacked clients' state, checkpoints and the bridge
carry as it is.  The update is functional: it returns new tensors and
leaves its inputs untouched."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import tree as tree_lib
from repro_torch.runtime import compute_dtype, upload


def init(params, momentum: float = 0.0):
    if momentum:
        return {"mu": tree_lib.map_(
            lambda p: torch.zeros(p.shape, dtype=compute_dtype(p.dtype),
                                  device=p.device), params)}
    return {"mu": None}


def _step(g, m, p, lr, momentum):
    """One leaf's (new mu or None, new p) after gradient ``g``."""
    dt = compute_dtype(p.dtype)
    if m is not None:
        m = momentum * m + g.to(dt)
        return m, (p.to(dt) - lr * m).to(p.dtype)
    return None, (p.to(dt) - lr * g.to(dt)).to(p.dtype)


@torch.no_grad()
def update(grads, state, params, lr, momentum: float = 0.0):
    """Returns (new_params, new_state)."""
    moving = bool(momentum) and state["mu"] is not None
    mus = tree_lib.leaves(state["mu"]) if moving \
        else [None] * len(tree_lib.leaves(params))
    flat = [_step(g, m, p, lr, momentum) for g, m, p in zip(
        tree_lib.leaves(grads), mus, tree_lib.leaves(params))]
    new_p = tree_lib.unflatten(params, [f[1] for f in flat])
    if not moving:
        return new_p, state
    return new_p, {"mu": tree_lib.unflatten(params, [f[0] for f in flat])}


@torch.no_grad()
def update_clients(grads, state, params, lr, valid: Sequence[bool] = None,
                   momentum: float = 0.0):
    """``update`` for stacked clients: every leaf leads with the client
    axis C, and client c steps only where ``valid[c]`` (every client when
    ``valid`` is None); elsewhere its parameters and momentum stay as they
    were (the reference's ``_select`` in core/fed_spmd.py over its
    ``vmap`` of ``update``).  Returns (new_params, new_state)."""
    new_p, new_state = update(grads, state, params, lr, momentum)
    if valid is None or all(valid):
        return new_p, new_state
    leaves = tree_lib.leaves(params)
    if not leaves:
        return params, state
    ok = upload(torch.as_tensor(list(valid), dtype=torch.bool),
                leaves[0].device)

    def keep(n, o):
        return torch.where(ok.view((-1,) + (1,) * (o.dim() - 1)), n, o)

    new_p = tree_lib.map_(keep, new_p, params)
    if new_state["mu"] is not None:
        new_state = {"mu": tree_lib.map_(keep, new_state["mu"],
                                         state["mu"])}
    return new_p, new_state

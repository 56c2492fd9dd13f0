"""Adam / AdamW over parameter trees.

Counterpart of ``src/repro/optim/adam.py`` with the same formulas: fp32
moments whatever the parameter dtype (fp64 for fp64 parameters:
``runtime.compute_dtype``), and the bias corrections ``1 - b**t``
computed in fp32.  The update is functional: it returns new
tensors and leaves its inputs untouched.  (``torch.optim.Adam`` folds the
corrections differently, so it is not used.)
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import dtensor
from repro_torch import tree as tree_lib
from repro_torch.runtime import compute_dtype, upload


def init(params):
    zeros = tree_lib.map_(
        lambda p: torch.zeros(p.shape, dtype=compute_dtype(p.dtype),
                              device=p.device),
        params)
    return {"m": zeros, "v": tree_lib.map_(torch.zeros_like, zeros),
            "step": 0}


def _bias_correction(b: float, t: torch.Tensor) -> float:
    """1 - b**t in fp32 (exactly representable as a Python float)."""
    return float(1.0 - torch.tensor(b, dtype=torch.float32) ** t)


def _gradient_layout(g, *ts):
    """(g, *ts); DTensors all in the gradient's layout, as GSPMD lays
    out a step's update from its gradient (DTensor would bring the
    gradient to the state's): a partial sum over the ``model`` axis
    reduce-scattered over its last dim where the extent divides it, the
    other partial sums all-reduced."""
    if not dtensor.is_distributed(g):
        return (g, *ts)
    from torch.distributed.tensor import Replicate, Shard

    mesh = g.device_mesh
    pl = [(Shard(g.dim() - 1) if name == "model" and g.dim() and
           g.shape[-1] % mesh.size(i) == 0 and not any(
               q.is_shard(g.dim() - 1) for q in g.placements)
           else Replicate()) if p.is_partial() else p
          for i, (name, p) in enumerate(zip(mesh.mesh_dim_names,
                                            g.placements))]
    g = g.redistribute(mesh, pl)
    return (g, *(t.redistribute(mesh, pl) if dtensor.is_distributed(t)
                 else t for t in ts))


def _moments(g, m, v, p, lr, bc1, bc2, b1, b2, eps, weight_decay):
    """One leaf's step: its (m, v, p) after gradient ``g``; ``bc1`` and
    ``bc2`` are the bias corrections, Python floats or tensors that
    broadcast over ``p``."""
    dt = compute_dtype(p.dtype)
    g, m, v, p = _gradient_layout(g.to(dt), m, v, p)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if weight_decay:
        u = u + weight_decay * p.to(dt)
    return m, v, (p.to(dt) - lr * u).to(p.dtype)


def _tree_step(grads, state, params, step, leaf):
    """(new_params, new_state) from ``leaf(g, m, v, p) -> (m, v, p)``
    over the trees' leaves."""
    flat = [leaf(g, m, v, p) for g, m, v, p in zip(
        tree_lib.leaves(grads), tree_lib.leaves(state["m"]),
        tree_lib.leaves(state["v"]), tree_lib.leaves(params))]
    return (tree_lib.unflatten(params, [f[2] for f in flat]),
            {"m": tree_lib.unflatten(params, [f[0] for f in flat]),
             "v": tree_lib.unflatten(params, [f[1] for f in flat]),
             "step": step})


@torch.no_grad()
def update(grads, state, params, lr, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8, weight_decay: float = 0.0):
    """Returns (new_params, new_state)."""
    step = state["step"] + 1
    t = torch.tensor(step, dtype=torch.float32)
    bc1 = _bias_correction(b1, t)
    bc2 = _bias_correction(b2, t)
    return _tree_step(grads, state, params, step, lambda g, m, v, p: _moments(
        g, m, v, p, lr, bc1, bc2, b1, b2, eps, weight_decay))


@torch.no_grad()
def update_clients(grads, state, params, lr, valid: Sequence[bool] = None,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   weight_decay: float = 0.0):
    """``update`` for stacked clients: every leaf leads with the client
    axis C, ``state["step"]`` is an int64 (C,) host tensor of each
    client's step count, and client c steps only where ``valid[c]`` (every
    client when ``valid`` is None): a padded step keeps its parameters,
    moments and count (the reference's ``_select`` in
    core/fed_spmd.py).  Each client's bias corrections are ``update``'s
    fp32 values at its own count, formed on the host with the mask and
    sent to the card in one copy that does not wait for the stream.
    Returns (new_params, new_state)."""
    keep = torch.ones(state["step"].shape[0], dtype=torch.bool) \
        if valid is None else torch.as_tensor(list(valid), dtype=torch.bool)
    step = state["step"] + keep.long()
    leaves = tree_lib.leaves(params)
    if not leaves:
        return params, dict(state, step=step)
    ctl = upload(torch.tensor(
        [keep.float().tolist()] + [[_bias_correction(b, t) for t in
                                    step.float()] for b in (b1, b2)]),
        leaves[0].device)
    ok = ctl[0] > 0

    def leaf(g, m, v, p):
        g, m, v, p = _gradient_layout(g, m, v, p)
        shape = (-1,) + (1,) * (p.dim() - 1)
        bc1, bc2 = (c.to(compute_dtype(p.dtype)).view(shape)
                    for c in ctl[1:])
        new = _moments(g, m, v, p, lr, bc1, bc2, b1, b2, eps, weight_decay)
        return tuple(torch.where(ok.view(shape), n, o)
                     for n, o in zip(new, (m, v, p)))

    return _tree_step(grads, state, params, step, leaf)

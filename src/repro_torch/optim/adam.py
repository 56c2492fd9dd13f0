"""Adam / AdamW over parameter trees.

Counterpart of ``src/repro/optim/adam.py`` with the same formulas: fp32
moments whatever the parameter dtype (fp64 for fp64 parameters:
``runtime.compute_dtype``), and the bias corrections ``1 - b**t``
computed in fp32.  The update is functional: it returns new
tensors and leaves its inputs untouched.  (``torch.optim.Adam`` folds the
corrections differently, so it is not used.)
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.runtime import compute_dtype


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


@torch.no_grad()
def update(grads, state, params, lr, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8, weight_decay: float = 0.0):
    """Returns (new_params, new_state)."""
    step = state["step"] + 1
    t = torch.tensor(step, dtype=torch.float32)
    bc1 = _bias_correction(b1, t)
    bc2 = _bias_correction(b2, t)

    def upd(g, m, v, p):
        dt = compute_dtype(p.dtype)
        g = g.to(dt)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.to(dt)
        return m, v, (p.to(dt) - lr * u).to(p.dtype)

    flat = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_lib.leaves(grads), tree_lib.leaves(state["m"]),
        tree_lib.leaves(state["v"]), tree_lib.leaves(params))]
    return (tree_lib.unflatten(params, [f[2] for f in flat]),
            {"m": tree_lib.unflatten(params, [f[0] for f in flat]),
             "v": tree_lib.unflatten(params, [f[1] for f in flat]),
             "step": step})

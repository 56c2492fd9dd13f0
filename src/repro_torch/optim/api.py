"""Optimizer facade used by the round engine and launch/train.py.
Counterpart of ``src/repro/optim/api.py``: Adam (AdamW with
``weight_decay``) and SGD (with ``momentum``)."""
from __future__ import annotations

from repro_torch.optim import adam, sgd


def make_client_update(name: str, **kw):
    """The stacked clients' update_fn(grads, state, params, lr,
    valid=None) -> (params, state): leaves with a leading client axis, a
    client steps where ``valid`` (every client when it is None) and keeps
    its parameters and state elsewhere (adam.update_clients, each client's
    step count its own; sgd.update_clients)."""
    make_optimizer(name, **kw)          # raises for an unknown optimizer
    if name == "sgd":
        mom = kw.get("momentum", 0.0)

        def upd(g, s, p, lr, valid=None):
            return sgd.update_clients(g, s, p, lr, valid, momentum=mom)
        return upd

    def upd(g, s, p, lr, valid=None):
        return adam.update_clients(g, s, p, lr, valid,
                                   weight_decay=kw.get("weight_decay", 0.0))
    return upd


def make_optimizer(name: str, **kw):
    """Returns (init_fn(params) -> state,
                update_fn(grads, state, params, lr) -> (params, state))."""
    if name == "adam":
        def upd(g, s, p, lr):
            return adam.update(g, s, p, lr,
                               weight_decay=kw.get("weight_decay", 0.0))
        return adam.init, upd
    if name == "sgd":
        mom = kw.get("momentum", 0.0)
        return (lambda p: sgd.init(p, mom),
                lambda g, s, p, lr: sgd.update(g, s, p, lr, mom))
    raise ValueError(name)

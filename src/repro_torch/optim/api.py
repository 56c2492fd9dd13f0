"""Optimizer facade used by the round engine.  Counterpart of
``src/repro/optim/api.py``; only Adam is ported so far."""
from __future__ import annotations

from repro_torch.optim import adam


def make_client_update(name: str, **kw):
    """The stacked clients' update_fn(grads, state, params, lr,
    valid=None) -> (params, state) (adam.update_clients): leaves with a
    leading client axis, each client's step count its own, a client steps
    where ``valid`` (every client when it is None)."""
    make_optimizer(name, **kw)          # raises for an optimizer not ported

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
        raise NotImplementedError("optimizer 'sgd' is not ported yet")
    raise ValueError(name)

"""Conversion between the reference's parameter trees and the port's.

The reference (``src/repro``) stacks its trunk for ``lax.scan``:
``params["blocks"]`` is a tuple with one tree per position of the layer
pattern, each leaf with a leading (G,) axis over the G full pattern
groups, and ``params["tail"]`` a tuple of the per-layer trees that follow
the last full group.  The port keeps ``params["layers"]``, a list of
per-layer dicts in forward order: layer g·P + pi is group g's pattern
position pi, and the tail comes last.  In a reference LoRA tree a pattern
position (or tail layer) without a targeted weight is ``None`` and a
``tail`` without any is left out; the port's LoRA list holds ``None`` at
those layers.  Both store weights as (d_in, d_out) with ``y = x @ W``, so
nothing is transposed.  A MoE layer's router (d, E) and experts (E, d,
ff) and a qk-norm layer's (D,) ``q_norm``/``k_norm`` scales are leaves
like any other, stacked over the groups in the reference.  Inputs are
numpy arrays, or anything ``np.asarray`` accepts; this module imports no
JAX.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _np_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _np_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_map(fn, v) for v in tree]
    return fn(tree)


def _tensor(x, device):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def _layers(ref_tree, device, n_tail: int = None) -> List:
    """The reference's blocks (and tail) as the port's per-layer list in
    forward order.  ``n_tail`` counts the tail layers where ``tail`` may
    be left out (a LoRA tree); by default it is ``len(tail)``."""
    blocks = ref_tree["blocks"]
    tail = list(ref_tree.get("tail") or ())
    if n_tail is not None:
        tail += [None] * (n_tail - len(tail))
    stacked = [b for b in blocks if b is not None]
    G = np.shape(_first_leaf(stacked[0]))[0] if stacked else 0
    out = []
    for g in range(G):
        for pos in blocks:
            out.append(_np_map(
                lambda x, g=g: _tensor(np.asarray(x)[g], device), pos))
    return out + [_np_map(lambda x: _tensor(x, device), t) for t in tail]


def _n_tail(cfg) -> int:
    if cfg is None:
        return 0
    P = len(cfg.layer_pattern or (None,))
    return cfg.n_layers - cfg.n_layers // P * P


def params_from_reference(ref_params: Dict, device) -> Dict:
    """The reference's ``model.init`` tree -> port parameters."""
    out = {k: _np_map(lambda x: _tensor(x, device), v)
           for k, v in ref_params.items() if k not in ("blocks", "tail")}
    out["layers"] = _layers(ref_params, device)
    return out


def lora_from_reference(ref_lora: Dict, device, cfg=None) -> Dict:
    """A reference LoRA tree ({"blocks": (..., {"attn": {...}}, ...)[,
    "tail": (...)]}) -> port.  ``cfg`` (the model's config) gives the
    number of tail layers, which a reference LoRA tree without targets
    there does not record; without it the model has no tail."""
    return {"layers": _layers(ref_lora, device, _n_tail(cfg))}


def _blocks(layers: List, cfg) -> Dict:
    """The port's per-layer list as the reference's {"blocks": (...),
    "tail": (...)} of numpy arrays, each pattern position's layers
    stacked over the full groups; ``None`` stays where a layer has no
    entry.  ``cfg`` gives the layer pattern; without it each layer is its
    own group (the dense family)."""
    P = len(cfg.layer_pattern or (None,)) if cfg is not None else 1
    n_tail = _n_tail(cfg)
    G = (len(layers) - n_tail) // P

    def stack(*leaves):
        return np.stack([t.detach().cpu().numpy() for t in leaves])

    def rec(first, rest):
        if isinstance(first, dict):
            return {k: rec(v, [r[k] for r in rest]) for k, v in first.items()}
        return stack(first, *rest)

    blocks = []
    for pos in range(P):
        group = [layers[g * P + pos] for g in range(G)]
        blocks.append(None if group[0] is None else rec(group[0], group[1:]))
    tail = [_np_map(lambda t: t.detach().cpu().numpy(), t)
            for t in layers[G * P:]]
    return {"blocks": tuple(blocks), "tail": tuple(tail)}


def params_to_reference(params: Dict, cfg=None) -> Dict:
    """Port parameters -> the reference's ``model.init`` layout (numpy),
    the inverse of ``params_from_reference``: a round trip through both
    gives every leaf back bit for bit."""
    out = {k: _np_map(lambda t: t.detach().cpu().numpy(), v)
           for k, v in params.items() if k != "layers"}
    out.update(_blocks(params["layers"], cfg))
    return out


def lora_to_reference(lora: Dict, cfg=None) -> Dict:
    """A port LoRA tree -> the reference's nested numpy layout, with
    ``None`` where the reference's has no target.  ``cfg`` gives the
    layer pattern; without it each layer is its own group (the dense
    family)."""
    out = _blocks(lora["layers"], cfg)
    if not any(t is not None for t in out["tail"]):
        del out["tail"]
    return out

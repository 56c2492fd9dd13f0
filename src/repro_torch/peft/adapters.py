"""Bottleneck adapters (Houlsby style), the paper's second PEFT option.

Counterpart of ``src/repro/peft/adapters.py``.  An adapter tree holds one
adapter a decoder layer, ``{"layers": [{"w_down": (d, b), "w_up": (b,
d)}, ...]}`` in the order of the model's ``params["layers"]`` (the
reference stacks them over the pattern groups as its blocks are;
repro_torch/bridge.py converts).  ``bind`` puts each under its layer's
"adapter" key, and models/transformer.block_fwd then applies ``x +
gelu(x @ w_down) @ w_up`` after the MLP residual.  ``w_up`` starts at
zero, so a freshly bound adapter is the identity.  The encoder of an
encoder-decoder model carries none, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.runtime import resolve_device


def init_adapters(gen: torch.Generator, base_params, d_model: int,
                  bottleneck: int = 64, device=None):
    """One adapter a layer of ``base_params["layers"]``, ``w_down`` drawn
    from ``gen`` layer by layer (common.dense_init), ``w_up`` zero, on
    ``device`` (None: CUDA, or raise)."""
    device = resolve_device(device)
    return {"layers": [
        {"w_down": common.dense_init(gen, (d_model, bottleneck), device),
         "w_up": torch.zeros((bottleneck, d_model), device=device)}
        for _ in base_params["layers"]]}


def bind(base_params, adapter_tree):
    """``base_params`` with each layer's adapter under its "adapter"
    key; the other entries are the base's own tensors."""
    out = dict(base_params)
    out["layers"] = [dict(blk, adapter=ad) for blk, ad in
                     zip(base_params["layers"], adapter_tree["layers"])]
    return out


def adapter_fwd(p, x):
    """x + gelu(x @ w_down) @ w_up."""
    h = common.gelu(common.mm(x, p["w_down"]))
    return x + common.mm(h, p["w_up"])

"""Conversion between the reference's parameter trees and the port's.

The reference (``src/repro``) keeps its GPT-2 trunk stacked over layers
for ``lax.scan``: ``params["blocks"][0]`` holds every per-layer leaf with a
leading (G,) axis.  The port keeps ``params["layers"]``, a list of
per-layer dicts.  Both store weights as (d_in, d_out) with ``y = x @ W``,
so nothing is transposed.  Inputs are numpy arrays, or anything
``np.asarray`` accepts; this module imports no JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _np_map(fn, tree):
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


def _unstack(stacked, device):
    """A tree stacked over layers -> a list of per-layer trees."""
    n = np.shape(_first_leaf(stacked))[0]
    return [_np_map(lambda x, i=i: _tensor(np.asarray(x)[i], device),
                    stacked) for i in range(n)]


def _trunk(ref_tree):
    blocks, tail = ref_tree["blocks"], ref_tree.get("tail", ())
    if len(blocks) != 1 or tail:
        raise NotImplementedError(
            "only homogeneous attention stacks (one pattern position, no "
            "tail) are ported")
    return blocks[0]


def params_from_reference(ref_params: Dict, device) -> Dict:
    """The reference's ``model.init`` tree -> port parameters."""
    out = {k: _np_map(lambda x: _tensor(x, device), v)
           for k, v in ref_params.items() if k not in ("blocks", "tail")}
    out["layers"] = _unstack(_trunk(ref_params), device)
    return out


def lora_from_reference(ref_lora: Dict, device) -> Dict:
    """A reference LoRA tree ({"blocks": ({"attn": {...}},)}) -> port."""
    return {"layers": _unstack(_trunk(ref_lora), device)}


def lora_to_reference(lora: Dict) -> Dict:
    """A port LoRA tree -> the reference's nested numpy layout."""
    layers = lora["layers"]

    def stack(*leaves):
        return np.stack([t.detach().cpu().numpy() for t in leaves])

    def rec(first, rest):
        if isinstance(first, dict):
            return {k: rec(v, [r[k] for r in rest]) for k, v in first.items()}
        return stack(first, *rest)

    return {"blocks": (rec(layers[0], layers[1:]),)}

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
like any other, stacked over the groups in the reference; so are a
decoder layer's ``xnorm``/``xattn`` (the encoder-decoder's
cross-attention).  Top-level leaves (``img_proj`` of a VLM) keep their
place.  An encoder-decoder's ``encoder`` holds ``{"blocks": one tree
stacked over its layers, "norm"}`` in the reference and ``{"layers":
[...], "norm"}`` here; in a LoRA tree it holds the encoder's targets
alone.  Adapter trees ({"blocks", "tail"} like the model's, one adapter
a layer) become ``{"layers": [...]}``; a prompt tree ({"prompt"}) is
copied.  A LoRA factor of a stacked expert weight keeps its expert dim
after the layer's: (G, E, d, r) in the reference, (E, d, r) a layer
here.  An optimizer state over a LoRA tree (Adam's {"m", "v", "step"},
SGD's {"mu"}) converts entry by entry: a LoRA-shaped entry as a LoRA
tree, ``None`` (SGD without momentum) as ``None``, the step count as a
Python int here and an int32 array there.  A decode cache ({"blocks",
"tail"} like the model's, and an
encoder-decoder's cross-attention K/V, ``xkv`` stacked over the groups
and ``xkv_tail``) becomes ``{"layers": [...], ["xkv": [(k, v), ...]]}``
(models/transformer.init_cache) with each leaf's dtype kept, bf16
included; back in the reference's layout a bf16 leaf comes as fp32
numpy (numpy has no bf16), the same values.  Inputs are numpy arrays,
or anything ``np.asarray`` accepts; this module imports no JAX.
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


def _tensor_keep(x, device):
    """``x`` as a tensor of its own dtype (a bf16 array as bf16)."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(x)).to(device)


def _numpy(t):
    """A tensor as numpy: a bf16 one as its fp32 values."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def _layers(ref_tree, device, n_tail: int = None, conv=_tensor) -> List:
    """The reference's blocks (and tail) as the port's per-layer list in
    forward order.  ``n_tail`` counts the tail layers where ``tail`` may
    be left out (a LoRA tree); by default it is ``len(tail)``.  ``conv``
    makes each tensor (fp32 by default)."""
    blocks = ref_tree["blocks"]
    tail = list(ref_tree.get("tail") or ())
    if n_tail is not None:
        tail += [None] * (n_tail - len(tail))
    stacked = [b for b in blocks if b is not None]
    G = np.shape(_first_leaf(stacked[0]))[0] if stacked else 0
    per_pos = [[None] * G if pos is None else _unstack(pos, device, conv)
               for pos in blocks]
    out = [layer for g in range(G) for layer in (p[g] for p in per_pos)]
    return out + [_np_map(lambda x: conv(x, device), t) for t in tail]


def _unstack(tree, device, conv=_tensor) -> List:
    """A tree stacked over a leading axis (a pattern position's blocks,
    the encoder's blocks) as a list of per-layer trees."""
    n = np.shape(_first_leaf(tree))[0]
    return [_np_map(lambda x, i=i: conv(np.asarray(x)[i], device), tree)
            for i in range(n)]


def _stack(layers: List):
    """The inverse of ``_unstack``, as numpy arrays."""
    def rec(first, rest):
        if isinstance(first, dict):
            return {k: rec(v, [r[k] for r in rest]) for k, v in first.items()}
        return np.stack([_numpy(t) for t in [first] + rest])
    return rec(layers[0], layers[1:])


def _encoder_from_reference(enc: Dict, device) -> Dict:
    out = {"layers": _unstack(enc["blocks"], device)}
    out.update({k: _np_map(lambda x: _tensor(x, device), v)
                for k, v in enc.items() if k != "blocks"})
    return out


def _encoder_to_reference(enc: Dict) -> Dict:
    out = {"blocks": _stack(enc["layers"])}
    out.update({k: _np_map(lambda t: t.detach().cpu().numpy(), v)
                for k, v in enc.items() if k != "layers"})
    return out


def _n_tail(cfg) -> int:
    if cfg is None:
        return 0
    P = len(cfg.layer_pattern or (None,))
    return cfg.n_layers - cfg.n_layers // P * P


def params_from_reference(ref_params: Dict, device) -> Dict:
    """The reference's ``model.init`` tree -> port parameters."""
    out = {k: _np_map(lambda x: _tensor(x, device), v)
           for k, v in ref_params.items()
           if k not in ("blocks", "tail", "encoder")}
    out["layers"] = _layers(ref_params, device)
    if "encoder" in ref_params:
        out["encoder"] = _encoder_from_reference(ref_params["encoder"],
                                                 device)
    return out


def lora_from_reference(ref_lora: Dict, device, cfg=None) -> Dict:
    """A reference LoRA tree ({"blocks": (..., {"attn": {...}}, ...)[,
    "tail": (...)][, "encoder": {"blocks": {...}}]}) -> port.  ``cfg``
    (the model's config) gives the number of tail layers, which a
    reference LoRA tree without targets there does not record; without
    it the model has no tail."""
    out = {"layers": _layers(ref_lora, device, _n_tail(cfg))}
    if "encoder" in ref_lora:
        out["encoder"] = _encoder_from_reference(ref_lora["encoder"], device)
    return out


def _blocks(layers: List, cfg) -> Dict:
    """The port's per-layer list as the reference's {"blocks": (...),
    "tail": (...)} of numpy arrays, each pattern position's layers
    stacked over the full groups; ``None`` stays where a layer has no
    entry.  ``cfg`` gives the layer pattern; without it each layer is its
    own group (the dense family)."""
    P = len(cfg.layer_pattern or (None,)) if cfg is not None else 1
    n_tail = _n_tail(cfg)
    G = (len(layers) - n_tail) // P
    blocks = []
    for pos in range(P if G else 0):
        group = [layers[g * P + pos] for g in range(G)]
        blocks.append(None if group[0] is None else _stack(group))
    tail = [_np_map(_numpy, t) for t in layers[G * P:]]
    return {"blocks": tuple(blocks), "tail": tuple(tail)}


def params_to_reference(params: Dict, cfg=None) -> Dict:
    """Port parameters -> the reference's ``model.init`` layout (numpy),
    the inverse of ``params_from_reference``: a round trip through both
    gives every leaf back bit for bit."""
    out = {k: _np_map(lambda t: t.detach().cpu().numpy(), v)
           for k, v in params.items() if k not in ("layers", "encoder")}
    out.update(_blocks(params["layers"], cfg))
    if "encoder" in params:
        out["encoder"] = _encoder_to_reference(params["encoder"])
    return out


def lora_to_reference(lora: Dict, cfg=None) -> Dict:
    """A port LoRA tree -> the reference's nested numpy layout, with
    ``None`` where the reference's has no target.  ``cfg`` gives the
    layer pattern; without it each layer is its own group (the dense
    family)."""
    out = _blocks(lora["layers"], cfg)
    if not any(t is not None for t in out["tail"]):
        del out["tail"]
    if "encoder" in lora:
        out["encoder"] = _encoder_to_reference(lora["encoder"])
    return out


def opt_state_from_reference(ref_state: Dict, device, cfg=None) -> Dict:
    """An optimizer state over a reference LoRA tree (optim/adam.init's
    {"m", "v", "step"}, optim/sgd.init's {"mu"}, ``mu`` None without
    momentum) -> the port's; ``cfg`` as for ``lora_from_reference``."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return lora_from_reference(v, device, cfg)
        return int(np.asarray(v))
    return {k: conv(v) for k, v in ref_state.items()}


def opt_state_to_reference(state: Dict, cfg=None) -> Dict:
    """The inverse of ``opt_state_from_reference`` (numpy; the step count
    an int32 array, as the reference's)."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return lora_to_reference(v, cfg)
        return np.asarray(v, np.int32)
    return {k: conv(v) for k, v in state.items()}


def adapters_from_reference(ref_adapters: Dict, device, cfg=None) -> Dict:
    """A reference adapter tree (peft/adapters.init_adapters: {"blocks",
    "tail"}) -> the port's {"layers": [...]}."""
    return {"layers": _layers(ref_adapters, device, _n_tail(cfg))}


def adapters_to_reference(adapters: Dict, cfg=None) -> Dict:
    """The inverse of ``adapters_from_reference``."""
    return _blocks(adapters["layers"], cfg)


def prompt_from_reference(ref_prompt: Dict, device) -> Dict:
    """A reference prompt tree ({"prompt": (n_virtual, d)}) -> port."""
    return {k: _tensor(v, device) for k, v in ref_prompt.items()}


def prompt_to_reference(prompt: Dict) -> Dict:
    return {k: t.detach().cpu().numpy() for k, t in prompt.items()}


def cache_from_reference(ref_cache: Dict, device) -> Dict:
    """A reference decode cache (``Model.init_cache`` or one returned by
    ``decode_step``) -> the port's, each leaf in its own dtype."""
    out = {"layers": _layers(ref_cache, device, conv=_tensor_keep)}
    if "xkv" in ref_cache:
        k, v = (np.asarray(t) for t in ref_cache["xkv"])
        out["xkv"] = [(_tensor_keep(k[g], device), _tensor_keep(v[g], device))
                      for g in range(k.shape[0])] + [
            tuple(_tensor_keep(t, device) for t in kv)
            for kv in ref_cache.get("xkv_tail") or ()]
    return out


def cache_to_reference(cache: Dict, cfg=None) -> Dict:
    """The inverse of ``cache_from_reference``, as numpy (bf16 leaves as
    their fp32 values); ``cfg`` gives the layer pattern."""
    out = _blocks(cache["layers"], cfg)
    if "xkv" in cache:
        G = len(cache["xkv"]) - _n_tail(cfg)
        out["xkv"] = tuple(np.stack([_numpy(kv[i]) for kv in
                                     cache["xkv"][:G]]) for i in (0, 1))
        out["xkv_tail"] = tuple(tuple(_numpy(t) for t in kv)
                                for kv in cache["xkv"][G:])
    return out

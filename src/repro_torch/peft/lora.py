"""LoRA (Low-Rank Adaptation) over parameter trees.

Counterpart of ``src/repro/peft/lora.py``.  A LoRA tree mirrors the base
tree at the targeted leaves only:

    base:  {"layers": [{"attn": {"wq": (d, f), ...}, ...}, ...]}
    lora:  {"layers": [{"attn": {"wq": {"a": (d, r), "b": (r, f)}}}, ...]}

A layer with no targeted weight (an RG-LRU layer of the Griffin hybrid)
is ``None`` in the LoRA list; ``bind`` leaves it as it is, and the tree
functions of repro_torch/tree.py skip it.

``bind`` produces the tree the model consumes, replacing each targeted
weight W with ``{"w": W, "a": A, "b": B·alpha/r}``; models/common.mm
computes ``x@W + (x@A)@B`` from it without materialising W + BA.
core/fedavg differentiates the loss with respect to the LoRA leaves only
(the PEFT property), so no training path forms a gradient of W; a caller
that binds a W requiring a gradient gets dW = xᵀg (the dense dW kernel
under the ``cuda`` policy).  ``merge`` materialises W + BA·alpha/r
instead, the serving form.

A stacked expert weight (E, d, ff) of a MoE layer gets batched factors,
a (E, d, r) and b (E, r, ff), as in the reference, and ``merge`` forms
each expert's W + A@B·alpha/r; ``bind`` refuses it, since the expert
MLPs (models/moe.py), like the reference's, consume a plain tensor.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.runtime import compute_dtype

DEFAULT_TARGETS: Tuple[str, ...] = ("wq", "wk", "wv")
RWKV_TARGETS: Tuple[str, ...] = ("w_r", "w_k", "w_v", "w_g")


def default_targets(cfg) -> Tuple[str, ...]:
    """The reference's targets by family: the time-mix projections for an
    attention-free model (every layer RG-LRU or RWKV-6), QKV otherwise."""
    return RWKV_TARGETS if cfg.attention_free else DEFAULT_TARGETS


def lora_apply(x, w, a, b):
    """The LoRA projection hot path ``x@W + (x@A)@B`` (scale folded into
    ``b``): the fused CUDA kernel under the ``cuda`` kernel policy, the
    plain matmul chain otherwise (kernels/ops.lora_matmul)."""
    from repro_torch.kernels import ops as kernel_ops
    return kernel_ops.lora_matmul(x, w, a, b)


def _walk(tree, fn: Callable, path: Tuple[str, ...] = ()):
    """Depth-first walk; fn(path, leaf) -> replacement or None (drop)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            r = _walk(v, fn, path + (str(k),))
            if r is not None:
                out[k] = r
        return out or None
    if isinstance(tree, (tuple, list)):
        out = [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
        return out if any(r is not None for r in out) else None
    return fn(path, tree)


def init_lora(gen: torch.Generator, base_params, targets: Sequence[str],
              rank: int, alpha: float = 32.0):
    """Build a LoRA tree: A ~ N(0, 1/r) (paper: Gaussian init), B = 0, fp32
    (fp64 beside fp64 weights: the same draws), on the device of each
    targeted weight.  A weight with leading dims (stacked experts, (E,
    d_in, d_out)) gets factors (E, d_in, r) and (E, r, d_out)."""

    def init_leaf(path, leaf):
        if path[-1] not in targets or leaf.dim() < 2:
            return None
        *lead, d_in, d_out = leaf.shape
        a = torch.randn((*lead, d_in, rank), generator=gen) * rank ** -0.5
        dt = compute_dtype(leaf.dtype)
        return {"a": a.to(leaf.device, dt),
                "b": torch.zeros((*lead, rank, d_out), device=leaf.device,
                                 dtype=dt)}

    lora = _walk(base_params, init_leaf)
    return lora if lora is not None else {}


def bind(base_params, lora_tree, alpha: float, rank: int,
         dropout_gen=None, dropout: float = 0.0):
    """The model-consumable tree with LoRA leaves bound.

    ``dropout`` drops input features on the LoRA branch only: a per-call
    feature mask from ``dropout_gen``, folded into A
    ((x*m)@A == x@(m[:, None]*A)).

    A stacked clients' tree (a (C, K, r), b (C, r, N): the ``spmd``
    backend) binds each client's factors; ``dropout_gen`` is then a list
    of C generators, client c's mask drawn from the c-th in the order a
    one-client bind draws it, so each client sees the masks of its
    sequential run.  A stacked expert weight (a base leaf of more than two
    dims) raises: its consumer takes no bound form (module docstring)."""
    scale = alpha / max(rank, 1)

    def combine(b, l):
        if isinstance(l, dict) and set(l) == {"a", "b"}:
            if b.dim() > 2:
                raise NotImplementedError(
                    f"bind: LoRA on a stacked expert weight "
                    f"{tuple(b.shape)} has no bound form (models/moe.py "
                    f"takes the experts as plain tensors); serve it merged "
                    f"(lora.merge)")
            a = l["a"]
            if dropout > 0.0 and dropout_gen is not None:
                if a.dim() == 3:
                    keep = torch.stack([torch.rand(a.shape[-2], generator=g)
                                        for g in dropout_gen]) >= dropout
                    mask = keep.float().to(a.device) / (1.0 - dropout)
                    a = a * mask[:, :, None]
                else:
                    keep = torch.rand(a.shape[-2], generator=dropout_gen) \
                        >= dropout
                    mask = keep.float().to(a.device) / (1.0 - dropout)
                    a = a * mask[:, None]
            return {"w": b, "a": a, "b": l["b"] * scale}
        if isinstance(b, dict):
            return {k: combine(b[k], l[k]) if (isinstance(l, dict) and k in l)
                    else b[k] for k in b}
        if isinstance(b, (tuple, list)):
            return [combine(bv, l[i]) if (isinstance(l, (tuple, list))
                                          and l[i] is not None) else bv
                    for i, bv in enumerate(b)]
        return b

    return combine(base_params, lora_tree)


def merge(base_params, lora_tree, alpha: float, rank: int):
    """The base tree with each targeted weight W replaced by W + A@B·
    alpha/rank (the serving form; the inverse of bind's factored one),
    over any leading dims (stacked experts: each expert's own product).
    The product is a plain matmul in W's dtype."""
    scale = alpha / max(rank, 1)

    def combine(b, l):
        if isinstance(l, dict) and set(l) == {"a", "b"}:
            return b + (l["a"] @ l["b"] * scale).to(b.dtype)
        if isinstance(b, dict):
            return {k: combine(b[k], l[k]) if (isinstance(l, dict) and k in l)
                    else b[k] for k in b}
        if isinstance(b, (tuple, list)):
            return [combine(bv, l[i]) if (isinstance(l, (tuple, list))
                                          and l[i] is not None) else bv
                    for i, bv in enumerate(b)]
        return b

    return combine(base_params, lora_tree)


def tree_rank(lora_tree, default: int) -> int:
    """A LoRA tree's rank, read off its first ``a`` factor."""
    for leaf in tree_lib.leaves(lora_tree):
        if leaf.dim() >= 2:
            return leaf.shape[-1] if leaf.shape[-1] != 0 else default
    return default


def n_params(lora_tree) -> int:
    return sum(x.numel() for x in tree_lib.leaves(lora_tree))


def n_bytes(lora_tree) -> int:
    return sum(x.numel() * x.element_size()
               for x in tree_lib.leaves(lora_tree))


# --------------------------------------------------------------------------- #
# Heterogeneous-rank harmonization (paper SS IV.A.2)
# --------------------------------------------------------------------------- #
def map_factors(fn: Callable, *trees):
    """``fn`` over the matching LoRA leaves ({"a", "b"} dicts) of
    ``trees``, one leaf of each tree a call, keeping the first tree's
    containers and its ``None`` layers."""
    t0 = trees[0]
    if isinstance(t0, dict) and set(t0) == {"a", "b"}:
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: map_factors(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(
            None if v is None else map_factors(fn, *[t[i] for t in trees])
            for i, v in enumerate(t0))
    return t0


def pad_rank(lora_tree, target_rank: int, rescale: bool = True):
    """Zero-pad a LoRA tree's rank dim up to ``target_rank``.

    bind scales the delta by alpha/rank, so growing the rank would shrink
    the learned delta; with ``rescale`` (default) B is multiplied by
    target/orig so the effective delta is preserved exactly (the padded
    rows of B are zero, so the extra rank starts inert)."""

    def pad(leaf):
        orig = leaf["a"].shape[-1]
        n = target_rank - orig
        gain = (target_rank / orig) if (rescale and orig) else 1.0
        b = leaf["b"] * gain
        if n <= 0:
            return {"a": leaf["a"], "b": b}
        return {"a": torch.nn.functional.pad(leaf["a"], (0, n)),
                "b": torch.nn.functional.pad(b, (0, 0, 0, n))}

    return map_factors(pad, lora_tree)


def truncate_rank(lora_tree, rank: int, orig_rank: int):
    """Keep the first ``rank`` components, rescaling for bind's alpha/r:
    the client binds with alpha/rank, the global delta was alpha/orig, so
    B shrinks by rank/orig to keep the effective delta's scale.  The
    factors are copied contiguous, as the fused LoRA kernels take them."""
    gain = rank / max(orig_rank, 1)
    return map_factors(
        lambda leaf: {"a": leaf["a"][..., :rank].contiguous(),
                      "b": leaf["b"][..., :rank, :] * gain}, lora_tree)


def maybe_truncate_rank(lora_tree, rank: int, orig_rank: int):
    """The a1/cc3 distribution rule: a weak client gets a truncated copy
    of the global tree, a full-rank client the tree itself."""
    if rank == orig_rank:
        return lora_tree
    return truncate_rank(lora_tree, rank, orig_rank)


def svd_truncate(delta: torch.Tensor, rank: int):
    """Rank-``rank`` factorization (U·S, Vᵀ) of a (possibly stacked)
    delta by ``torch.linalg.svd``, in fp32 (fp64 for an fp64 delta): the
    reference calls ``jnp.linalg.svd`` outside any Pallas kernel.  The
    signs of the factors' columns are the library's choice, so only the
    product is comparable across libraries."""
    u, s, vt = torch.linalg.svd(delta.to(compute_dtype(delta.dtype)),
                                full_matrices=False)
    return (u[..., :, :rank] * s[..., None, :rank]).contiguous(), \
        vt[..., :rank, :].contiguous()

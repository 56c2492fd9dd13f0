"""Gradient utilities: global-norm clip (whole-tree and stacked
per-example variants), finite check.

Counterpart of ``src/repro/optim/clip.py``.  All norm and scale arithmetic
runs in fp32 whatever the leaf dtype, with the guard an explicit fp32
``max(norm, EPS)``, so the scale is exact and finite for any leaf dtype,
an all-zero tree included.  ``EPS`` is the one epsilon of the host, the
plain twin (kernels/ref.clip_mean_rows_ref) and the CUDA kernel
(kernels/dp_clip.py passes it to csrc/dp_clip.cu).

The per-example variants treat axis 0 of every leaf as the example axis:
the shape of DP-SGD's stacked per-example LoRA gradients
(privacy/dp.py).
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.runtime import compute_dtype

EPS = 1e-9


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float()))
              for x in tree_lib.leaves(tree)]
    return torch.sqrt(sum(leaves)) if leaves else torch.zeros(())


def _clip_scale(norm, max_norm: float) -> torch.Tensor:
    """fp32 scale ``min(1, C / max(norm, EPS))`` by IEEE division (a
    tensor divisor: PyTorch turns ``scalar / tensor`` into a reciprocal
    product); fp64 for an fp64 norm."""
    norm = torch.as_tensor(norm)
    norm32 = norm.to(compute_dtype(norm.dtype))
    c = torch.full_like(norm32, float(max_norm))
    return torch.clamp_max(c / torch.clamp_min(norm32, EPS), 1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_lib.map_(lambda x: (x.float() * scale).to(x.dtype),
                         tree), norm


def per_example_global_norm(tree) -> torch.Tensor:
    """(B,) global norms of a stacked per-example tree: the norm of
    example ``b`` spans every leaf's ``[b]`` slice, accumulated in fp32."""
    leaves = tree_lib.leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    sq = [torch.sum(torch.square(x.float()).reshape(x.shape[0], -1), dim=1)
          for x in leaves]
    return torch.sqrt(sum(sq))


def clip_per_example(tree, max_norm: float):
    """Clip every example slice of a stacked tree to ``max_norm``.
    Returns ``(clipped_tree, norms)``, ``norms`` the (B,) pre-clip global
    norms; leaf dtypes are kept, scales are fp32."""
    norms = per_example_global_norm(tree)
    scale = _clip_scale(norms, max_norm)

    def clip_leaf(x):
        s = scale.reshape((-1,) + (1,) * (x.dim() - 1))
        return (x.float() * s).to(x.dtype)

    return tree_lib.map_(clip_leaf, tree), norms


def all_finite(tree) -> torch.Tensor:
    ok = [torch.isfinite(x.float()).all() for x in tree_lib.leaves(tree)]
    return torch.stack(ok).all() if ok else torch.tensor(True)

"""Client-side DP-SGD primitives (``PrivacyConfig.dp_clip`` /
``dp_noise_multiplier``).  Counterpart of ``src/repro/privacy/dp.py``.

Two mechanisms compose:

- **Per-example gradient clipping** inside every local fine-tune step
  (core/fedavg's DP-SGD ``train_step``): the step writes each example's
  LoRA gradient into one row of a (B, P) fp32 matrix and takes the mean
  of the clipped rows through kernels/ops.clip_mean_rows (the CUDA
  kernels of kernels/dp_clip.py under the ``cuda`` policy, the plain
  version otherwise); the ``spmd`` backend's stacked step, each client's
  rows of a (C, B, P) matrix through ``clipped_grad_mean_clients``.
  Deterministic.

- **Seeded Gaussian noise on the uploaded payload**: the LoRA params
  (FedLLM) or the row-clipped logits (KD b3, before compression).  The
  noise comes from ``noise_generator``, a stream of its own over
  (separator 0x5EC7, fed seed, privacy seed, round, client, step), never
  the LoRA-dropout stream (core/round_program.local_generator).  It is
  drawn on a CPU ``torch.Generator`` and moved to the payload's device,
  so the CPU and the card draw the same noise.  The draws are torch's,
  not ``jax.random``'s: the reference's noise is not reproduced bit for
  bit, only its distribution.

The noise scale is ``sigma * C`` (PrivacyConfig.noise_std): each round's
upload is accounted as one Gaussian-mechanism release of a C-clipped
quantity (privacy/accountant.py).  ``noise_key_grid`` (the reference's
stacked Split keys) has no counterpart: the port's Split under ``spmd``
is the sequential loop, which draws from ``noise_generator``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import FedConfig
from repro_torch.optim.clip import _clip_scale
from repro_torch.runtime import compute_dtype

_STREAM = 0x5EC7  # domain separator: privacy noise vs fed/dropout seeds
# every noise seed has this bit set; LoRA-dropout seeds
# (seed * 1013 + round * 131 + client) stay below it, so the streams are
# disjoint
_NOISE_BIT = 1 << 62


def _seed(words) -> int:
    state = np.random.SeedSequence([int(w) % (1 << 64) for w in words])
    word = int(state.generate_state(1, np.uint64)[0])
    return (word & (_NOISE_BIT - 1)) | _NOISE_BIT


def noise_generator(fed: FedConfig, rnd: int, ci: int,
                    step: int = 0) -> torch.Generator:
    """The noise stream of one (round, client[, step]) upload: a CPU
    generator seeded from (0x5EC7, fed.seed, privacy.seed, rnd, ci, step)."""
    return torch.Generator().manual_seed(
        _seed((_STREAM, fed.seed, fed.privacy.seed, rnd, ci, step)))


def _leaf_generators(gen: torch.Generator, n: int):
    """One sub-stream per leaf, seeded by draws of ``gen``."""
    seeds = torch.randint(0, 1 << 62, (n,), generator=gen)
    return [torch.Generator().manual_seed(_seed((_STREAM, int(s))))
            for s in seeds]


def _gaussian(shape, gen: torch.Generator, std: float, like):
    """N(0, std²) in fp32 on ``gen`` (CPU), cast to ``like``'s dtype and
    moved to its device."""
    z = torch.randn(shape, generator=gen, dtype=torch.float32) * std
    return z.to(device=like.device, dtype=like.dtype)


# --------------------------------------------------------------------------- #
# Per-example clipping (the DP-SGD step body)
# --------------------------------------------------------------------------- #
def clipped_grad_mean(per_example_grads, clip: float):
    """Stacked per-example grad tree (leaves (B, ...)) -> mean tree of the
    per-example L2-clipped gradients, through the clip-scale-accumulate
    kernel.  A (B, P) tensor is a tree of one leaf: its rows are the
    kernel's rows, read in place, and the result is (P,)."""
    from repro_torch.kernels import ops as kernel_ops

    leaves = tree_lib.leaves(per_example_grads)
    B = leaves[0].shape[0]
    rows = [x.reshape(B, -1).to(compute_dtype(x.dtype)) for x in leaves]
    flat = rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)
    mean = kernel_ops.clip_mean_rows(flat, clip)            # (P,)
    out, off = [], 0
    for x in leaves:
        n = x[0].numel()
        out.append(mean[off:off + n].reshape(x.shape[1:]).to(x.dtype))
        off += n
    return tree_lib.unflatten(per_example_grads, out)


def clipped_grad_mean_clients(rows, clip: float):
    """Each stacked client's clipped mean: rows (C, B, P), client c's
    per-example gradients in its B rows -> (C, P) fp32 (fp64 for fp64
    rows), row c the clipped mean of client c's rows.  The reference's
    ``vmap`` of ``clipped_grad_mean`` over the client axis (the spmd
    backend's DP-SGD step), through the clip kernels with a client axis
    (kernels/ops.clip_mean_rows_clients)."""
    from repro_torch.kernels import ops as kernel_ops

    return kernel_ops.clip_mean_rows_clients(
        rows.to(compute_dtype(rows.dtype)), clip)


# --------------------------------------------------------------------------- #
# Payload noise (upload boundary)
# --------------------------------------------------------------------------- #
def privatize_tree(tree, gen: torch.Generator, std: float):
    """tree + iid N(0, std²) per leaf, each leaf on its own sub-stream of
    ``gen`` (fp32 draw, cast to the leaf dtype).  ``std == 0`` is the
    identity."""
    if std <= 0.0:
        return tree
    leaves = tree_lib.leaves(tree)
    gens = _leaf_generators(gen, len(leaves))
    return tree_lib.unflatten(tree, [x + _gaussian(x.shape, g, std, x)
                                     for x, g in zip(leaves, gens)])


def clip_rows(x, clip: float):
    """Clip each row (last-axis vector) of ``x`` to L2 norm ``clip``
    (optim/clip's fp32 eps-guarded scale)."""
    x32 = x.float()
    norms = torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True))
    return (x32 * _clip_scale(norms, clip)).to(x.dtype)


def privatize_rows(x, gen: torch.Generator, fed: FedConfig):
    """Row-clip + Gaussian-noise a (..., d) tensor: the building block of
    ``privatize_logits`` (and of the Split boundary mechanism c2, which
    comes with the Split slice).  Identity when DP is off."""
    priv = fed.privacy
    if not priv.dp_enabled:
        return x
    y = clip_rows(x, priv.dp_clip)
    if priv.noise_std > 0.0:
        y = y + _gaussian(y.shape, gen, priv.noise_std, y)
    return y


def privatize_logits(logits, gen: torch.Generator, fed: FedConfig):
    """KD b3 upload mechanism: per-row clipped, noised logits, applied
    before the top-k/int-quant compression."""
    return privatize_rows(logits, gen, fed)

"""The round engine's host-side seed derivations.  Counterpart of
``src/repro/core/rng.py``.

- ``fold_chain`` / ``host_fold_rng``: the reference's ``jax.random``
  key chain ``fold_in(... fold_in(PRNGKey(seed), v0) ..., vn)``
  reproduced word for word in numpy (``threefry2x32`` below, the
  Threefry-2x32 block cipher with 20 rounds that ``jax.random``'s default
  PRNG is built on).  ``host_fold_rng`` seeds a numpy ``Generator`` with
  the key's two words, so host-side per-entity randomness (a virtual
  client's data shard: data/population.DirichletPopulation) is the
  reference's draw for draw, whatever order the entities are built in.
- ``local_generator``: the LoRA-dropout stream of one (round, client)
  job, the counterpart of the reference's ``local_rng``.  Its seed is
  the reference's formula; its draws are torch's own (the port's dropout
  masks are not ``jax.random``'s).
- Batching seeds are plain ints handed to data/loader.epoch_batches, and
  the privacy noise stream is privacy/dp.noise_generator's.

``grid_keys`` has no counterpart: the ``spmd`` executor hands each
stacked client the generator ``local_generator`` gives it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: Tuple[int, int], x: Tuple[int, int]) -> Tuple[int, int]:
    """Threefry-2x32 (20 rounds) of the count words ``x`` under ``key``:
    the block function of ``jax.random``'s ``threefry2x32`` on one pair
    of uint32 words, in Python integers masked to 32 bits."""
    ks = (key[0] & _MASK, key[1] & _MASK,
          (key[0] ^ key[1] ^ _PARITY) & _MASK)
    x0 = (x[0] + ks[0]) & _MASK
    x1 = (x[1] + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _uint32(v: int) -> int:
    v = int(v)
    if not 0 <= v <= _MASK:
        raise OverflowError(f"Python integer {v} out of bounds for uint32")
    return v


def fold_chain(seed: int, *vals) -> Tuple[int, int]:
    """The two uint32 words of ``fold_in`` chained over ``vals`` from
    ``PRNGKey(seed)``: the key is (0, seed mod 2³²) and ``fold_in(k, v)``
    is ``threefry2x32(k, (0, v))`` for v in [0, 2³²)."""
    key = (0, int(seed) & _MASK)
    for v in vals:
        key = threefry2x32(key, (0, _uint32(v)))
    return key


def host_fold_rng(seed: int, *vals) -> np.random.Generator:
    """A numpy ``Generator`` seeded with the words of ``fold_chain(seed,
    *vals)``, the reference's ``host_fold_rng`` draw for draw."""
    return np.random.default_rng(list(fold_chain(seed, *vals)))


def local_generator(fed, rnd: int, ci: int) -> torch.Generator:
    """The LoRA-dropout stream of one (round, client) job.  The seed formula
    is the reference's (``local_rng``); the draws are torch's own."""
    return torch.Generator().manual_seed(fed.seed * 1013 + rnd * 131 + ci)

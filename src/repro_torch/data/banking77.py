"""Synthetic Banking77-like intent-classification dataset (paper SSV).

Reproduces ``src/repro/data/banking77.py`` line for line (numpy only), so
the same arguments give bit-identical arrays: each intent c has a small
set of keyword token ids; an utterance mixes class keywords with shared
vocabulary, padded to ``pad_len``.  Classification targets vocab ids
[1, 1 + N_CLASSES) at the last non-pad position.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

N_CLASSES = 77
PAD_ID = 0
KEYWORDS_PER_CLASS = 6
SHARED_VOCAB_FRAC = 0.3


def generate(n_samples: int, vocab_size: int, pad_len: int = 80,
             seed: int = 0, class_skew: float = 0.0) -> Dict[str, np.ndarray]:
    """Returns {"tokens": (N, pad_len) int32, "labels": (N,) int32,
    "lengths": (N,) int32}.  ``class_skew`` > 0 draws class frequencies
    from Dirichlet(skew)."""
    rng = np.random.default_rng(seed)
    if vocab_size <= N_CLASSES + 100:
        raise ValueError("vocab too small for class tokens")
    kw_base = N_CLASSES + 1
    kpc = max(1, min(KEYWORDS_PER_CLASS,
                     (vocab_size - kw_base - 64) // N_CLASSES))
    kw = kw_base + np.arange(N_CLASSES * kpc).reshape(N_CLASSES, kpc)
    shared_lo = kw_base + N_CLASSES * kpc
    shared_hi = max(shared_lo + 2,
                    min(vocab_size, int(shared_lo + SHARED_VOCAB_FRAC
                                        * (vocab_size - shared_lo))))

    if class_skew > 0:
        pvals = rng.dirichlet(np.full(N_CLASSES, class_skew))
    else:
        pvals = np.full(N_CLASSES, 1.0 / N_CLASSES)
    labels = rng.choice(N_CLASSES, size=n_samples, p=pvals).astype(np.int32)

    lengths = rng.integers(8, pad_len, size=n_samples).astype(np.int32)
    tokens = np.full((n_samples, pad_len), PAD_ID, np.int32)
    for i in range(n_samples):
        L = lengths[i]
        n_kw = max(2, int(0.35 * L))
        kws = rng.choice(kw[labels[i]], size=n_kw)
        rest = rng.integers(shared_lo, shared_hi, size=L - n_kw)
        seq = np.concatenate([kws, rest])
        rng.shuffle(seq)
        tokens[i, :L] = seq
    return {"tokens": tokens, "labels": labels, "lengths": lengths}


def paper_splits(vocab_size: int, pad_len: int = 80, seed: int = 0,
                 scale: float = 1.0) -> Tuple[dict, dict, dict]:
    """Paper SSV: 5002 public + 5001 train (3 x 1667) + test split.

    ``scale`` shrinks everything proportionally for CI-speed runs."""
    n_pub = max(16, int(5002 * scale))
    n_train = max(18, int(5001 * scale))
    n_test = max(77, int(3080 * scale * 2))
    full = generate(n_pub + n_train + n_test, vocab_size, pad_len, seed)
    cut1, cut2 = n_pub, n_pub + n_train
    public = {k: v[:cut1] for k, v in full.items()}
    train = {k: v[cut1:cut2] for k, v in full.items()}
    test = {k: v[cut2:] for k, v in full.items()}
    return public, train, test

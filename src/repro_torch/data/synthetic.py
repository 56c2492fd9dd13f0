"""Synthetic LM corpora for generative-task experiments and smoke tests:
a Zipf-distributed Markov-chain token stream with learnable bigram
structure (so LM loss decreases measurably during fine-tuning).
Counterpart of ``src/repro/data/synthetic.py`` (numpy only): the same
draws in the same order, so the same seed gives the same arrays bit for
bit."""
from __future__ import annotations

import numpy as np


def markov_corpus(n_tokens: int, vocab_size: int, seed: int = 0,
                  branching: int = 8) -> np.ndarray:
    """Each token deterministically prefers ``branching`` successors."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab_size, size=(vocab_size, branching))
    out = np.empty(n_tokens, np.int32)
    t = int(rng.integers(vocab_size))
    zipf_p = 1.0 / np.arange(1, branching + 1)
    zipf_p /= zipf_p.sum()
    choices = rng.choice(branching, size=n_tokens, p=zipf_p)
    noise = rng.random(n_tokens) < 0.05
    rand = rng.integers(0, vocab_size, size=n_tokens)
    for i in range(n_tokens):
        t = int(rand[i]) if noise[i] else int(succ[t, choices[i]])
        out[i] = t
    return out


def lm_batches(corpus: np.ndarray, batch: int, seq_len: int, seed: int = 0):
    """Yields {"tokens": (B, S+1)} windows forever."""
    rng = np.random.default_rng(seed)
    n = len(corpus) - seq_len - 1
    while True:
        idx = rng.integers(0, n, size=batch)
        yield {"tokens": np.stack([corpus[i:i + seq_len + 1] for i in idx])}

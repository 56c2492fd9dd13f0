"""Minimal batching utilities (shuffled epochs, drop-remainder).
Reproduces ``src/repro/data/loader.py``: the same seed gives the same
batch order."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def epoch_batches(data: Dict[str, np.ndarray], batch_size: int,
                  seed: int = 0, drop_remainder: bool = True
                  ) -> Iterator[Dict[str, np.ndarray]]:
    n = len(data["tokens"])
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, stop, batch_size):
        sel = perm[i:i + batch_size]
        yield {k: v[sel] for k, v in data.items()}

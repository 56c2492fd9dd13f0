"""Federated client partitioning (paper SSV: 5001 samples split evenly
across 3 clients).  Reproduces ``iid_partition`` of
``src/repro/data/partition.py`` (numpy only, bit-identical shards)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def iid_partition(data: Dict[str, np.ndarray], n_clients: int,
                  seed: int = 0) -> List[Dict[str, np.ndarray]]:
    n = len(data["tokens"])
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    shards = np.array_split(perm, n_clients)
    return [{k: v[s] for k, v in data.items()} for s in shards]

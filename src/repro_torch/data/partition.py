"""Federated client partitioning: IID (paper SSV: 5001 samples split
evenly across 3 clients) and Dirichlet label-skew non-IID.  Counterpart of
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


def dirichlet_partition(data: Dict[str, np.ndarray], n_clients: int,
                        alpha: float = 0.5, seed: int = 0,
                        n_classes: int = 77) -> List[Dict[str, np.ndarray]]:
    """Label-skewed non-IID split: the eager view of
    data/population.DirichletPopulation, each client's shard drawn from a
    seeded fold over ``(seed, client)`` (a Dirichlet(alpha) label
    distribution, then draws with replacement from per-class index
    pools), so client ``ci``'s shard is the same however many clients are
    built, and in any order."""
    from repro_torch.data.population import DirichletPopulation
    pop = DirichletPopulation(data, n_clients, alpha=alpha, seed=seed,
                              n_classes=n_classes)
    return [pop.client(ci) for ci in range(n_clients)]


def label_histogram(data: Dict[str, np.ndarray],
                    n_classes: int = 77) -> np.ndarray:
    """A client's label distribution: the feedback clients share for
    public-dataset alignment (paper SS IV.B.1)."""
    h = np.bincount(data["labels"], minlength=n_classes).astype(np.float64)
    return h / max(h.sum(), 1.0)

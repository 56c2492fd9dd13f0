"""Client populations: how the round engine is handed its clients.
Counterpart of ``src/repro/data/population.py``, line for line.

A ``ClientPopulation`` is a spec for a fleet of virtual clients, not a
list of materialized shards.  The round engine only asks it for

- ``len(pop)`` / ``pop.data_weights()``: the fleet's size and each
  client's sample count, with no data materialized;
- ``pop[ci]``: one client's shard, materialized on demand;
- ``pop.cohort(rnd, idx)``: one cohort's clients and shards, the unit
  the cohort-streaming executor (core/round_program.py) streams through
  a round, so that peak memory is one cohort's.

Two implementations:

- ``EagerPopulation`` holds a list of shards (by reference);
  core/rounds.run_federated wraps a list in one
  (``ClientPopulation.from_clients_data``).
- ``DirichletPopulation`` is the lazy non-IID fleet: client ``ci``'s
  shard is derived from a seeded fold over ``(seed, ci)``
  (core/rng.host_fold_rng, the reference's threefry key chain in
  numpy): a Dirichlet(alpha) label distribution, then a shard drawn with
  replacement from per-class index pools of a small base dataset.  The
  draws are numpy's from the reference's seed words, so every shard is
  the reference's array for array, whatever order clients are built in.

Shards are the same every round; ``cohort``'s ``rnd`` argument keeps the
reference's signature.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import rng as rng_mod

_POP_STREAM = 0x9E37  # domain separator for per-client shard derivation


@dataclasses.dataclass
class Cohort:
    """One materialized cohort: global client ids and their shards (in id
    order), ``data[k]`` client ``clients[k]``'s whole local shard."""
    round: int
    index: int
    clients: List[int]
    data: List[Dict[str, np.ndarray]]

    def __len__(self) -> int:
        return len(self.clients)


class ClientPopulation:
    """A fleet of ``n_clients`` virtual clients.  Subclasses implement
    ``client(ci)`` and ``data_weights()``; the base class gives indexing
    and cohort chunking."""

    n_clients: int = 0

    def client(self, ci: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def data_weights(self) -> List[int]:
        """Each client's sample count, no shard materialized: the round
        engine's FedAvg weights and the accountant's sampling rates."""
        raise NotImplementedError

    def __len__(self) -> int:
        return self.n_clients

    def __getitem__(self, ci: int) -> Dict[str, np.ndarray]:
        if not (0 <= int(ci) < self.n_clients):
            raise IndexError(ci)
        return self.client(int(ci))

    def n_cohorts(self, cohort_size: int) -> int:
        if cohort_size <= 0:
            return 1
        return -(-self.n_clients // cohort_size)

    def cohort(self, rnd: int, idx: int,
               cohort_size: Optional[int] = None) -> Cohort:
        """Cohort ``idx`` of the fleet: fixed-size chunks of the client id
        range, the last one possibly shorter; O(cohort) work and memory."""
        size = cohort_size if cohort_size and cohort_size > 0 \
            else self.n_clients
        lo = idx * size
        if not (0 <= lo < self.n_clients):
            raise IndexError(f"cohort {idx} of {self.n_cohorts(size)}")
        cis = list(range(lo, min(lo + size, self.n_clients)))
        return Cohort(rnd, idx, cis, [self.client(ci) for ci in cis])

    @staticmethod
    def from_clients_data(clients_data: Sequence[Dict]) -> "EagerPopulation":
        """A list of per-client shards behind the population interface,
        each shard returned by reference."""
        return EagerPopulation(list(clients_data))


class EagerPopulation(ClientPopulation):
    """A materialized shard list behind the population interface."""

    def __init__(self, clients_data: List[Dict[str, np.ndarray]]):
        self._data = clients_data
        self.n_clients = len(clients_data)

    def client(self, ci: int) -> Dict[str, np.ndarray]:
        return self._data[ci]

    def data_weights(self) -> List[int]:
        return [len(d["tokens"]) for d in self._data]


class DirichletPopulation(ClientPopulation):
    """Lazy label-skewed non-IID fleet over a small base dataset.  Client
    ``ci``'s shard is determined by ``(seed, ci)``:

    1. ``rng = host_fold_rng(seed, _POP_STREAM, ci)``;
    2. a Dirichlet(``alpha``) distribution over the label classes present
       in the base data;
    3. ``shard_size`` samples drawn class first (a multinomial over the
       classes, then draws with replacement from per-class index pools),
       then permuted by the same rng.

    The only precomputed state is the per-class index pools, O(base
    dataset), so a fleet of 10⁶ clients holds no more than the base data
    and materializing one cohort touches no other."""

    def __init__(self, base_data: Dict[str, np.ndarray], n_clients: int,
                 alpha: float = 0.5, seed: int = 0,
                 shard_size: Optional[int] = None,
                 n_classes: Optional[int] = None):
        if n_clients <= 0:
            raise ValueError("n_clients must be positive")
        self.base = base_data
        self.n_clients = int(n_clients)
        self.alpha = float(alpha)
        self.seed = int(seed)
        n = len(base_data["tokens"])
        self.shard_size = int(shard_size) if shard_size \
            else max(n // self.n_clients, 1)
        labels = base_data.get("labels")
        if labels is None:           # unlabeled data: one pseudo-class
            labels = np.zeros(n, np.int64)
        limit = int(n_classes) if n_classes else int(labels.max()) + 1
        pools = [np.where(labels == c)[0] for c in range(limit)]
        self._classes = [c for c, p in enumerate(pools) if len(p)]
        self._pools = [pools[c] for c in self._classes]

    def client(self, ci: int) -> Dict[str, np.ndarray]:
        rng = rng_mod.host_fold_rng(self.seed, _POP_STREAM, ci)
        props = rng.dirichlet(np.full(len(self._classes), self.alpha))
        counts = rng.multinomial(self.shard_size, props)
        sel = np.concatenate([
            rng.choice(pool, size=k, replace=True)
            for pool, k in zip(self._pools, counts) if k
        ])
        sel = sel[rng.permutation(len(sel))]
        return {k: v[sel] for k, v in self.base.items()}

    def data_weights(self) -> List[int]:
        return [self.shard_size] * self.n_clients


def as_population(clients) -> ClientPopulation:
    """A ``ClientPopulation`` as it is, a list of shards wrapped in an
    ``EagerPopulation``: the one conversion run_federated and
    run_program share."""
    if isinstance(clients, ClientPopulation):
        return clients
    return ClientPopulation.from_clients_data(clients)

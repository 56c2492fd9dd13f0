"""Asynchronous, staleness-aware aggregation (``FedConfig(aggregation=
"async")``): the participation and staleness model of the round
pipeline.  Counterpart of ``src/repro/core/async_agg.py``.

- ``ParticipationSchedule`` gives every client a seeded delay a job.  A
  free client starts a job each round: it pulls the current global state,
  trains now, and its update is in flight for ``delay`` rounds.
- Each round the server aggregates the updates that arrive, each weighted
  by its data weight times ``(1 + s)^-staleness_decay``, ``s`` being
  arrival minus start.  Updates staler than ``max_staleness`` are
  discarded.  The data weight of the clients that delivered nothing this
  round anchors the current global, so a lone stale update cannot yank
  the model.
- ``max_staleness == 0`` makes every delay 0, and the async run the sync
  run exactly.

The payload in flight is the framework's: LoRA params for FedLLM,
public-set logits for KD-FedLLM, the client half's adapters for
Split-FedLLM.  core/round_program.AsyncSchedule composes this model with
the programs and executors.  ``robust_agg`` other than "mean" is not
ported (core/rounds.run_federated refuses it), so the programs combine
their arrivals with ``stale_weighted_avg`` alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.fedavg import fedavg
from repro_torch.core.heterogeneous import aggregate_hetero


class ParticipationSchedule:
    """Deterministic per-client availability and delay.

    A client's speed is a trait: a slowness drawn once from the master
    seed gives each client a Binomial(max_staleness + 1, slowness) delay
    a job.  Each client's generator gives one draw a started job, so a
    seed replays the same schedule on any backend.  The draws are numpy's
    from the reference's seeds, so the schedule is the reference's."""

    def __init__(self, n_clients: int, seed: int = 0,
                 max_staleness: int = 4):
        master = np.random.default_rng(seed)
        self.slowness = master.uniform(0.15, 0.85, n_clients)
        self.max_staleness = int(max_staleness)
        self._rngs = [np.random.default_rng((seed, 7919, ci))
                      for ci in range(n_clients)]

    def next_delay(self, ci: int) -> int:
        """Rounds until client ``ci``'s freshly started job delivers (0:
        the round it trains)."""
        if self.max_staleness <= 0:
            return 0
        return int(self._rngs[ci].binomial(self.max_staleness + 1,
                                           self.slowness[ci]))


def staleness_weight(staleness: int, decay: float) -> float:
    """Polynomial staleness decay (FedAsync): ``(1 + s)^-decay``."""
    return float((1.0 + staleness) ** (-decay))


@dataclasses.dataclass
class _Job:
    """One in-flight client update."""
    client: int
    start: int          # round the client pulled the global and trained
    arrival: int        # round the update lands on the server
    payload: object     # params, logits or client-half adapters


def _pop_arrivals(in_flight: Dict[int, _Job], rnd: int) -> List[_Job]:
    """The jobs of ``in_flight`` delivering in ``rnd``, in client order,
    taken out of it."""
    arrived = sorted((j for j in in_flight.values() if j.arrival == rnd),
                     key=lambda j: j.client)
    for j in arrived:
        del in_flight[j.client]
    return arrived


def stale_weighted_avg(global_tree, arrivals, total_weight: float, fed,
                       ranks: List[int]):
    """Staleness-weighted FedAvg of arrived trees, ``arrivals`` being
    ``(client, tree, staleness, data_weight)`` with staleness within
    ``max_staleness``.  The data weight of every client that delivered
    nothing anchors the current global tree, so the update is a convex
    combination, plain data-weighted FedAvg when everyone arrives fresh.
    Trees below the global rank are harmonized by ``fed.hetero_agg``."""
    trees = [t for _, t, _, _ in arrivals]
    rks = [ranks[ci] for ci, _, _, _ in arrivals]
    ws = [w * staleness_weight(s, fed.staleness_decay)
          for _, _, s, w in arrivals]
    absent = total_weight - sum(w for _, _, _, w in arrivals)
    if absent > 0:
        trees = [global_tree] + trees
        rks = [fed.lora_rank] + rks
        ws = [absent] + ws
    if any(r != fed.lora_rank for r in rks):
        return aggregate_hetero(trees, rks, fed.lora_alpha, fed.lora_rank,
                                ws, fed.hetero_agg)
    return fedavg(trees, ws)


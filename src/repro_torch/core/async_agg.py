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
the programs and executors, which combine their arrivals through
``combine_arrivals``: ``stale_weighted_avg``, or under ``robust_agg``
other than "mean" ``robust_stale_combine``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import fed_spmd
from repro_torch.core.fedavg import fedavg
from repro_torch.core.heterogeneous import aggregate_hetero
from repro_torch.peft import lora as lora_lib
from repro_torch.runtime import compute_dtype


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

    def state(self) -> List[dict]:
        """Each client's generator state (``bit_generator.state``), the
        only mutable part: the slowness traits follow from the seed."""
        return [g.bit_generator.state for g in self._rngs]

    def load_state(self, states: List[dict]):
        for g, st in zip(self._rngs, states):
            g.bit_generator.state = st


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



def robust_stale_combine(global_tree, arrivals, total_weight: float, fed,
                         ranks: List[int]):
    """The Byzantine-robust counterpart of ``stale_weighted_avg``: the
    robust statistic (core/fed_spmd.robust_client_combine) runs over the
    arrived updates only (an anchor on the current global inside a
    median would act as one more client), then the result is blended
    with the current global by the arrived share ``rho`` of the
    staleness-weighted mass, so a thin round moves the model a little.
    When every client arrives fresh (no absent weight) it is the robust
    combine itself.  Trees below the global rank are zero-padded to it
    first (the statistic needs one client axis)."""
    trees = []
    for ci, t, _, _ in arrivals:
        if ranks[ci] != fed.lora_rank:
            t = lora_lib.pad_rank(t, fed.lora_rank)
        trees.append(t)
    ws = [w * staleness_weight(s, fed.staleness_decay)
          for _, _, s, w in arrivals]
    stacked = fed_spmd.stack_trees(trees)
    agg = fed_spmd.robust_client_combine(
        stacked, torch.tensor(ws, dtype=torch.float32,
                              device=tree_lib.leaves(stacked)[0].device),
        fed.robust_agg, fed.trim_frac, fed.clip_norm)
    absent = total_weight - sum(w for _, _, _, w in arrivals)
    if absent <= 0:
        return agg
    rho = sum(ws) / (absent + sum(ws))

    def blend(g, a):
        dt = compute_dtype(g.dtype)
        return ((1.0 - rho) * g.to(dt) + rho * a.to(dt)).to(g.dtype)

    return tree_lib.map_(blend, global_tree, agg)


def combine_arrivals(global_tree, arrivals, total_weight: float, fed,
                     ranks: List[int]):
    """The round's configured combine of arrived trees: the staleness-
    weighted, rank-aware FedAvg, or the robust combine when
    ``fed.robust_agg`` names one."""
    if fed.robust_agg != "mean" and arrivals:
        return robust_stale_combine(global_tree, arrivals, total_weight,
                                    fed, ranks)
    return stale_weighted_avg(global_tree, arrivals, total_weight, fed,
                              ranks)

"""Seeded fault-injection plan for the round engine.  Counterpart of
``src/repro/faults/plan.py``.

Every fault decision is a pure function of ``(FedConfig.seed,
FaultConfig.seed, round, client)`` through core/rng.host_fold_rng, the
reference's ``fold_in`` chain reproduced word for word, tagged with
``_FAULT_STREAM`` and drawn in the reference's order (dropout, then
straggler).  So the port drops, delays and corrupts the same clients in
the same rounds as the reference, on every framework, backend and
schedule, and across a checkpoint and resume, since the plan holds no
mutable state.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import rng as rng_mod

# the fault stream's tag: apart from the dropout, privacy and batching
# streams
_FAULT_STREAM = 0xFA17

BYZANTINE_MODES = ("nan", "inf", "sign_flip", "norm_inflation")


class FaultPlan:
    """Deterministic per-(round, client) fault decisions.

    * ``dropped(rnd, ci)``: the upload is lost in transit.
    * ``extra_delay(rnd, ci)``: extra rounds the upload takes to arrive
      (added to the schedule's arrival round).
    * ``corrupts(ci)``: ci is one of the ``byzantine`` clients, a seeded
      subset of the population chosen once a plan.
    * ``corrupt(payload, rnd, ci)``: the Byzantine mode applied to every
      floating-point tensor of a payload tree.
    """

    def __init__(self, fed, n_clients: int):
        fc = fed.faults
        if fc.byzantine_mode not in BYZANTINE_MODES:
            raise ValueError(
                f"unknown byzantine_mode {fc.byzantine_mode!r} "
                f"(expected one of {BYZANTINE_MODES})")
        if fc.byzantine > n_clients:
            raise ValueError(
                f"byzantine={fc.byzantine} exceeds n_clients={n_clients}")
        self.fed, self.fc, self.n_clients = fed, fc, n_clients
        if fc.byzantine > 0:
            perm = rng_mod.host_fold_rng(
                fed.seed, _FAULT_STREAM, fc.seed).permutation(n_clients)
            self.byzantine = frozenset(int(c) for c in perm[:fc.byzantine])
        else:
            self.byzantine = frozenset()

    def _draws(self, rnd: int, ci: int) -> Tuple[float, float]:
        """(dropout draw, straggler draw): one draw order a (round,
        client), so turning one kind of fault on never shifts the other's
        stream."""
        g = rng_mod.host_fold_rng(
            self.fed.seed, _FAULT_STREAM, self.fc.seed, rnd, ci)
        return float(g.uniform()), float(g.uniform())

    def dropped(self, rnd: int, ci: int) -> bool:
        if self.fc.dropout_rate <= 0.0:
            return False
        return self._draws(rnd, ci)[0] < self.fc.dropout_rate

    def extra_delay(self, rnd: int, ci: int) -> int:
        if self.fc.straggler_rate <= 0.0:
            return 0
        if self._draws(rnd, ci)[1] < self.fc.straggler_rate:
            return int(self.fc.straggler_delay)
        return 0

    def corrupts(self, ci: int) -> bool:
        return ci in self.byzantine

    def corrupt(self, payload, rnd: int, ci: int):
        """Every floating-point tensor of ``payload`` corrupted by the
        Byzantine mode, in its own dtype (other leaves pass through)."""
        if not self.corrupts(ci):
            return payload
        mode, scale = self.fc.byzantine_mode, self.fc.byzantine_scale

        def leaf(x):
            if not (torch.is_tensor(x) and x.is_floating_point()):
                return x
            if mode == "nan":
                return torch.full_like(x, float("nan"))
            if mode == "inf":
                return torch.full_like(x, float("inf"))
            if mode == "sign_flip":
                return -x
            return x * x.new_tensor(scale)            # norm_inflation

        return tree_lib.map_(leaf, payload)

"""Simulated secure aggregation (``PrivacyConfig.secure_agg``).

The port's own copy of ``src/repro/privacy/secure_agg.py``: the same
numpy uint64 masks from ``np.random.default_rng(seed + (start, lo, hi))``,
so the masks, sums and ledger bytes are the reference's by construction.
``state_dict``/``load_state_dict`` carry the session across a checkpoint
(checkpoint/federated.py), the fixed-point vectors as numpy uint64.

Bonawitz-style pairwise additive masking, simulated faithfully enough
to pin its two load-bearing properties in tests while staying
bit-transparent to the training math:

- **Exact mask cancellation.**  Each upload is encoded as a fixed-point
  uint64 vector; every unordered client pair (i, j) of a masking cohort
  shares a seeded mask vector m_ij, added by i and subtracted by j
  (mod 2^64).  At every aggregation event the session recomputes the
  masked sum of the delivered subset, removes the recovered masks of
  absent members, and asserts it equals the plain fixed-point sum
  *exactly* — uint64 wraparound arithmetic, no tolerance.

- **Wire accounting.**  Key exchange (cohort setup) and dropout
  recovery (mask reconstruction for members absent from an aggregation
  event) are charged to the CommLedger under ``secagg_keys`` /
  ``secagg_recovery``, so Fig. 4 reports the cost of privacy.  The
  byte model: every cohort member uploads one 32-byte public key plus
  an encrypted 32-byte seed share per peer, downloads the peers' keys
  and shares; each delivered client uploads one 32-byte share per
  member absent from that event.

The *model update* consumes the original float payloads: the simulation
treats the fixed-point encoding as lossless transport (a real
deployment would dequantize the masked sum and eat the rounding error),
which keeps ``secure_agg=True, noise=0`` bit-exact with the plain
engines.

Masking cohorts are *start* cohorts: the clients that pull the global
state in the same round mask against each other, because that is when
payloads are created.  Under async aggregation a cohort's members
deliver across different rounds, so every aggregation event recovers
the masks of the cohort members it is missing — the dropout/recovery
path exercised whenever ``ParticipationSchedule`` spreads deliveries.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import FedConfig
from repro_torch.core import metrics as M

KEY_BYTES = 32      # one DH public key
SHARE_BYTES = 32    # one encrypted Shamir share of a mask seed

_PAIR_STREAM = 0xA55A  # domain separator for pairwise mask seeds


def flat_fixed_point(payload, frac_bits: int) -> np.ndarray:
    """Flatten a payload (a port tree or one tensor) to a fixed-point
    uint64 vector: round(x * 2^frac_bits) in two's complement.  The
    leaves are copied to the host as float64, as the reference's
    ``np.asarray`` does."""
    leaves = [x.detach().to("cpu", torch.float64).numpy().ravel()
              for x in tree_lib.leaves(payload)]
    flat = np.concatenate(leaves) if leaves else np.zeros(0, np.float64)
    # a NaN/Inf payload would warn in the cast; its (garbage) encoding
    # is discarded with the payload
    with np.errstate(invalid="ignore"):
        return np.round(flat * float(1 << frac_bits)).astype(
            np.int64).astype(np.uint64)


class SecureAggSession:
    """One masking session per federated run.  Every method is a no-op
    when ``fed.privacy.secure_agg`` is False, so engines call it
    unconditionally."""

    def __init__(self, fed: FedConfig):
        self.priv = fed.privacy
        self.enabled = bool(self.priv.secure_agg)
        self._seed = (fed.seed, self.priv.seed, _PAIR_STREAM)
        self._cohorts: Dict[int, List[int]] = {}      # start round -> cis
        self._plain: Dict[Tuple[int, int], np.ndarray] = {}
        self._size: Dict[int, int] = {}               # cohort mask length

    # -- cohort setup ------------------------------------------------------ #
    def begin_cohort(self, ledger: M.CommLedger, rnd: int,
                     cohort: Iterable[int], cohort_id: int = None):
        """Key/share exchange for the clients starting a job this round
        (sync: everyone, every round).  Records the exchange bytes.

        ``cohort_id`` keys the masking cohort where it is not the round:
        the cohort-streaming executor masks each chunk of a round's
        starters against itself (several cohorts a round), so a chunk's
        masked sum cancels, and its payloads are freed, once the chunk
        has delivered.  ``collect``, ``deliver`` and ``discard`` key by
        the same id (their ``start_rnd``); the flat engines pass none."""
        if not self.enabled:
            return
        cis = list(cohort)
        if not cis:
            return
        self._cohorts[rnd if cohort_id is None else cohort_id] = cis
        n = len(cis)
        if n < 2:
            return                         # nothing to mask against
        up = KEY_BYTES + (n - 1) * SHARE_BYTES
        down = (n - 1) * (KEY_BYTES + SHARE_BYTES)
        for ci in cis:
            ledger.record(rnd, ci, "secagg_keys", M.UP, up)
            ledger.record(rnd, ci, "secagg_keys", M.DOWN, down)

    def collect(self, start_rnd: int, ci: int, payload):
        """Stash client ``ci``'s upload (created in ``start_rnd``) as a
        fixed-point vector; masking is applied lazily at delivery."""
        if not self.enabled or start_rnd not in self._cohorts:
            return
        q = flat_fixed_point(payload, self.priv.secure_agg_frac_bits)
        self._plain[(start_rnd, ci)] = q
        self._size[start_rnd] = max(self._size.get(start_rnd, 0), len(q))

    # -- masks ------------------------------------------------------------- #
    def _pair_mask(self, start_rnd: int, i: int, j: int,
                   size: int) -> np.ndarray:
        lo, hi = (i, j) if i < j else (j, i)
        rng = np.random.default_rng(self._seed + (start_rnd, lo, hi))
        return rng.integers(0, np.iinfo(np.uint64).max, size=size,
                            dtype=np.uint64, endpoint=True)

    def _padded(self, start_rnd: int, ci: int) -> np.ndarray:
        q = self._plain[(start_rnd, ci)]
        size = self._size[start_rnd]
        if len(q) < size:
            q = np.concatenate([q, np.zeros(size - len(q), np.uint64)])
        return q

    def masked(self, start_rnd: int, ci: int) -> np.ndarray:
        """What client ``ci`` actually sends: payload + signed pairwise
        masks over its start cohort (mod 2^64)."""
        cohort = self._cohorts[start_rnd]
        size = self._size[start_rnd]
        out = self._padded(start_rnd, ci).copy()
        for cj in cohort:
            if cj == ci:
                continue
            m = self._pair_mask(start_rnd, ci, cj, size)
            out = out + m if ci < cj else out - m
        return out

    # -- aggregation events ------------------------------------------------ #
    def deliver(self, ledger: M.CommLedger, rnd: int,
                delivered: Iterable[Tuple[int, int]]):
        """One server aggregation event: ``delivered`` is the set of
        (start_round, client) uploads summed this round.  Verifies exact
        mask cancellation per start cohort (recovering the masks of
        absent members, with their recovery bytes charged) and forgets
        the consumed payloads."""
        if not self.enabled:
            return
        by_start: Dict[int, List[int]] = {}
        for start, ci in delivered:
            by_start.setdefault(start, []).append(ci)
        for start, cis in by_start.items():
            cohort = self._cohorts[start]
            size = self._size[start]
            present = set(cis)
            absent = [cj for cj in cohort if cj not in present]
            masked_sum = np.zeros(size, np.uint64)
            plain_sum = np.zeros(size, np.uint64)
            for ci in cis:
                masked_sum = masked_sum + self.masked(start, ci)
                plain_sum = plain_sum + self._padded(start, ci)
            # dropout recovery: reconstruct every (present, absent) mask
            # from the absent member's recovered seed shares
            residual = np.zeros(size, np.uint64)
            for ci in cis:
                for cj in absent:
                    m = self._pair_mask(start, ci, cj, size)
                    residual = residual + m if ci < cj else residual - m
            if absent:
                for ci in cis:
                    ledger.record(rnd, ci, "secagg_recovery", M.UP,
                                  SHARE_BYTES * len(absent))
            unmasked = masked_sum - residual
            if not np.array_equal(unmasked, plain_sum):
                raise AssertionError(
                    "secure-agg masks failed to cancel exactly "
                    f"(start={start}, delivered={sorted(present)}, "
                    f"cohort={cohort})")
            for ci in cis:
                del self._plain[(start, ci)]

    def discard(self, start_rnd: int, ci: int):
        """Server drops a too-stale masked upload without summing it
        (its pairwise masks are recovered by later events as usual)."""
        if self.enabled:
            self._plain.pop((start_rnd, ci), None)

    # -- checkpoint/resume (checkpoint/federated.py) ----------------------- #
    def state_dict(self) -> dict:
        """The session's mutable state.  Keys are strings for the JSON
        manifest; the fixed-point vectors stay uint64 arrays (bit
        exact)."""
        return {
            "cohorts": {str(k): [int(x) for x in v]
                        for k, v in self._cohorts.items()},
            "size": {str(k): int(v) for k, v in self._size.items()},
            "plain": {f"{s}:{c}": q for (s, c), q in self._plain.items()},
        }

    def load_state_dict(self, st: dict):
        self._cohorts = {int(k): [int(x) for x in v]
                         for k, v in st["cohorts"].items()}
        self._size = {int(k): int(v) for k, v in st["size"].items()}
        self._plain = {}
        for key, q in st["plain"].items():
            s, c = key.split(":")
            self._plain[(int(s), int(c))] = np.asarray(q, np.uint64)


def key_exchange_bytes(cohort_size: int) -> Tuple[int, int]:
    """(up, down) setup bytes per cohort member — the arithmetic twin
    of ``begin_cohort`` for dry-run records and docs."""
    n = cohort_size
    if n < 2:
        return 0, 0
    return (KEY_BYTES + (n - 1) * SHARE_BYTES,
            (n - 1) * (KEY_BYTES + SHARE_BYTES))

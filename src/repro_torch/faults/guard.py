"""Upload-seam payload checks: the finite check and the norm screen.
Counterpart of ``src/repro/faults/guard.py``.

core/round_program.run_program runs them over every arrival before the
aggregate stage: a non-finite payload is always quarantined, and with
``FedConfig.screen_factor > 0`` so is an arrival whose L2 norm exceeds
``screen_factor`` times the round's median arrival norm.  Each leaf is
copied to the host and checked with numpy, as the reference checks it:
finiteness in fp32, the norm in fp64.  The checks never change a
payload, so a clean run's values and ledger bytes are untouched.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_lib


def float_leaves(payload) -> List:
    """The floating-point tensors of a payload tree (integer leaves, such
    as wire-byte counts, cannot be non-finite and are skipped)."""
    return [x for x in tree_lib.leaves(payload)
            if torch.is_tensor(x) and x.is_floating_point()]


def _host(x, dtype) -> np.ndarray:
    return x.detach().to("cpu", dtype).numpy()


def arrays_finite(arrays: Sequence) -> bool:
    return all(np.isfinite(_host(x, torch.float32)).all() for x in arrays)


def arrays_norm(arrays: Sequence) -> float:
    """The L2 norm over all leaves, summed in fp64 (the screen's limit is
    coarse)."""
    total = 0.0
    for x in arrays:
        total += float(np.square(_host(x, torch.float64)).sum())
    return math.sqrt(total)


def screen(payload_leaf_lists: Sequence[Sequence],
           screen_factor: float) -> List[bool]:
    """The verdicts (True: keep) on one round's arrivals, taken over the
    whole round at once, so the flat and the cohort-streaming rounds
    quarantine the same set.  The median is over the finite arrivals
    only, so a NaN payload cannot poison the screen itself."""
    ok = [arrays_finite(leaves) for leaves in payload_leaf_lists]
    if screen_factor > 0.0 and any(ok):
        norms = [arrays_norm(leaves) if good else 0.0
                 for leaves, good in zip(payload_leaf_lists, ok)]
        med = float(np.median([n for n, good in zip(norms, ok) if good]))
        if med > 0.0:
            limit = screen_factor * med
            ok = [good and n <= limit for good, n in zip(ok, norms)]
    return ok

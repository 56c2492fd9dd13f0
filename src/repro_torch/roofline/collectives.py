"""The collectives a traced step issues, read off the dispatched
functional collectives.

Counterpart of ``src/repro/roofline/collectives.py``, which parses them
out of XLA's post-SPMD HLO text.  Here DTensor's sharding propagation
issues ``_c10d_functional`` ops on each rank's local shards; the
``CollectiveTrace`` dispatch mode records each one's result buffer, one
device's view (the local shapes, as the reference's post-SPMD shapes
are), under the reference's kind names.  ``collective_bytes`` and
``total_collective_bytes`` keep their names and meanings and take the
recorded trace instead of HLO text.

DTensor on a CPU mesh (the dry run's fake process group) replaces an
all-to-all by an all-gather and a local chunk; ``CollectiveTrace``
counts the all-to-all that was asked for, its result buffer, and not
the all-gather it fell back to.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# _c10d_functional op name -> the reference's kind; XLA lowers a
# one-source transfer (a broadcast) as a collective-permute
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _nbytes(out) -> int:
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return out.numel() * out.element_size() if torch.is_tensor(out) else 0


def distributed_call(types) -> bool:
    """Whether a dispatched op's operands include a DTensor: a dispatch
    mode returns NotImplemented for it, so DTensor runs the op on its
    local shards, whose ops come back to the mode."""
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def kind_of(func):
    """The reference's kind of a functional collective op, or None."""
    if func.namespace != "_c10d_functional":
        return None
    return KINDS.get(func.__name__.split(".")[0])


class CollectiveTrace(TorchDispatchMode):
    """Records (kind, result bytes) of every functional collective
    dispatched on plain (local) tensors while active; ops on tensor
    subclasses (DTensor) pass through to the subclass, whose local ops
    come back here."""

    def __init__(self):
        super().__init__()
        self.records: List[Tuple[str, int]] = []
        self._asked = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if distributed_call(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.record(func, out)
        return out

    def record(self, func, out) -> None:
        kind = kind_of(func)
        if kind is not None and not self._asked:
            self.records.append((kind, _nbytes(out)))

    @contextlib.contextmanager
    def fallbacks(self):
        """Counts DTensor's CPU all-to-all (an all-gather and a chunk) as
        the all-to-all it stands for, while active."""
        from torch.distributed.tensor import _collective_utils, \
            placement_types

        orig = getattr(_collective_utils, "shard_dim_alltoall", None)
        if orig is None:                  # no fallback in this torch
            yield self
            return

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            self._asked += 1
            try:
                out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._asked -= 1
            if not self._asked:
                self.records.append(("all-to-all", _nbytes(out)))
            return out

        mods = [m for m in (_collective_utils, placement_types)
                if getattr(m, "shard_dim_alltoall", None) is orig]
        for m in mods:
            m.shard_dim_alltoall = alltoall
        try:
            yield self
        finally:
            for m in mods:
                m.shard_dim_alltoall = orig


def collective_bytes(trace) -> Dict[str, int]:
    """Sum of result-buffer bytes per collective kind (one device's view),
    from a CollectiveTrace or its records."""
    records = trace.records if isinstance(trace, CollectiveTrace) else trace
    out: Dict[str, int] = defaultdict(int)
    for kind, nbytes in records:
        out[kind] += nbytes
    return dict(out)


def total_collective_bytes(trace) -> int:
    return sum(collective_bytes(trace).values())

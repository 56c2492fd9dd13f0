"""Heterogeneous-rank LoRA aggregation (paper SSIV.A.2): clients fine-tune
with different ranks matched to their resources, and the server
harmonizes them before aggregation.  Counterpart of
``src/repro/core/heterogeneous.py``.

Two strategies:

- ``zeropad``: pad every client's A and B to the global rank (B rescaled
  so each delta is kept) and FedAvg in factor space (the HETLoRA
  baseline).
- ``svd``: form each client's delta alpha/r_c · A_c @ B_c, average the
  deltas (the quantity that edits the model), then factor the mean back
  to the global rank by SVD (peft/lora.svd_truncate): scale-exact, at
  the cost of one SVD a target matrix.  The factors' signs are the SVD
  library's, so two runs are compared through their deltas.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.fedavg import fedavg
from repro_torch.peft import lora as lora_lib
from repro_torch.runtime import compute_dtype


def normalize_ranks(client_ranks, n_clients: int,
                    lora_rank: int) -> List[int]:
    """Each client's LoRA rank: an empty or None ``client_ranks`` means
    every client trains at the global rank; otherwise the tuple must name
    every client once and stay within [1, lora_rank] (ValueError)."""
    if not client_ranks:
        return [lora_rank] * n_clients
    if len(client_ranks) != n_clients:
        raise ValueError(
            f"client_ranks has {len(client_ranks)} entries for "
            f"{n_clients} clients")
    if any(r < 1 or r > lora_rank for r in client_ranks):
        raise ValueError(
            f"client_ranks must lie in [1, lora_rank={lora_rank}] "
            f"(got {tuple(client_ranks)}); weak clients truncate the "
            "global rank, they never exceed it")
    return list(client_ranks)


def aggregate_hetero(trees: List, ranks: Sequence[int], alpha: float,
                     global_rank: int, weights=None, method: str = "zeropad"):
    """The weighted aggregate of LoRA trees of ``ranks``, at
    ``global_rank``."""
    if method == "zeropad":
        padded = [lora_lib.pad_rank(t, global_rank) for t in trees]
        return fedavg(padded, weights)
    if method == "svd":
        return _svd_aggregate(trees, ranks, alpha, global_rank, weights)
    raise ValueError(method)


def _svd_aggregate(trees, ranks, alpha, global_rank, weights):
    if weights is None:
        weights = [1.0] * len(trees)
    total = float(sum(weights))
    ws = [w / total for w in weights]
    scale_g = alpha / max(global_rank, 1)

    def combine(*leaves):
        # one {"a", "b"} dict a client
        delta = None
        for w, lf, r in zip(ws, leaves, ranks):
            dt = compute_dtype(lf["a"].dtype)
            d = (lf["a"].to(dt) @ lf["b"].to(dt)) * (alpha / max(r, 1) * w)
            delta = d if delta is None else delta + d
        u, vt = lora_lib.svd_truncate(delta / scale_g, global_rank)
        return {"a": u, "b": vt}

    return lora_lib.map_factors(combine, *trees)


"""Communication and computation accounting — the paper's evaluation axes
(SSIII, Figs. 3-4, Table I).

Counterpart of ``src/repro/core/metrics.py``: every server<->client
exchange goes through a ``CommLedger`` with shape-derived byte counts, and
client FLOPs come from the architecture config (6ND full fine-tuning,
4ND + 6·n_peft·D for PEFT), so both agree exactly with the reference.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig

UP = "up"          # client -> server
DOWN = "down"      # server -> client

# Hops of the aggregation topology.  The flat engines record everything
# on ``client_server``; the cohort-streaming executor under ``n_edges > 1``
# records each client's traffic on ``client_edge`` (the same names and
# shape-derived bytes) and each edge aggregator's fused payload on
# ``edge_server``, so the two-hop topology's wire cost is reported per
# hop.
CLIENT_SERVER = "client_server"
CLIENT_EDGE = "client_edge"
EDGE_SERVER = "edge_server"

# Privacy-machinery event names: overhead, not model payload
# (privacy/secure_agg.py, core/round_program's record_arrival)
PRIVACY_NAMES = ("secagg_keys", "secagg_recovery", "dp_meta")
# Edge-infrastructure event names (the two-hop topology): overhead, not
# client payload
EDGE_NAMES = ("edge_agg",)
# Fault-tolerance event names (faults/ and run_program's upload-seam
# middleware): ``quarantine``, an arrival the screen rejected (its bytes
# crossed the wire but never reached the aggregate), and ``retransmit``,
# an upload a FaultPlan dropout lost in transit.  Overhead, not model
# payload
FAULT_NAMES = ("quarantine", "retransmit")
DP_META_BYTES = 12   # fp32 clip + fp32 sigma + int32 stream id


@dataclasses.dataclass
class CommEvent:
    round: int
    client: int          # negative ids denote edge aggregators
    name: str            # e.g. "lora_params"
    direction: str
    bytes: int
    hop: str = CLIENT_SERVER


class CommLedger:
    def __init__(self):
        self.events: List[CommEvent] = []
        # the hop of records that name none: the streaming round sets it
        # to CLIENT_EDGE under a two-hop topology, so every stage reports
        # the right hop
        self.default_hop = CLIENT_SERVER

    def record(self, rnd: int, client: int, name: str, direction: str,
               nbytes: int, hop: Optional[str] = None):
        self.events.append(CommEvent(rnd, client, name, direction,
                                     int(nbytes), hop or self.default_hop))

    def total(self, direction: Optional[str] = None) -> int:
        return sum(e.bytes for e in self.events
                   if direction is None or e.direction == direction)

    def per_client_round(self) -> Dict[tuple, int]:
        out = collections.defaultdict(int)
        for e in self.events:
            out[(e.round, e.client)] += e.bytes
        return dict(out)

    def per_round(self) -> Dict[int, int]:
        out = collections.defaultdict(int)
        for e in self.events:
            out[e.round] += e.bytes
        return dict(out)

    def by_name(self) -> Dict[str, int]:
        out = collections.defaultdict(int)
        for e in self.events:
            out[e.name] += e.bytes
        return dict(out)

    def mean_client_bytes_per_round(self) -> float:
        pcr = {k: v for k, v in self.per_client_round().items() if k[1] >= 0}
        return sum(pcr.values()) / max(len(pcr), 1)

    def privacy_overhead_bytes(self) -> int:
        """Total wire bytes spent on the privacy machinery itself."""
        return sum(e.bytes for e in self.events if e.name in PRIVACY_NAMES)

    def payload_events(self) -> List[CommEvent]:
        """Events net of privacy overhead: what the non-private engines
        would have recorded."""
        return [e for e in self.events if e.name not in PRIVACY_NAMES]

    def fault_overhead_bytes(self) -> int:
        """Wire bytes wasted on faults: quarantined and lost uploads."""
        return sum(e.bytes for e in self.events if e.name in FAULT_NAMES)

    def by_hop(self, direction: Optional[str] = None) -> Dict[str, int]:
        out = collections.defaultdict(int)
        for e in self.events:
            if direction is None or e.direction == direction:
                out[e.hop] += e.bytes
        return dict(out)

    def hop_total(self, hop: str, direction: Optional[str] = None) -> int:
        return sum(e.bytes for e in self.events if e.hop == hop
                   and (direction is None or e.direction == direction))

    def payload_view(self) -> "CommLedger":
        """A ledger of the model-payload events alone (privacy, edge and
        fault overhead filtered out): what the cohort-streaming and two-hop
        paths must report as the flat engines do."""
        view = CommLedger()
        view.events = [e for e in self.events
                       if e.name not in PRIVACY_NAMES + EDGE_NAMES
                       + FAULT_NAMES]
        return view


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_lib.leaves(tree))


# --------------------------------------------------------------------------- #
# Analytic FLOPs (client-side computation, Fig. 4 right axis)
# --------------------------------------------------------------------------- #
def fwd_flops(cfg: ModelConfig, n_tokens: int,
              frac_layers: float = 1.0) -> float:
    """2 * N_active * D; ``frac_layers`` scales for split sub-models."""
    return 2.0 * cfg.active_param_count() * frac_layers * n_tokens


def train_flops(cfg: ModelConfig, n_tokens: int, peft: bool = True,
                n_peft_params: int = 0, frac_layers: float = 1.0) -> float:
    """Full FT: 6ND.  PEFT: fwd 2ND + activation-grad chain 2ND + PEFT
    weight grads (6 * n_peft * D) — frozen base weight-grads skipped."""
    base = cfg.active_param_count() * frac_layers
    if not peft:
        return 6.0 * base * n_tokens
    return (4.0 * base + 6.0 * n_peft_params) * n_tokens


@dataclasses.dataclass
class ClientCost:
    """Accumulated per-client computation."""
    flops: float = 0.0

    def add_train(self, cfg, n_tokens, n_peft, frac_layers=1.0):
        self.flops += train_flops(cfg, n_tokens, True, n_peft, frac_layers)

    def add_fwd(self, cfg, n_tokens, frac_layers=1.0):
        self.flops += fwd_flops(cfg, n_tokens, frac_layers)


@dataclasses.dataclass
class RoundMetrics:
    round: int
    accuracy: float
    loss: float
    comm_bytes_per_client: float
    client_flops: float
    epsilon: float = 0.0     # DP epsilon spent (0.0: DP not enabled)
    # wall time of the round on the host clock; the evaluation's float()
    # reads wait for the device, so the round's device work is inside it
    seconds: float = 0.0


def logit_bytes(n_samples: int, logit_dim: int, topk: int = 0,
                quant_bits: int = 0) -> int:
    """Communication size of a logit set (paper SSIII.B; SSIV.B.2
    compression options).  Sub-byte payloads are nibble-packed per row
    (ceil), matching core/compression's actual wire payloads."""
    if topk and quant_bits:
        # fused top-k + int quantization: packed values + indices + scale
        per = (topk * quant_bits + 7) // 8 + topk * 4 + 4
    elif topk:
        per = topk * (4 + 4)                       # value + index
    elif quant_bits:
        per = (logit_dim * quant_bits + 7) // 8 + 4    # + per-row scale
    else:
        per = logit_dim * 4
    return n_samples * per

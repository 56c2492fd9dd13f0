"""Federated round engine entry point.  Counterpart of
``src/repro/core/rounds.py``:

    result = run_federated(cfg, fed, public, clients, test, device="cuda")

``result.history`` is a list of RoundMetrics; ``result.ledger`` holds
every wire transfer.  The port runs FedLLM (the paper's SSV case study),
KD-FedLLM and Split-FedLLM on the dense family (GPT-2), and FedLLM on the
Griffin hybrid (RecurrentGemma; Split refuses it), each with sequential
clients and sync rounds, with or without the privacy knobs
(``FedConfig.privacy``: DP-SGD clipping, upload noise, secure
aggregation; on Split the c2 boundary clip and noise).  Every ``FedConfig`` setting outside them raises
NotImplementedError rather than being ignored.  The run holds
``cfg.kernel_policy`` as the ambient kernel policy from start to end, so
kernels called outside the model's forward (the KD loss, the b3 top-k
quantize, the DP clip, the Split boundary quantizer) follow it too.

``device=None`` means ``"cuda"``, and a run that asks for CUDA where there
is none raises: it does not carry on on the CPU.  ``base=`` and ``lora=``
take port parameter trees (for example bridged from the reference with
repro_torch/bridge.py).  For FedLLM ``lora=`` is the initial global
tree; for KD it is ``{"server": tree, "clients": [tree, ...]}``, one tree
per client; for Split it is the full-model tree, which the run splits at
the client/server boundary.  Without them the port initialises its own
with ``torch.Generator``s: the base from ``fed.seed``, the LoRA from
``fed.seed + 1`` (FedLLM), ``fed.seed + 2`` (KD) or ``fed.seed + 3``
(Split).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import FedConfig, ModelConfig
from repro_torch.core.round_program import FedResult, run_program
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.factory import build_model
from repro_torch.peft import lora as lora_lib
from repro_torch.runtime import resolve_device


def _unported(fed: FedConfig, task: str) -> List[str]:
    """The settings of ``fed`` the port does not run yet."""
    checks = [
        (fed.backend != "sequential", f"backend={fed.backend!r}"),
        (fed.aggregation != "sync", f"aggregation={fed.aggregation!r}"),
        (fed.peft != "lora", f"peft={fed.peft!r}"),
        (fed.optimizer != "adam", f"optimizer={fed.optimizer!r}"),
        (fed.client_ranks is not None, "client_ranks"),
        (fed.faults.enabled, "fault injection"),
        (fed.robust_agg != "mean", f"robust_agg={fed.robust_agg!r}"),
        (fed.quorum > 0.0, "quorum"),
        (fed.screen_factor > 0.0, "screen_factor"),
        (task != "classification", f"task={task!r}"),
    ]
    return [what for bad, what in checks if bad]


def run_federated(cfg: ModelConfig, fed: FedConfig, public: Dict,
                  clients: List[Dict], test: Dict,
                  task: str = "classification", batch_size: int = 16,
                  eval_batch: int = 64, verbose: bool = False,
                  device=None, base=None, lora=None,
                  checkpoint_every: int = 0, checkpoint_dir: str = None,
                  resume_from: str = None) -> FedResult:
    if fed.framework not in ("fedllm", "kd", "split"):
        raise ValueError(f"unknown framework {fed.framework!r}")
    if fed.privacy.dp_noise_multiplier > 0.0 and fed.privacy.dp_clip <= 0.0:
        raise ValueError(
            "privacy.dp_noise_multiplier > 0 requires privacy.dp_clip > 0 "
            "(the noise stddev is sigma * clip; an unclipped release has "
            "unbounded sensitivity and no (eps, delta) guarantee)")
    if fed.n_virtual_clients and fed.n_virtual_clients != len(clients):
        raise ValueError(
            f"FedConfig.n_virtual_clients={fed.n_virtual_clients} does "
            f"not match the supplied population ({len(clients)} clients)")
    unported = _unported(fed, task)
    if checkpoint_every or checkpoint_dir or resume_from:
        unported.append("checkpointing")
    if unported:
        raise NotImplementedError("not ported yet: " + ", ".join(unported))
    device = resolve_device(device)
    model = build_model(cfg)
    if base is None:
        base = model.init(torch.Generator().manual_seed(fed.seed), device)
    base = tree_lib.map_(lambda t: t.detach().to(device), base)
    if lora is not None:
        lora = tree_lib.map_(lambda t: t.detach().to(device), lora)
    targets = fed.lora_targets or lora_lib.DEFAULT_TARGETS
    with kernel_ops.policy_scope(cfg.kernel_policy):
        return run_program(model, base, cfg, fed, targets, public, clients,
                           test, task, batch_size, eval_batch, verbose,
                           device, lora=lora)

"""Federated round engine entry point.  Counterpart of
``src/repro/core/rounds.py``:

    result = run_federated(cfg, fed, public, clients, test, device="cuda")

``result.history`` is a list of RoundMetrics; ``result.ledger`` holds
every wire transfer.  ``clients`` is a data/population.ClientPopulation
(for example the lazy ``DirichletPopulation``) or a list of per-client
shards, which is wrapped in an ``EagerPopulation``; the port does not
warn on a list (the reference's DeprecationWarning retires an older API
of its own that the port never had).  The port runs FedLLM (the paper's
SSV case study), KD-FedLLM and Split-FedLLM on all three families it
builds: the dense family (GPT-2), the Griffin hybrid (RecurrentGemma;
Split at a pattern group boundary, the tail on the server) and RWKV-6
(Finch).  Each runs under every execution backend: ``sequential`` (a
loop over clients), ``spmd`` (the round's ready set stacked on a leading
axis, core/fed_spmd.py) and ``cohort`` (the ready set streamed through
the spmd executor ``cohort_size`` clients at a time, the aggregate
folded between chunks, each chunk its own secure-aggregation cohort;
``n_edges > 1`` splits the ledger into a client->edge and an
edge->server hop), with sync or async aggregation (``aggregation=
"async"``: core/async_agg.py), heterogeneous client ranks
(``client_ranks``, harmonized by ``hetero_agg``: core/heterogeneous.py),
the privacy knobs (``FedConfig.privacy``: DP-SGD clipping, upload
noise, secure aggregation; on Split the c2 boundary clip and noise) and
fault tolerance: seeded fault injection (``FedConfig.faults``: dropout,
stragglers, the four Byzantine modes; faults/), the finite check and the
norm screen (``screen_factor``) that quarantine offenders, the quorum
rollover (``quorum``), the robust combines (``robust_agg`` median,
trimmed_mean or norm_clip) and checkpoint and resume
(``checkpoint_every``, ``checkpoint_dir``, ``resume_from``:
checkpoint/).  Every task runs: ``"classification"`` (the case
study's intent head) and, as in the reference, any other task as the
generative next-token loss (core/tasks.py; its ``final_accuracy`` is
minus the eval loss); and both optimizers, Adam and SGD (optim/).  A
``mesh`` is not ported.  An invalid setting raises ValueError, as in the
reference; a valid ``FedConfig`` setting outside the ported slices (a
``peft`` other than LoRA) raises NotImplementedError rather than being
ignored.  KD over a generative task's logits raises ValueError at b4
(core/kd.aggregate_knowledge), as the reference's does.

LoRA targets are ``fed.lora_targets``, or ``peft/lora.default_targets``
when that is empty, as in the reference.  ``FedConfig``'s default targets
are ("wq", "wk", "wv"), which an RWKV-6 model does not have: with them
the reference, and so the port, trains no LoRA weight (a ledger of
``{"lora_params": 0}`` and a constant loss).  RWKV-6 needs
``lora_targets=lora.RWKV_TARGETS`` (or ``()``), as the reference's own
launcher passes them.

The run holds ``cfg.kernel_policy`` as the ambient kernel policy from
start to end, so kernels called outside the model's forward (the KD loss, the b3 top-k
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
from repro_torch.core.heterogeneous import normalize_ranks
from repro_torch.core.round_program import FedResult, run_program
from repro_torch.data.population import as_population
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.factory import build_model
from repro_torch.peft import lora as lora_lib
from repro_torch.runtime import resolve_device


def _unported(fed: FedConfig, task: str) -> List[str]:
    """The settings of ``fed`` the port does not run yet."""
    checks = [
        (fed.peft != "lora", f"peft={fed.peft!r}"),
    ]
    return [what for bad, what in checks if bad]


def _check_values(fed: FedConfig, n_clients: int,
                  checkpoint_every: int, checkpoint_dir) -> None:
    """The reference's value checks (``src/repro/core/rounds.py``), in its
    order: each invalid setting raises ValueError, ported or not."""
    if fed.framework not in ("fedllm", "kd", "split"):
        raise ValueError(f"unknown framework {fed.framework!r}")
    if fed.backend not in ("sequential", "spmd", "cohort"):
        raise ValueError(f"unknown backend {fed.backend!r} "
                         "(expected 'sequential', 'spmd' or 'cohort')")
    if fed.aggregation not in ("sync", "async"):
        raise ValueError(f"unknown aggregation {fed.aggregation!r} "
                         "(expected 'sync' or 'async')")
    if fed.n_virtual_clients and fed.n_virtual_clients != n_clients:
        raise ValueError(
            f"FedConfig.n_virtual_clients={fed.n_virtual_clients} does "
            f"not match the supplied population ({n_clients} clients)")
    if fed.privacy.dp_noise_multiplier > 0.0 and fed.privacy.dp_clip <= 0.0:
        raise ValueError(
            "privacy.dp_noise_multiplier > 0 requires privacy.dp_clip > 0 "
            "(the noise stddev is sigma * clip; an unclipped release has "
            "unbounded sensitivity and no (eps, delta) guarantee)")
    if fed.robust_agg not in ("mean", "median", "trimmed_mean",
                              "norm_clip"):
        raise ValueError(f"unknown robust_agg {fed.robust_agg!r}")
    if not 0.0 <= fed.trim_frac < 0.5:
        raise ValueError("trim_frac must be in [0, 0.5): trimming half "
                         "the cohort from each side leaves nothing")
    if not 0.0 <= fed.quorum <= 1.0:
        raise ValueError("quorum is a fraction of the round's starters "
                         "and must be in [0, 1]")
    for rate in (fed.faults.dropout_rate, fed.faults.straggler_rate):
        if not 0.0 <= rate <= 1.0:
            raise ValueError("fault rates are probabilities in [0, 1]")
    if checkpoint_every > 0 and not checkpoint_dir:
        raise ValueError("checkpoint_every > 0 requires checkpoint_dir")
    normalize_ranks(fed.client_ranks, n_clients, fed.lora_rank)


def run_federated(cfg: ModelConfig, fed: FedConfig, public: Dict,
                  clients, test: Dict,
                  task: str = "classification", batch_size: int = 16,
                  eval_batch: int = 64, verbose: bool = False,
                  device=None, base=None, lora=None,
                  checkpoint_every: int = 0, checkpoint_dir: str = None,
                  resume_from: str = None) -> FedResult:
    clients = as_population(clients)
    _check_values(fed, len(clients), checkpoint_every, checkpoint_dir)
    unported = _unported(fed, task)
    if unported:
        raise NotImplementedError("not ported yet: " + ", ".join(unported))
    device = resolve_device(device)
    model = build_model(cfg)
    if base is None:
        base = model.init(torch.Generator().manual_seed(fed.seed), device)
    base = tree_lib.map_(lambda t: t.detach().to(device), base)
    if lora is not None:
        lora = tree_lib.map_(lambda t: t.detach().to(device), lora)
    targets = fed.lora_targets or lora_lib.default_targets(cfg)
    with kernel_ops.policy_scope(cfg.kernel_policy):
        return run_program(model, base, cfg, fed, targets, public, clients,
                           test, task, batch_size, eval_batch, verbose,
                           device, lora=lora,
                           checkpoint_every=checkpoint_every,
                           checkpoint_dir=checkpoint_dir,
                           resume_from=resume_from)

"""Model facade.  Counterpart of ``src/repro/models/factory.py``:

    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed))  # on CUDA
    logits, aux = model.forward(params, batch)

``init``'s ``device=None`` means ``"cuda"`` and raises without it (pass
``device="cpu"`` for the CPU); the weights are drawn on the CPU from the
generator, so a seed gives the same weights on every device.  Ported
(models/transformer.check_supported), by ``configs/registry`` name:
``gpt2``, ``gpt2-tiny``, ``qwen2-1.5b``, ``qwen3-1.7b``,
``mistral-large-123b``, ``nemotron-4-340b`` (dense), ``mixtral-8x7b``,
``qwen3-moe-235b-a22b`` (MoE, models/moe.py), ``recurrentgemma-2b`` (the
Griffin hybrid) and ``rwkv6-1.6b``; ``llava-next-34b`` (the VLM
image-embedding prefix) and ``whisper-base`` (the encoder-decoder) raise
NotImplementedError.  ``batch`` is a dict with ``"tokens"`` (B, S) on
the parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, gen: torch.Generator, device=None):
        return transformer.init_params(gen, self.cfg, device)

    def forward(self, params, batch: Dict[str, Any]):
        """(logits (B, S, V), aux) under the config's kernel policy.
        The backward of a training step runs the autograd Functions the
        forward chose.  core/rounds.run_federated holds the same policy
        for a whole run (the KD loss and the top-k quantize run outside
        the forward); this scope serves callers that drive the model
        directly."""
        with kernel_ops.policy_scope(self.cfg.kernel_policy):
            return transformer.forward(params, self.cfg, batch["tokens"])


def build_model(cfg: ModelConfig) -> Model:
    transformer.check_supported(cfg)
    return Model(cfg)

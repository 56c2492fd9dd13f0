"""Model facade.  Counterpart of ``src/repro/models/factory.py``:

    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed))  # on CUDA
    shapes = model.init_abstract(torch.bfloat16)   # on "meta": no memory
    logits, aux = model.forward(params, batch[, remat="full"])
    cache = model.init_cache(params, batch_size, max_len, batch)
    logits, cache = model.decode_step(params, cache, token, pos)

``init``'s ``device=None`` means ``"cuda"`` and raises without it (pass
``device="cpu"`` for the CPU); the weights are drawn on the CPU from the
generator, so a seed gives the same weights on every device.  Every
``configs/registry`` name builds (models/transformer.check_supported):
``gpt2``, ``gpt2-tiny``, ``qwen2-1.5b``, ``qwen3-1.7b``,
``mistral-large-123b``, ``nemotron-4-340b`` (dense), ``mixtral-8x7b``,
``qwen3-moe-235b-a22b`` (MoE, models/moe.py), ``recurrentgemma-2b`` (the
Griffin hybrid), ``rwkv6-1.6b``, ``llava-next-34b`` (the VLM image
prefix) and ``whisper-base`` (the encoder-decoder, models/encdec.py).

``init_abstract`` builds the same tree on the ``meta`` device: shapes
and dtypes, nothing allocated and nothing drawn (the dry run's and the
launch layer's parameters; the reference's ``jax.eval_shape`` of
``init``).  ``forward``'s ``remat`` (``"none"``, ``"full"`` or
``"selective"``) recomputes each layer-pattern group in the backward
(models/transformer.forward); an encoder-decoder ignores it, as the
reference's does.

``batch`` is a dict with ``"tokens"`` (B, S) on the parameters' device,
plus the family's extras, as the reference reads them: an
encoder-decoder needs ``"enc_embeds"`` (B, S_enc, d) (a KeyError without
them, as in the reference); a decoder-only model takes the optional
``"img_embeds"`` (B, n_img, d_img) and ``"prefix_embeds"`` (B,
n_virtual, d), prepended to the text (models/transformer.embed_tokens).

``init_cache`` makes the decode cache on the parameters' device (the
K/V slots in bf16 by default, as the reference's; the recurrent states
fp32); an encoder-decoder needs ``batch["enc_embeds"]`` there and runs
its encoder once.  ``decode_step`` takes ``token`` (B,) and ``pos``, the
absolute position as a Python int, updates the cache in place and
returns (logits (B, V), cache); a VLM decodes text alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, gen: torch.Generator, device=None):
        if self.cfg.is_encoder_decoder:
            return encdec.init_encdec_params(gen, self.cfg, device)
        return transformer.init_params(gen, self.cfg, device)

    def init_abstract(self, dtype=torch.float32):
        """The parameter tree on the ``meta`` device, floating leaves in
        ``dtype``: no memory is allocated and the generator is never
        drawn (the initializers' draws land on ``meta``)."""
        with torch.device("meta"):
            params = self.init(torch.Generator(), device="meta")
        return tree_lib.map_(
            lambda t: t.to(dtype) if t.is_floating_point() else t, params)

    def forward(self, params, batch: Dict[str, Any], remat: str = "none"):
        """(logits (B, S', V), aux) under the config's kernel policy.
        The backward of a training step runs the autograd Functions the
        forward chose.  core/rounds.run_federated holds the same policy
        for a whole run (the KD loss and the top-k quantize run outside
        the forward); this scope serves callers that drive the model
        directly."""
        with kernel_ops.policy_scope(self.cfg.kernel_policy):
            if self.cfg.is_encoder_decoder:
                return encdec.encdec_forward(params, self.cfg,
                                             batch["tokens"],
                                             batch["enc_embeds"])
            return transformer.forward(
                params, self.cfg, batch["tokens"],
                img_embeds=batch.get("img_embeds"),
                prefix_embeds=batch.get("prefix_embeds"), remat=remat)

    def init_cache(self, params, batch_size: int, max_len: int,
                   batch: Optional[Dict[str, Any]] = None,
                   dtype=torch.bfloat16):
        """The decode cache for ``batch_size`` rows of up to ``max_len``
        positions (``init_cache`` of the reference's Model)."""
        if self.cfg.is_encoder_decoder:
            if batch is None or "enc_embeds" not in batch:
                raise ValueError("an encoder-decoder's cache needs "
                                 "batch['enc_embeds']")
            with kernel_ops.policy_scope(self.cfg.kernel_policy):
                return encdec.init_encdec_cache(params, self.cfg, batch_size,
                                                max_len, batch["enc_embeds"],
                                                dtype)
        return transformer.init_cache(self.cfg, batch_size, max_len, dtype,
                                      params["embed"].device)

    def decode_step(self, params, cache, token, pos: int):
        """(logits (B, V), cache) under the config's kernel policy: bound
        LoRA projections through the fused kernel and cross-attention
        through flash on the card, as in ``forward``."""
        with kernel_ops.policy_scope(self.cfg.kernel_policy):
            if self.cfg.is_encoder_decoder:
                return encdec.encdec_decode_step(params, self.cfg, cache,
                                                 token, pos)
            return transformer.decode_step(params, self.cfg, cache, token,
                                           pos)


def build_model(cfg: ModelConfig) -> Model:
    transformer.check_supported(cfg)
    return Model(cfg)

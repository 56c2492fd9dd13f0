"""RecurrentGemma-2B: the Griffin hybrid (RG-LRU recurrent blocks and
local attention, one attention layer in every three) [arXiv:2402.19427].

Reproduces ``src/repro/configs/recurrentgemma_2b.py`` (``config()``
there): 26 layers in the pattern (rglru, rglru, local_attn), d 2560, 10
query heads of 256 over one KV head, SwiGLU d_ff 7680, RMSNorm, RoPE,
tied embeddings scaled by sqrt(d), V 256000, RG-LRU width 2560, a
temporal conv of width 4 and a local window of 2048."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def recurrentgemma_2b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", n_layers=26,
        d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256, d_ff=7680,
        vocab_size=256_000, activation="swiglu", norm="rmsnorm",
        layer_pattern=("rglru", "rglru", "local_attn"), local_window=2048,
        lru_width=2560, conv1d_width=4, tie_embeddings=True,
        embed_scale=True, citation="arXiv:2402.19427 (Griffin/RecurrentGemma)")

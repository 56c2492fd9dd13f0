"""Mixtral-8x7B: 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

Reproduces ``src/repro/configs/mixtral_8x7b.py`` field for field."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=32_000, activation="swiglu", norm="rmsnorm",
        n_experts=8, top_k=2, sliding_window=4096,
        moe_dispatch="shard_map",  # runs as "batched": the port has no mesh
        citation="arXiv:2401.04088 (Mixtral of Experts)")

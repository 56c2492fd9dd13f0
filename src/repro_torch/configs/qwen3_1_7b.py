"""Qwen3-1.7B: qk-norm, GQA [hf:Qwen/Qwen3-8B family].

Reproduces ``src/repro/configs/qwen3_1_7b.py`` field for field."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=8, head_dim=128, d_ff=6144,
        vocab_size=151_936, activation="swiglu", norm="rmsnorm",
        qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
        citation="hf:Qwen/Qwen3-8B")

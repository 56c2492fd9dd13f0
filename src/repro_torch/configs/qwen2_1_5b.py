"""Qwen2-1.5B: GQA with QKV bias [arXiv:2407.10671].

Reproduces ``src/repro/configs/qwen2_1_5b.py`` field for field."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, head_dim=128, d_ff=8960,
        vocab_size=151_936, activation="swiglu", norm="rmsnorm",
        qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
        citation="arXiv:2407.10671 (Qwen2)")

"""Mistral-Large-Instruct-2407 (123B dense) [hf:mistralai/Mistral-Large-Instruct-2407].

Reproduces ``src/repro/configs/mistral_large_123b.py`` field for field."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense", n_layers=88,
        d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128, d_ff=28672,
        vocab_size=32768, activation="swiglu", norm="rmsnorm",
        rope_theta=1_000_000.0,
        citation="hf:mistralai/Mistral-Large-Instruct-2407")

"""Nemotron-4-340B: dense GQA with squared-ReLU MLP [arXiv:2402.16819].

Reproduces ``src/repro/configs/nemotron_4_340b.py`` field for field."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense", n_layers=96,
        d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192, d_ff=73728,
        vocab_size=256_000, activation="relu2", norm="layernorm",
        citation="arXiv:2402.16819 (Nemotron-4)")

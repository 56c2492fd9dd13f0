"""Qwen3-MoE 235B-A22B: 128 experts, top-8, per-expert d_ff=1536, qk-norm
GQA [hf:Qwen/Qwen3-30B-A3B family scaled per assignment].

Reproduces ``src/repro/configs/qwen3_moe_235b_a22b.py`` field for field."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", n_layers=94,
        d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128, d_ff=1536,
        vocab_size=151_936, activation="swiglu", norm="rmsnorm",
        n_experts=128, top_k=8, qk_norm=True, rope_theta=1_000_000.0,
        moe_dispatch="shard_map",  # runs as "batched": the port has no mesh
        citation="hf:Qwen/Qwen3-30B-A3B")

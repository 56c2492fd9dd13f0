"""GPT-2 — the paper's case-study model (SSV) [Radford et al. 2019].

Reproduces ``src/repro/configs/gpt2_small.py``: ``gpt2()`` is the real
124M config; ``gpt2_tiny()`` the reduced variant the CI-speed case study
runs (learned positions, LayerNorm, GELU, MHA with QKV bias; LoRA targets
("wq", "wk", "wv") stand for GPT-2's fused ``attn.c_attn``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def gpt2() -> ModelConfig:
    return ModelConfig(
        name="gpt2", family="dense", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab_size=50257, qkv_bias=True,
        activation="gelu", norm="layernorm", use_rope=False,
        max_position_embeddings=1024, tie_embeddings=True,
        citation="Radford et al., 2019 (OpenAI blog)")


def gpt2_tiny(vocab_size: int = 512) -> ModelConfig:
    return ModelConfig(
        name="gpt2-tiny", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=vocab_size,
        qkv_bias=True, activation="gelu", norm="layernorm", use_rope=False,
        max_position_embeddings=256, tie_embeddings=True,
        citation="reduced GPT-2 family for case-study benchmarks")

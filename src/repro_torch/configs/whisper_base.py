"""Whisper-base transformer backbone: 6L encoder + 6L decoder, GELU,
LayerNorm, learned positions.  Mel+conv frontend STUBBED: input_specs
delivers 1500 frame embeddings [arXiv:2212.04356].

Reproduces ``src/repro/configs/whisper_base.py`` field for field."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048,
        vocab_size=51_865, activation="gelu", norm="layernorm",
        use_rope=False, max_position_embeddings=32_768,
        n_encoder_layers=6, encoder_seq_len=1500,
        citation="arXiv:2212.04356 (Whisper)")

"""LLaVA-NeXT-34B language backbone + anyres vision-token prefix (vision
tower + projector STUBBED: input_specs delivers patch embeddings)
[hf:llava-hf/llava-v1.6-mistral-7b-hf family, 34B scale per assignment].

Reproduces ``src/repro/configs/llava_next_34b.py`` field for field."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480,
        vocab_size=64_000, activation="swiglu", norm="rmsnorm",
        n_image_tokens=576, image_embed_dim=1024,
        citation="hf:llava-hf/llava-v1.6-mistral-7b-hf (anyres tiling)")

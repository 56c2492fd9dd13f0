"""RWKV-6 "Finch" 1.6B: attention-free, with a data-dependent decay
[arXiv:2404.05892].

Reproduces ``src/repro/configs/rwkv6_1_6b.py`` (``config()`` there): 24
layers of the ``rwkv6`` block (time-mix with the WKV recurrence, then
channel-mix with squared ReLU), d 2048, heads of 64 (32 of them), d_ff
7168, LayerNorm, an untied head, V 65536.  ``use_rope`` is True as in the
reference, so the model has no learned positions; no attention runs, so
RoPE is never applied."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def rwkv6_1_6b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
        n_heads=0, n_kv_heads=0, head_dim=64, d_ff=7168,
        vocab_size=65_536, activation="relu2", norm="layernorm",
        layer_pattern=("rwkv6",), use_rope=True,
        citation="arXiv:2404.05892 (RWKV-6 Finch)")

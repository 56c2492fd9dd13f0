"""Architecture registry: ``--arch <id>`` resolution.

Reproduces ``src/repro/configs/registry.py``: the same 12 names, each
giving the reference's config field for field.  Every name resolves;
``models/factory.build_model`` refuses the two the port does not run
yet (``llava-next-34b``'s image-embedding prefix and ``whisper-base``'s
encoder-decoder) through ``models/transformer.check_supported``."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import (gpt2_small, llava_next_34b,
                                 mistral_large_123b, mixtral_8x7b,
                                 nemotron_4_340b, qwen2_1_5b, qwen3_1_7b,
                                 qwen3_moe_235b_a22b, recurrentgemma_2b,
                                 rwkv6_1_6b, whisper_base)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, Callable[[], ModelConfig]] = {
    "mistral-large-123b": mistral_large_123b.config,
    "recurrentgemma-2b": recurrentgemma_2b.recurrentgemma_2b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.config,
    "mixtral-8x7b": mixtral_8x7b.config,
    "llava-next-34b": llava_next_34b.config,
    "qwen2-1.5b": qwen2_1_5b.config,
    "qwen3-1.7b": qwen3_1_7b.config,
    "rwkv6-1.6b": rwkv6_1_6b.rwkv6_1_6b,
    "whisper-base": whisper_base.config,
    "nemotron-4-340b": nemotron_4_340b.config,
    # the paper's own case-study model
    "gpt2": gpt2_small.gpt2,
    "gpt2-tiny": gpt2_small.gpt2_tiny,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]()
